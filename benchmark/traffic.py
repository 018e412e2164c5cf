"""The traffic generator: one general reader of the mix files in
benchmark/traffic/.  Everything a run sends is drawn here from the run's
seed, so the same seed gives the same inputs.

  store        the utterances: lengths from the mix's "duration" law (gamma
               of a shape and a mean, clipped) and speech-like noise made on
               the device (Gaussian noise under a log-normal envelope, linear
               over 100 ms segments, scaled to an RMS of 0.1, rounded to
               16-bit PCM), both drawn from the mix's own fixed "sizes_seed"
  arrivals     Poisson arrival times at a rate over the window, and the
               store utterance each query carries (uniform draws), drawn
               from the mix's fixed "arrivals_seed"
Every run serves the same utterances and the same gaps between arrivals,
in an order drawn from its seed: the seed changes which answers the check
samples and where work falls, not how much work there is (with emissions
that burst, a store drawn anew for each seed moved a cell's rate by 20%).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000


def substreams(seed: int, n: int) -> List[int]:
    """n independent 32-bit seeds derived from any whole number."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def durations(law: dict, n: int, seed: int) -> np.ndarray:
    """Samples per utterance of ``n`` drawn from the law with ``seed``."""
    rng = np.random.RandomState(seed)
    secs = np.clip(rng.gamma(law["shape"], law["mean_s"] / law["shape"], size=n),
                   law["min_s"], law["max_s"])
    return (secs * SAMPLE_RATE).astype(np.int64)


def store(law: dict, n: int, order_seed: int, device) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(lengths, float32 waveforms on the host) of the mix's ``n``
    utterances, made from the law's sizes_seed, in an order drawn from
    ``order_seed``."""
    lens = durations(law, n, law["sizes_seed"])
    wavs = host_waveforms(speechlike(lens, law["sizes_seed"], device), lens)
    perm = np.random.RandomState(order_seed).permutation(n)
    return lens[perm], [wavs[i] for i in perm]


def speechlike(lengths: np.ndarray, seed: int, device, rms: float = 0.1,
               segment_ms: float = 100.0, group: int = 256) -> torch.Tensor:
    """16-bit PCM of every utterance, end to end in one int16 tensor on
    ``device`` (utterance i at sum(lengths[:i])), drawn from ``seed`` in
    groups of ``group`` utterances."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    seg = int(segment_ms * SAMPLE_RATE / 1000)
    out = []
    for g0 in range(0, len(lengths), group):
        lens = torch.as_tensor(lengths[g0 : g0 + group], device=device)
        S = int(lens.max())
        noise = torch.randn((len(lens), S), generator=gen, device=device)
        knots = torch.exp(torch.randn((len(lens), S // seg + 2), generator=gen, device=device))
        pos = torch.arange(S, device=device, dtype=torch.float32) / seg
        k0 = pos.long()
        frac = pos - k0
        x = noise * (knots[:, k0] * (1 - frac) + knots[:, k0 + 1] * frac)
        valid = torch.arange(S, device=device)[None, :] < lens[:, None]
        x = x * valid
        x = x * (rms / torch.sqrt((x * x).sum(1, keepdim=True) / lens[:, None]).clamp(min=1e-12))
        pcm = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
        out.append(pcm[valid])
    return torch.cat(out)


def host_waveforms(pcm: torch.Tensor, lengths: np.ndarray) -> List[np.ndarray]:
    """The utterances as float32 arrays in [-1, 1) on the host (PCM / 32768,
    exactly), views of one buffer."""
    flat = pcm.cpu().numpy().astype(np.float32) * np.float32(1.0 / 32768.0)
    return np.split(flat, np.cumsum(lengths)[:-1])


def arrivals(rate: float, seconds: float, n_store: int, fixed_seed: int,
             order_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(arrival times (s) over [0, seconds), the store utterance of each
    query): exponential gaps at ``rate`` and uniform utterance draws from
    ``fixed_seed``, in an order drawn from ``order_seed``.  The gaps are
    half as many again as the window needs, so every order fills it."""
    rng = np.random.RandomState(fixed_seed)
    n = int(rate * seconds * 1.5) + 64
    gaps, utts = rng.exponential(1.0 / rate, size=n), rng.randint(n_store, size=n)
    perm = np.random.RandomState(order_seed).permutation(n)
    t = np.cumsum(gaps[perm])
    keep = t < seconds
    return t[keep], utts[perm][keep]


def check_sample(n_answers: int, k: int, seed: int, must: List[int]) -> List[int]:
    """``k`` answers drawn from ``seed`` out of ``n_answers``, with ``must``
    (the longest) among them; sorted."""
    rng = np.random.RandomState(seed)
    pick = set(int(i) for i in must)
    rest = [i for i in rng.permutation(n_answers) if int(i) not in pick]
    pick.update(int(i) for i in rest[: max(k - len(pick), 0)])
    return sorted(pick)


def calibration_audio(config: dict, device) -> Tuple[torch.Tensor, np.ndarray]:
    """The configuration's calibration utterances (its weight seed), as PCM
    on ``device`` and their lengths."""
    cal = config["calibration_audio"]
    lens = np.full(cal["utterances"], int(cal["seconds"] * SAMPLE_RATE), np.int64)
    return speechlike(lens, int(config["weight_seed"]) + 1, device), lens
