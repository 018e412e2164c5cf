"""Sample store: the RAM-resident utterance set the QSL serves, and the
LibriSpeech conversion chain (counterpart of
rnnt_inference_tpu/data/dataset.py).  ``save``/``load`` use the JAX
package's npz container, so a store written by either package loads in the
other."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from rnnt_inference_tpu_torch.config import FeaturizerConfig


@dataclass
class SampleStore:
    """In-memory utterance set.

    kind == "waveform": samples[i] is float32 (S_i,) audio at 16 kHz.
    kind == "features": samples[i] is float32 (T_i, 240) log-mel features.
    """

    kind: str
    samples: List[np.ndarray]
    transcripts: List[str] = field(default_factory=list)
    names: List[str] = field(default_factory=list)

    def __len__(self):
        return len(self.samples)

    @property
    def lengths(self) -> np.ndarray:
        return np.array([s.shape[0] for s in self.samples], dtype=np.int32)

    def feature_lengths(self, cfg: FeaturizerConfig = FeaturizerConfig()) -> np.ndarray:
        """Post-frontend frame count per sample (used for length sorting)."""
        if self.kind == "features":
            return self.lengths
        return np.array([cfg.out_frames(int(s.shape[0])) for s in self.samples], np.int32)

    @property
    def audio_seconds(self) -> float:
        if self.kind == "waveform":
            return float(sum(s.shape[0] for s in self.samples)) / 16000.0
        # features: frames * splicing * hop / sr = frames * 0.03 s
        return float(sum(s.shape[0] for s in self.samples)) * 0.03

    def save(self, path: str) -> None:
        """npz: s0..s{n-1} and __meta__ (json: kind, n, transcripts, names)."""
        meta = {"kind": self.kind, "n": len(self.samples),
                "transcripts": self.transcripts, "names": self.names}
        np.savez_compressed(
            path,
            __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **{f"s{i}": s for i, s in enumerate(self.samples)},
        )

    @classmethod
    def load(cls, path: str) -> "SampleStore":
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            samples = [z[f"s{i}"] for i in range(meta["n"])]
        return cls(kind=meta["kind"], samples=samples, transcripts=meta["transcripts"],
                   names=meta.get("names", []))

    def select(self, indices) -> "SampleStore":
        """Subset view (copying lists, sharing arrays)."""
        return SampleStore(
            kind=self.kind,
            samples=[self.samples[i] for i in indices],
            transcripts=[self.transcripts[i] for i in indices] if self.transcripts else [],
            names=[self.names[i] for i in indices] if self.names else [],
        )

    def filter_by_list(self, list_path: str) -> "SampleStore":
        """Keep the utterances whose file name appears in a calibration file
        list (one relative wav path per line; matched by basename)."""
        with open(list_path) as f:
            wanted = {os.path.basename(line.strip()) for line in f if line.strip()}
        if not self.names:
            raise ValueError("store has no utterance names to match a file list against")
        return self.select(
            [i for i, n in enumerate(self.names) if os.path.basename(n) in wanted]
        )

    @classmethod
    def from_manifest(cls, manifest, target_sr: int = 16000) -> "SampleStore":
        """Load the waveform of every manifest entry (wav or FLAC)."""
        from rnnt_inference_tpu_torch.data.audio import load_audio

        return cls(
            kind="waveform",
            samples=[load_audio(e["audio_filepath"], target_sr) for e in manifest],
            transcripts=[e["transcript"] for e in manifest],
            names=[os.path.basename(e["audio_filepath"]) for e in manifest],
        )

    @classmethod
    def synthetic(
        cls,
        n: int = 256,
        seed: int = 0,
        min_seconds: float = 1.0,
        max_seconds: float = 15.0,
        mean_seconds: float = 7.8,
        sample_rate: int = 16000,
    ) -> "SampleStore":
        """Random utterances with a dev-clean-like duration distribution
        (gamma-shaped, clipped to [min, max]).  The same seed gives the same
        samples as the JAX package's SampleStore.synthetic."""
        rng = np.random.RandomState(seed)
        durs = np.clip(rng.gamma(4.0, mean_seconds / 4.0, size=n), min_seconds, max_seconds)
        samples = [speechlike_noise(rng, int(d * sample_rate)) for d in durs]
        return cls(
            kind="waveform", samples=samples, transcripts=[""] * n,
            names=[f"synthetic-{i:05d}.wav" for i in range(n)],
        )


def speechlike_noise(
    rng: np.random.RandomState, n_samples: int, rms: float = 0.1,
    segment_ms: float = 100.0, sample_rate: int = 16000,
) -> np.ndarray:
    """Gaussian noise under a log-normal envelope that is piece-wise linear
    over ~100 ms segments, so frames vary as speech frames do; RMS is
    normalized to ``rms``."""
    x = rng.randn(n_samples)
    span = max(int(segment_ms * sample_rate / 1000.0), 1)
    n_seg = n_samples // span + 2
    knots = np.exp(rng.randn(n_seg))
    env = np.interp(np.arange(n_samples) / span, np.arange(n_seg), knots)
    x = x * env
    x *= rms / max(float(np.sqrt(np.mean(x**2))), 1e-12)
    return x.astype(np.float32)


def _load_and_perturb(job):
    """(path, [factors]) -> [waveforms]: one decode feeds every speed factor
    (the decode is the expensive part).  Module-level for Pool pickling."""
    from rnnt_inference_tpu_torch.data.audio import load_audio, speed_perturb

    path, factors = job
    wav = load_audio(path)
    return [speed_perturb(wav, s) for s in factors]


def convert_librispeech(
    data_dir: str,
    manifest_path: str,
    output_path: str,
    max_duration: float = 15.0,
    file_list: str = None,
    speeds=None,
    workers: int = 0,
) -> SampleStore:
    """One-shot conversion: manifest + wav or FLAC files -> a waveform
    SampleStore (saved to ``output_path`` when given).

    file_list keeps only the listed utterances (one path per line, matched
    by basename).  speeds adds speed-perturbed copies (factor s: a copy
    named ``{stem}-{s}{ext}`` with ~1/s the duration; 1.0, the original, is
    always included); with both, the list is matched against the perturbed
    names.  workers > 1 decodes the files in that many processes."""
    from rnnt_inference_tpu_torch.data.manifest import Manifest

    entries = list(Manifest([manifest_path], data_dir=data_dir, max_duration=max_duration))
    factors = sorted({float(s) for s in (speeds or [])} | {1.0})
    wanted = None
    if file_list:
        with open(file_list) as f:
            wanted = {os.path.basename(line.strip()) for line in f if line.strip()}

    jobs = []  # (path, [factors], [transcripts], [out names]): one decode per file
    for e in entries:
        base = os.path.basename(e["audio_filepath"])
        stem, ext = os.path.splitext(base)
        fs, ts, ns = [], [], []
        for s in factors:
            out_name = base if s == 1.0 else f"{stem}-{s}{ext}"
            if wanted is not None and out_name not in wanted:
                continue
            fs.append(s)
            ts.append(e["transcript"])
            ns.append(out_name)
        if fs:
            jobs.append((e["audio_filepath"], fs, ts, ns))

    if workers and workers > 1 and len(jobs) > 1:
        from multiprocessing import get_context

        with get_context("spawn").Pool(workers) as pool:
            decoded = pool.map(_load_and_perturb, [(j[0], j[1]) for j in jobs])
    else:
        decoded = [_load_and_perturb((j[0], j[1])) for j in jobs]
    store = SampleStore(
        kind="waveform",
        samples=[w for ws in decoded for w in ws],
        transcripts=[t for j in jobs for t in j[2]],
        names=[n for j in jobs for n in j[3]],
    )
    if output_path:
        store.save(output_path)
    return store


def compute_features_store(
    store: SampleStore,
    cfg: FeaturizerConfig = FeaturizerConfig(),
    batch_size: int = 32,
    device="cuda",
) -> SampleStore:
    """Log-mel features of a waveform store -> a features store (the
    reference's ``{name}-input.pt``, per-utterance {T, 240}).  Featurized
    on ``device`` with ops/features.py log_mel_features, in batches over
    the QSL's wav buckets (longest first), each utterance trimmed to its
    own frame count."""
    import torch

    from rnnt_inference_tpu_torch.ops.features import log_mel_features
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    if store.kind != "waveform":
        raise ValueError("compute_features_store takes a waveform store")
    dev = torch.device(device)
    qsl = QuerySampleLibrary(store, cfg)
    order = qsl.sort_desc(np.arange(len(store)))
    feats_by_idx: dict = {}
    with torch.inference_mode():
        for s in range(0, len(order), batch_size):
            batch_idx = order[s : s + batch_size]
            wav, lens, _ = qsl.assemble_waveforms(batch_idx, pad_n=batch_size)
            feats, out_lens = log_mel_features(torch.from_numpy(wav).to(dev),
                                               torch.from_numpy(lens).to(dev), cfg)
            feats, out_lens = feats.cpu().numpy(), out_lens.cpu().numpy()  # {T, N, C}
            for r, i in enumerate(batch_idx):
                feats_by_idx[int(i)] = feats[: out_lens[r], r, :].copy()
    return SampleStore(
        kind="features",
        samples=[feats_by_idx[i] for i in range(len(store))],
        transcripts=list(store.transcripts),
        names=list(store.names),
    )
