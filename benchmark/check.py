"""Whether a run served the right tokens: the plain reference
(benchmark/reference/rnnt.py) over a sample of the answers the timed window
produced, and the number compared, the mean logit gap.

For each sampled utterance the reference computes its joint's logits at
every node of the alignment lattice (frame, tokens consumed) of the served
tokens, and ``widest_gap`` finds how far below the reference's best logit a
greedy decode had to choose to serve them.  A sound run differs from the
reference only by rounding, so its gaps are those of near ties, on a few
answers; a wrong token, a lost state or a dropped utterance needs a wide gap
somewhere.  The number compared is the mean over the answers of each one's
widest gap: on the random-weight models the widest gap alone does not part
a sound run from the control (its logits lie within a few hundredths of
each other, and one bf16 rounding of the joint's hidden layer moves them as
far as int4 does at a near tie), while the control parts from the reference
on nearly every answer (PERF.md, PR 16).

The control is the reference one precision step down (``RNNT(lower=True)``)
put in the program's place: it decodes the same utterances greedily, and its
tokens are judged the same way.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark import traffic
from benchmark.reference.rnnt import RNNT, widest_gap

BLOCK = 16  # utterances the reference encodes at once


def mean_gap(gaps: Sequence[float]) -> float:
    """The number compared: the mean over the sampled answers of each one's
    widest gap."""
    return float(np.mean(gaps))


def _reference(config: dict, weights: dict, device, lower: bool = False) -> RNNT:
    calib = []
    if "calibration_audio" in config:
        pcm, lens = traffic.calibration_audio(config, device)
        calib = [torch.from_numpy(w) for w in traffic.host_waveforms(pcm, lens)]
    return RNNT(weights, config, calib, device, lower=lower)


def _encode(ref: RNNT, wavs: Sequence[np.ndarray]) -> List[torch.Tensor]:
    out = []
    for i in range(0, len(wavs), BLOCK):
        out += ref.encode([torch.from_numpy(np.asarray(w)) for w in wavs[i : i + BLOCK]])
    return out


def gaps(config: dict, weights: dict, cap: int, wavs: Sequence[np.ndarray],
         tokens: Sequence[np.ndarray], device) -> List[float]:
    """The widest gap of each served token sequence against the reference."""
    with torch.no_grad():
        ref = _reference(config, weights, device)
        fs = _encode(ref, wavs)
        out = []
        for f, tok in zip(fs, tokens):
            lat = ref.lattice(f, tok).cpu().numpy()
            out.append(widest_gap(lat, tok, cap, ref.blank,
                                  truncated=len(tok) >= config["max_res_len"]))
        return out


def control_tokens(config: dict, weights: dict, cap: int, wavs: Sequence[np.ndarray],
                   device) -> List[np.ndarray]:
    """The tokens the reference one precision step down serves."""
    with torch.no_grad():
        low = _reference(config, weights, device, lower=True)
        return [low.greedy(f, cap, config["max_res_len"]) for f in _encode(low, wavs)]
