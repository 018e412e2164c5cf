"""Whether a run served the right tokens: the plain reference (the one the
configuration's model builds, ``cell.model.reference``) over a sample of the
answers the timed window produced, and the number compared, the mean logit
gap.

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

The control is the reference one precision step down (``lower=True``) put
in the program's place: it decodes the same utterances greedily, and its
tokens are judged the same way.

Each function takes the model module as ``model``; without it, the one the
configuration names is loaded from this harness's own checkout.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark import models
from benchmark.common import REPO

BLOCK = 16  # utterances the reference encodes at once


def mean_gap(gaps: Sequence[float]) -> float:
    """The number compared: the mean over the sampled answers of each one's
    widest gap."""
    return float(np.mean(gaps))


def _reference(config: dict, weights: dict, device, lower: bool = False, model=None):
    model = model if model is not None else models.load(config["model"], REPO)
    return model.reference(config, weights, device, lower=lower)


def _encode(ref, wavs: Sequence[np.ndarray]) -> List[torch.Tensor]:
    out = []
    for i in range(0, len(wavs), BLOCK):
        out += ref.encode([torch.from_numpy(np.asarray(w)) for w in wavs[i : i + BLOCK]])
    return out


def gaps(config: dict, weights: dict, cap: int, wavs: Sequence[np.ndarray],
         tokens: Sequence[np.ndarray], device, model=None) -> List[float]:
    """The widest gap of each served token sequence against the reference."""
    with torch.no_grad():
        ref = _reference(config, weights, device, model=model)
        fs = _encode(ref, wavs)
        out = []
        for f, tok in zip(fs, tokens):
            lat = ref.lattice(f, tok).cpu().numpy()
            out.append(widest_gap(lat, tok, cap, ref.blank, truncated=len(tok) >= ref.max_len))
        return out


def control_tokens(config: dict, weights: dict, cap: int, wavs: Sequence[np.ndarray],
                   device, model=None) -> List[np.ndarray]:
    """The tokens the reference one precision step down serves."""
    with torch.no_grad():
        low = _reference(config, weights, device, lower=True, model=model)
        return [low.greedy(f, cap, low.max_len) for f in _encode(low, wavs)]


def widest_gap(logits: np.ndarray, tokens: Sequence[int], cap: int, blank: int,
               truncated: bool = False) -> float:
    """How far below the reference's best logit a greedy decode had to choose
    to serve ``tokens``, on the alignment that keeps that distance least.

    logits (T2, K + 1, V): the reference at frame t after k tokens.  At each
    node the decode either emits token k (gap best - logit[k]) or, with
    fewer than ``cap`` symbols on the frame, takes blank and advances (gap
    best - logit[blank]); with ``cap`` symbols on the frame it advances
    whatever the logits say.  The served decode ends past the last frame
    with every token emitted; a ``truncated`` one (its tokens cut at the
    buffer's length) ends once the last token is emitted.  Returns the
    least, over alignments, of the widest gap on the alignment (inf when
    no alignment serves the tokens)."""
    T2, K1, _ = logits.shape
    K = K1 - 1
    best = logits.max(axis=2)
    emit = best[:, :K] - logits[:, np.arange(K), np.asarray(tokens, np.int64)] if K else \
        np.zeros((T2, 0))
    adv = best - logits[:, :, blank]
    inf = np.inf
    enter = np.full(K1, inf)
    enter[0] = 0.0
    reached = inf
    for t in range(T2):
        states = [enter]
        for _ in range(cap):
            prev = states[-1]
            nxt = np.full(K1, inf)
            nxt[1:] = np.maximum(prev[:-1], emit[t])
            states.append(nxt)
        if truncated:
            reached = min(reached, min(s[K] for s in states))
        leave = np.minimum.reduce([np.maximum(s, adv[t]) for s in states[:-1]] + [states[-1]])
        enter = leave
    return float(min(enter[K], reached))
