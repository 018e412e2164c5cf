"""Emission models: make random weights emit about as many symbols per
frame as a trained RNN-T does on speech (copied from the program's
bench.py, ``bias_joint_toward_blank`` and ``bias_joint_burst``, onto the
benchmark's plain float32 weights).

Random weights emit at nearly every decode step up to the symbol cap, which
overweights the decode against real speech (about 0.8 symbols per
post-stack frame).
  blank  w1_pred scaled by 0.05 (whether a frame emits is decided by the
         frame, not by the prediction state), w1_trans by ``amp``, and the
         blank logit's bias raised by ``delta``;
  burst  for the product's cap of 30 symbols a frame: the prediction net a
         pass-through (w_hh = 0, input and output gates open, layer 0's
         forget gate half open, layer 1's shut), so its output g is a fixed
         map of the recent symbols, and w1_pred = 2 kappa pinv(G) T pinv(w2)
         with G the single-symbol map and T = -[I | 0]: consuming symbol k
         lowers logit k by about kappa, as agreement does in a trained model;
         w1_trans scaled by amp and the blank bias raised by delta.
The values (amp, delta, kappa) are found once per cell by
``benchmark/calibrate_emission.py`` (``bisect``) and replayed from the
cell's file.
"""

from __future__ import annotations

import copy
from typing import Callable, Tuple

import numpy as np
import torch


def bisect(rate: Callable[[float], float], target: float, iters: int) -> Tuple[float, float]:
    """Bracket, then bisect, the blank delta for a measured emission rate
    (falling in delta; both ends grow geometrically first).  The curve can
    have cliffs, so the best point evaluated is returned (delta, rate)."""
    evals = []

    def probe(delta):
        r = rate(delta)
        evals.append((delta, r))
        return r

    lo, hi = -1.0, 1.0
    while probe(lo) <= target and lo > -4096:
        lo *= 4
    while probe(hi) > target and hi < 4096:
        hi *= 4
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if probe(mid) > target:
            lo = mid
        else:
            hi = mid
    return min(evals, key=lambda dr: abs(dr[1] - target))


def _joint(w: dict, amp: float, delta: float, blank: int, w1_pred: torch.Tensor) -> dict:
    j = dict(w["joint"])
    b2 = j["b2"].clone()
    b2[blank] += delta
    j.update(w1_trans=j["w1_trans"] * amp, w1_pred=w1_pred.to(b2), b2=b2)
    return j


def blank(w: dict, amp: float, delta: float, blank_id: int) -> dict:
    out = copy.copy(w)
    out["joint"] = _joint(w, amp, delta, blank_id, w["joint"]["w1_pred"] * 0.05)
    return out


def _passthrough(layer, forget_bias: float):
    w_ih, w_hh, _ = layer
    H = w_hh.shape[0]
    b = torch.zeros((4 * H,), dtype=w_ih.dtype, device=w_ih.device)
    b[:H] = 6.0
    b[H : 2 * H] = forget_bias
    b[3 * H :] = 6.0
    return (w_ih, torch.zeros_like(w_hh), b)


def burst(w: dict, amp: float, delta: float, kappa: float, blank_id: int) -> dict:
    pred = [_passthrough(l, 0.0 if i == 0 else -6.0) for i, l in enumerate(w["pred"])]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    x = w["embed"].double().cpu().numpy()  # the V - 1 emittable symbols
    for w_ih, _, b in pred:
        w_ih, b = w_ih.double().cpu().numpy(), b.double().cpu().numpy()
        H = w_ih.shape[1] // 4
        gates = x @ w_ih + b
        i, g, o = gates[:, :H], gates[:, 2 * H : 3 * H], gates[:, 3 * H :]
        x = sig(o) * np.tanh(sig(i) * np.tanh(g))
    w2 = w["joint"]["w2"].double().cpu().numpy()
    T = np.zeros((x.shape[0], w2.shape[1]))
    T[:, : x.shape[0]] = -np.eye(x.shape[0])
    w1p = 2.0 * kappa * (np.linalg.pinv(x) @ T @ np.linalg.pinv(w2))
    out = copy.copy(w)
    out["pred"] = pred
    out["joint"] = _joint(w, amp, delta, blank_id, torch.from_numpy(w1p).float())
    return out


def apply(w: dict, model: dict, blank_id: int) -> dict:
    """The cell's emission model ({"model": "blank" | "burst", "amp",
    "delta"[, "kappa"]}) applied to float32 weights."""
    kind = model["model"]
    if kind == "blank":
        return blank(w, model["amp"], model["delta"], blank_id)
    if kind == "burst":
        return burst(w, model["amp"], model["delta"], model["kappa"], blank_id)
    raise ValueError(f"unknown emission model {kind!r}")
