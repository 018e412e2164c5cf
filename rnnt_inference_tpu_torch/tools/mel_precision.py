"""How near kernel D's tf32 products come to f32: a numpy emulation of
csrc/mel.cu's arithmetic, on the CPU.

    python -m rnnt_inference_tpu_torch.tools.mel_precision

``emulate_fused_mel`` repeats the kernel's products on the same tf32
pieces of cos, sin and fbT (ops/features.py ``tf32_split``, zero-padded
as ``mel_operands`` pads them): the frames split into tf32 pieces; per
k-step of 8 inputs the products a0 b0 + a0 b1 + a1 b0 (and a0 b2 + a1 b1
+ a2 b0 on the bin tiles with three pieces) summed, rounded once to f32 and added to an f32 running sum; the
power in f32, the mel product in 3xTF32 and the log in f32.  Products of
tf32 pieces are exact in f64, so f64 sums rounded to f32 stand in for the
tensor cores' sums (which truncate where this rounds).  ``pieces`` picks
the split: "kernel" (csrc/mel.cu), "3x" (two pieces everywhere) or "1x"
(the leading piece alone, plain tf32).

The command holds each split against the f32 twin (ops/features.py
fused_mel_reference) and an f64 evaluation, on the waveforms of
chip_smoke.py's kernel_d phase (16 synthetic utterances of 14-15 s,
seed 11), and prints one JSON line per split: the max, p99 and p50 of
|log-mel difference| and the mel band and frame of the max.  Nothing of
this module runs at import.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.ops import features as tf


def _pieces(a, n: int):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return [p.numpy() for p in tf.tf32_split(t, n)]


def emulate_fused_mel(x: np.ndarray, n_frames: int, cfg: FeaturizerConfig,
                      pieces: str = "kernel") -> np.ndarray:
    """x {N, S'} f32 (as fused_mel takes it) -> {N, n_frames, n_mels} f32."""
    cos_m, sin_m, fbt, ops = tf.device_constants(cfg, "cpu")
    hop, (K, M) = cfg.hop_length, fbt.shape
    kp, mp = -(-K // 8) * 8, -(-M // 8) * 8
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)
    frames = tf.frames_at(torch.tensor(x), n_frames, hop, 2 * hop).reshape(-1, 2 * hop)
    frames = frames.contiguous().numpy()
    # the kernel's bin tiles with three pieces: as many as its dft3 operand holds
    n3 = 8 * ops.dft3.shape[0] if pieces == "kernel" else 0
    # B pieces [cos, sin][piece] (flen, kp), the third piece only on the first n3 bins
    B = [[p.astype(np.float64) for p in _pieces(F.pad(c, (0, kp - K)), 3)] for c in (cos_m, sin_m)]
    for b in B:
        b[2][:, n3:] = 0.0
    a = [p.astype(np.float64) for p in _pieces(frames, 3)]
    terms = {"1x": [(0, 0)], "3x": [(0, 0), (0, 1), (1, 0)], "kernel": [(0, 0), (0, 1), (1, 0)]}
    parts = []
    for c in range(2):
        b = B[c]
        run = np.zeros((frames.shape[0], b[0].shape[1]), np.float32)
        for s in range(0, 2 * hop, 8):
            ks = slice(s, s + 8)
            step = sum(a[i][:, ks] @ b[j][ks] for i, j in terms[pieces])
            if n3:
                step[:, :n3] += (a[2][:, ks] @ b[0][ks] + a[1][:, ks] @ b[1][ks]
                                 + a[0][:, ks] @ b[2][ks])[:, :n3]
            run = f32(run + f32(step))
        parts.append(run)
    re, im = parts
    spec = (re * re + im * im) + np.float32(cfg.dither) ** 2  # padded bins: dither^2
    fb = [p.astype(np.float64) for p in _pieces(F.pad(fbt, (0, mp - M, 0, kp - K)), 2)]
    sp = [p.astype(np.float64) for p in _pieces(spec, 2)]
    if pieces == "1x":
        mel = f32(sp[0] @ fb[0])
    else:
        mel = f32(sp[1] @ fb[0] + sp[0] @ fb[1] + sp[0] @ fb[0])
    out = np.log(mel[:, :M] + np.float32(1e-20))
    return out.reshape(x.shape[0], n_frames, M)


def f64_fused_mel(x: np.ndarray, n_frames: int, cfg: FeaturizerConfig) -> np.ndarray:
    """The same function in f64 on the f32 constants."""
    cos_m, sin_m, fbt = (m.numpy().astype(np.float64) for m in tf.device_constants(cfg, "cpu")[:3])
    hop = cfg.hop_length
    frames = tf.frames_at(torch.from_numpy(x).double(), n_frames, hop, 2 * hop).numpy()
    re, im = frames @ cos_m, frames @ sin_m
    return np.log((re * re + im * im + cfg.dither ** 2) @ fbt + 1e-20)


def kernel_d_input(cfg: FeaturizerConfig):
    """(x {16, S'}, T): chip_smoke.py kernel_d's waveforms as fused_mel takes them."""
    from rnnt_inference_tpu_torch.data.dataset import SampleStore

    store = SampleStore.synthetic(n=16, seed=11, min_seconds=14.0, max_seconds=15.0)
    S = 15 * cfg.sample_rate
    wav = np.zeros((16, S), np.float32)
    for i, s in enumerate(store.samples):
        wav[i, : len(s)] = s
    x = tf.preemphasis(torch.from_numpy(wav), torch.from_numpy(store.lengths).long(), cfg.preemph)
    x = tf.pad_both(x, cfg.n_fft // 2, cfg.pad_mode)[:, tf._frontend_constants(cfg)[3][0]:]
    return x.contiguous().numpy(), S // cfg.hop_length + 1


def drift(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got.astype(np.float64) - want)
    n, t, m = np.unravel_index(int(np.argmax(d)), d.shape)
    return {"max": float(d.max()), "p99": float(np.percentile(d, 99)),
            "p50": float(np.percentile(d, 50)), "at": {"utterance": int(n), "frame": int(t),
                                                       "mel": int(m)}}


def main() -> int:
    torch.set_num_threads(4)
    cfg = FeaturizerConfig()
    x, T = kernel_d_input(cfg)
    twin = tf.fused_mel_reference(torch.from_numpy(x), T, cfg).numpy()
    exact = f64_fused_mel(x, T, cfg)
    print(json.dumps({"split": "f32 twin", "vs_f64": drift(twin, exact)}), flush=True)
    for pieces in ("kernel", "3x", "1x"):
        got = emulate_fused_mel(x, T, cfg, pieces)
        print(json.dumps({"split": pieces, "vs_twin": drift(got, twin),
                          "vs_f64": drift(got, exact)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
