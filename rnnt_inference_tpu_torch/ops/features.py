"""Log-mel feature frontend as plain PyTorch ops
(counterpart of rnnt_inference_tpu/ops/features.py).

  1. preemphasis y[t] = x[t] - 0.97 x[t-1], length-masked
  2. frames of the window support (320 of the 512-sample n_fft frame, hop
     160) after n_fft/2 boundary padding ("zeros" or "reflect")
  3. |windowed DFT|^2 as two f32 matmuls, + dither^2 (``dither_power``)
  4. slaney mel filterbank matmul + the log guard (MLPerf's 1e-20), log
  5. frames past each utterance's length zeroed, splicing x3 (stride 3)
  6. per-feature mean/var normalization over valid frames

The DFT and mel products are true f32 matmuls, as in the JAX package, which
computes them outside any kernel.  TF32 would break the f32 contract (the
drift gate of tests/test_features.py), so a CUDA call with
``torch.backends.cuda.matmul.allow_tf32`` set raises.

``log_mel_features_fused`` (counterpart of
rnnt_inference_tpu/ops/features_pallas.py log_mel_features_pallas) runs
steps 2-4 as one kernel (kernel D, ops/features_cuda.py) on CUDA tensors;
its plain twin ``fused_mel_reference`` is the composition of the functions
below.  Like the JAX package, no runner calls it.  The kernel computes its
products on the tensor cores from tf32 pieces of the operands
(``tf32_split``: 3xTF32); ``device_constants`` lays the constants' pieces
out in the order its fragments read them (``MelOperands``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.ops import cuda_build, features_cuda


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1);
    librosa.filters.mel defaults (norm='slaney', htk=False)."""
    fftfreqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window(win_length, periodic=False)."""
    if win_length == 1:
        return np.ones(1, dtype=np.float32)
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1 - np.cos(2 * np.pi * n / (win_length - 1)))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _frontend_constants(cfg: FeaturizerConfig):
    """Window-folded DFT matrices trimmed to the window support, the mel
    filterbank, and the support (start, length) within the n_fft frame."""
    n_fft = cfg.n_fft
    win = hann_window(cfg.win_length)
    pad_l = (n_fft - cfg.win_length) // 2
    win_full = np.zeros(n_fft, dtype=np.float64)
    win_full[pad_l : pad_l + cfg.win_length] = win
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    cos_m = (np.cos(ang) * win_full[:, None]).astype(np.float32)
    sin_m = (np.sin(ang) * win_full[:, None]).astype(np.float32)
    # rows outside the window support are exact zeros: drop them
    support = (pad_l, cfg.win_length)
    cos_m = cos_m[pad_l : pad_l + cfg.win_length]
    sin_m = sin_m[pad_l : pad_l + cfg.win_length]
    fb = mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.lowfreq, cfg.fmax)
    return cos_m, sin_m, fb, support


def preemphasis(x: torch.Tensor, x_lens: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coeff*x[t-1], zeroed past each waveform's length.

    Rounded once to f32, as XLA fuses the JAX function: the product of two
    f32 values is exact in f64, so forming the difference in f64 and
    casting gives the singly rounded result (an f32 multiply, then an f32
    subtract, would round twice).  coeff is taken as float32(coeff), the
    value JAX's weakly typed constant takes in an f32 product."""
    c = float(np.float32(coeff))
    xd = x.double()
    y = (xd - c * F.pad(xd[:, :-1], (1, 0))).float()
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    return y.masked_fill(t >= x_lens[:, None], 0.0)


def pad_both(x: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """(N, S) -> (N, S + 2 pad), as jnp.pad(mode="constant" | "reflect").

    "reflect" mirrors about the edge samples and, where pad > S - 1,
    repeats the reflection (jnp.pad's rule; torch's own reflect padding
    raises there): sample i of the padded row is x[r(i - pad)], where r
    folds an index onto [0, S) with period 2 (S - 1)."""
    if pad_mode == "zeros":
        return F.pad(x, (pad, pad))
    if pad_mode != "reflect":
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    S = x.shape[1]
    i = torch.arange(-pad, S + pad, device=x.device)
    if S == 1:
        return x[:, torch.zeros_like(i)]
    period = 2 * (S - 1)
    j = torch.remainder(i, period)
    return x[:, torch.where(j < S, j, period - j)]


def frame_signal(
    x: torch.Tensor, n_fft: int, hop: int, pad_mode: str = "zeros",
    support: Tuple[int, int] = None,
) -> torch.Tensor:
    """Pad n_fft//2 on both sides and slice frames: (N, S) -> (N, T, flen)
    with T = S//hop + 1.  support=(start, flen) keeps samples
    [start, start+flen) of each n_fft-sample frame (default: all of it)."""
    start, flen = support if support is not None else (0, n_fft)
    x_padded = pad_both(x, n_fft // 2, pad_mode)[:, start:]
    return frames_at(x_padded, x.shape[1] // hop + 1, hop, flen)


def frames_at(x: torch.Tensor, n_frames: int, hop: int, flen: int) -> torch.Tensor:
    """(N, S) -> (N, n_frames, flen): frame t is x[:, t*hop : t*hop + flen],
    zeros past S."""
    need = (n_frames - 1) * hop + flen
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    return x.unfold(1, flen, hop)[:, :n_frames]


def power_spectrum(frames: torch.Tensor, cos_m: torch.Tensor, sin_m: torch.Tensor) -> torch.Tensor:
    """|windowed DFT|^2 via two f32 matmuls."""
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    return re * re + im * im


def frame_splice(x: torch.Tensor, splicing: int) -> torch.Tensor:
    """(N, T, C) -> (N, ceil(T/splicing), C*splicing): groups of `splicing`
    consecutive frames stacked channel-wise, zeros past T."""
    N, T, C = x.shape
    T2 = -(-T // splicing)
    x = F.pad(x, (0, 0, 0, T2 * splicing - T))
    return x.reshape(N, T2, splicing * C)


def normalize_per_feature(
    x: torch.Tensor, x_lens: torch.Tensor, std_constant: float = 1e-5
) -> torch.Tensor:
    """Per-utterance per-channel mean/var normalization over valid frames,
    unbiased std + constant."""
    N, T, C = x.shape
    valid = (torch.arange(T, device=x.device)[None, :] < x_lens[:, None]).to(x.dtype)
    denom = torch.clamp(x_lens.to(x.dtype), min=1.0)[:, None]
    mean = torch.sum(x * valid[:, :, None], dim=1) / denom
    diff = (x - mean[:, None, :]) * valid[:, :, None]
    var = torch.sum(diff * diff, dim=1) / torch.clamp(denom - 1.0, min=1.0)
    std = torch.sqrt(var) + std_constant
    return (x - mean[:, None, :]) / std[:, None, :]


def _check_f32_matmuls(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the featurizer needs true f32 matmuls: "
            "torch.backends.cuda.matmul.allow_tf32 is set"
        )


def tf32_split(t: torch.Tensor, pieces: int = 2) -> Tuple[torch.Tensor, ...]:
    """f32 t -> (hi, lo) or, with pieces=3, (hi, lo, lo2): hi is t rounded to
    tf32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, 10
    explicit mantissa bits), lo = tf32(t - hi), lo2 = tf32(t - hi - lo).
    Two pieces hold about 22 significant bits of t; three hold t exactly
    (finite values above the subnormal range)."""
    out, rest = [], t.float().contiguous()
    for _ in range(pieces):
        bits = rest.view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
        p = (mag | (bits & -0x80000000)).view(torch.float32)
        out.append(p)
        rest = rest - p  # exact: p is rest's leading bits
    return tuple(out)


# the first bin tiles (8 bins each) whose products in kernel D take three
# tf32 pieces of each operand (csrc/mel.cu takes the count from dft3)
BIN_TILES_3WAY = 2


class MelOperands(NamedTuple):
    """Kernel D's constants (csrc/mel.cu), f32 pieces in mma.sync m16n8k8
    fragment order (``cuda_build.b_fragments``; per k-step s of 8 inputs and
    tile j of 8 columns, lane 4g + t holds rows 8s + t and 8s + t + 4 of
    column 8j + g).  The K bins are padded with zero columns to NBT = ceil(K
    / 8) bin tiles (264 bins at K = 257); the filterbank's padded rows are
    zeros, so the padded bins add nothing to the mel sums."""

    dft: torch.Tensor  # (NBT, flen/8, 2, 32, 4): cos, sin; hi, lo of both rows
    dft3: torch.Tensor  # (min(NBT, BIN_TILES_3WAY), flen/8, 32, 4): lo2 of cos, sin
    fb: torch.Tensor  # (NBT, MP/8, 32, 4): fbT padded to (8 NBT, MP) with zeros; hi, lo
    fb_steps: torch.Tensor  # (MP/8, 2) int32: k-steps [lo, hi) of each mel tile's nonzero rows
    fb_frags: int  # the k-steps of fb_steps summed: the fragments the kernel stages
    n_bins: int  # K
    n_mels: int  # M


def _fragments(pieces) -> torch.Tensor:
    """Equal (R, C) f32 pieces (R, C multiples of 8) -> (R/8, C/8, 32,
    2 len(pieces)): each piece's two rows of a lane side by side."""
    return torch.cat([cuda_build.b_fragments(p) for p in pieces], dim=-1).contiguous()


def mel_operands(cos_m: torch.Tensor, sin_m: torch.Tensor, fbt: torch.Tensor) -> MelOperands:
    """Kernel D's operands from cos, sin (flen, K) and fbT (K, M), on their
    device."""
    K, M = fbt.shape
    kp, mp = -(-K // 8) * 8, -(-M // 8) * 8
    parts = [tf32_split(F.pad(c, (0, kp - K)), 3) for c in (cos_m, sin_m)]
    dft = torch.stack([_fragments(p[:2]) for p in parts], dim=2)  # (flen/8, NBT, 2, 32, 4)
    n3 = min(kp // 8, BIN_TILES_3WAY) * 8
    dft3 = _fragments([p[2][:, :n3] for p in parts])  # (flen/8, n3/8, 32, 4)
    fb = F.pad(fbt, (0, mp - M, 0, kp - K))
    nz = fb.reshape(kp // 8, 8, mp // 8, 8).ne(0).any(dim=3).any(dim=1)  # (k-steps, mel tiles)
    steps = torch.arange(kp // 8, device=fbt.device)[:, None]
    lo = torch.where(nz, steps, kp // 8).amin(dim=0)
    hi = torch.where(nz, steps + 1, 0).amax(dim=0)
    fb_steps = torch.stack([lo, torch.maximum(hi, lo)], dim=1).to(torch.int32)
    return MelOperands(
        dft.transpose(0, 1).contiguous(), dft3.transpose(0, 1).contiguous(),
        _fragments(tf32_split(fb)), fb_steps.contiguous(),
        int((fb_steps[:, 1] - fb_steps[:, 0]).sum()), K, M,
    )


@functools.lru_cache(maxsize=8)
def device_constants(cfg: FeaturizerConfig, device: str):
    """(cos (flen, K), sin (flen, K), fbT (K, n_mels), kernel D's
    ``MelOperands``) as contiguous tensors on ``device``, K = n_fft//2 + 1."""
    cos_m, sin_m, fb, _ = _frontend_constants(cfg)
    cos_m, sin_m, fbt = (torch.from_numpy(np.ascontiguousarray(a)) for a in (cos_m, sin_m, fb.T))
    ops = mel_operands(cos_m, sin_m, fbt)
    to = lambda t: t.to(device)
    return (to(cos_m), to(sin_m), to(fbt),
            ops._replace(**{k: to(getattr(ops, k)) for k in ops._fields[:4]}))


def log_mel_features(
    x: torch.Tensor,
    x_lens: torch.Tensor,
    cfg: FeaturizerConfig = FeaturizerConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveforms {N, S} f32 -> features {T_out, N, 240} f32 (time-major, as
    the encoder takes them) and lengths {N} int32."""
    _check_f32_matmuls(x)
    dev = x.device
    cos_m, sin_m, fbt, _ = device_constants(cfg, str(dev))
    x_lens = x_lens.to(device=dev, dtype=torch.int64)

    x = preemphasis(x.float(), x_lens, cfg.preemph)
    frames = frame_signal(
        x, cfg.n_fft, cfg.hop_length, cfg.pad_mode, support=_frontend_constants(cfg)[3]
    )
    spec = power_spectrum(frames, cos_m, sin_m)
    if cfg.dither_power:
        spec = spec + cfg.dither_power
    mel = torch.matmul(spec, fbt) + cfg.log_guard
    if cfg.log:
        mel = torch.log(mel)
    return _finish(mel, x_lens // cfg.hop_length + 1, cfg)


def fused_mel_reference(x: torch.Tensor, n_frames: int, cfg: FeaturizerConfig) -> torch.Tensor:
    """Kernel D's plain twin: x {N, S'} (preemphasized, padded, trimmed to
    the window support) -> log(|DFT(frame t)|^2 + dither^2) . fb + 1e-20)
    {N, n_frames, n_mels}, frame t = x[:, t*hop : t*hop + flen]."""
    cos_m, sin_m, fbt, _ = device_constants(cfg, str(x.device))
    frames = frames_at(x, n_frames, cfg.hop_length, cos_m.shape[0])
    spec = power_spectrum(frames, cos_m, sin_m) + cfg.dither_power
    return torch.log(torch.matmul(spec, fbt) + 1e-20)


def fused_mel(
    x: torch.Tensor, n_frames: int, cfg: FeaturizerConfig, impl: Optional[str] = None
) -> torch.Tensor:
    """Kernel D's wrapper: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors or when impl="reference"."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "reference" or not x.is_cuda:
        return fused_mel_reference(x, n_frames, cfg)
    ops = device_constants(cfg, str(x.device))[3]
    return features_cuda.log_mel_cuda(x, n_frames, ops, cfg.hop_length, cfg.dither_power)


def log_mel_features_fused(
    x: torch.Tensor,
    x_lens: torch.Tensor,
    cfg: FeaturizerConfig = FeaturizerConfig(),
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_mel_features with frames -> DFT -> power -> mel -> log fused into
    kernel D (counterpart of features_pallas.log_mel_features_pallas).
    Preemphasis and padding run before the kernel, masking, splicing and
    normalization after it, as in log_mel_features.  As in the JAX
    function, the log is always taken.  Needs win_length == 2 * hop and
    kernel D's log guard, 1e-20."""
    if cfg.log_guard != 1e-20:
        raise ValueError(f"kernel D adds a log guard of 1e-20, not {cfg.log_guard}")
    _, _, _, (start, flen) = _frontend_constants(cfg)
    if flen != 2 * cfg.hop_length:
        raise ValueError(
            f"the fused featurizer needs win_length == 2*hop_length (got {flen}, "
            f"hop {cfg.hop_length})"
        )
    _check_f32_matmuls(x)
    dev = x.device
    x_lens = x_lens.to(device=dev, dtype=torch.int64)
    T = x.shape[1] // cfg.hop_length + 1
    x = preemphasis(x.float(), x_lens, cfg.preemph)
    x = pad_both(x, cfg.n_fft // 2, cfg.pad_mode)[:, start:]
    mel = fused_mel(x.contiguous(), T, cfg, impl)
    return _finish(mel, x_lens // cfg.hop_length + 1, cfg)


def _finish(
    mel: torch.Tensor, frame_lens: torch.Tensor, cfg: FeaturizerConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame masking, splicing, normalization: (N, T, n_mels) log-mel ->
    ({T_out, N, C}, lengths {N} int32)."""
    dev = mel.device
    # zero frames past each utterance's frame count before splicing, so the
    # result does not depend on batch padding
    t_idx = torch.arange(mel.shape[1], device=dev)[None, :, None]
    mel = mel.masked_fill(t_idx >= frame_lens[:, None, None], 0.0)
    if cfg.frame_splicing > 1:
        mel = frame_splice(mel, cfg.frame_splicing)
    out_lens = -(-frame_lens // cfg.frame_splicing)
    if cfg.normalize == "per_feature":
        mel = normalize_per_feature(mel, out_lens)

    T = mel.shape[1]
    valid = torch.arange(T, device=dev)[None, :, None] < out_lens[:, None, None]
    mel = mel.masked_fill(~valid, 0.0)
    return mel.transpose(0, 1).contiguous(), out_lens.to(torch.int32)
