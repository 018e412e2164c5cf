"""Log-mel feature frontend as plain PyTorch ops
(counterpart of rnnt_inference_tpu/ops/features.py).

  1. preemphasis y[t] = x[t] - 0.97 x[t-1], length-masked
  2. frames of the window support (320 of the 512-sample n_fft frame, hop
     160) after n_fft/2 boundary padding ("zeros" or "reflect")
  3. |windowed DFT|^2 as two f32 matmuls, + dither^2
  4. slaney mel filterbank matmul + 1e-20, log
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
below.  Like the JAX package, no runner calls it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.ops import features_cuda


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


@functools.lru_cache(maxsize=8)
def device_constants(cfg: FeaturizerConfig, device: str):
    """(cos (flen, K), sin (flen, K), fbT (K, n_mels)) as contiguous f32
    tensors on ``device``, K = n_fft//2 + 1."""
    cos_m, sin_m, fb, _ = _frontend_constants(cfg)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(cos_m), t(sin_m), t(fb.T)


def log_mel_features(
    x: torch.Tensor,
    x_lens: torch.Tensor,
    cfg: FeaturizerConfig = FeaturizerConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveforms {N, S} f32 -> features {T_out, N, 240} f32 (time-major, as
    the encoder takes them) and lengths {N} int32."""
    _check_f32_matmuls(x)
    dev = x.device
    cos_m, sin_m, fbt = device_constants(cfg, str(dev))
    x_lens = x_lens.to(device=dev, dtype=torch.int64)

    x = preemphasis(x.float(), x_lens, cfg.preemph)
    frames = frame_signal(
        x, cfg.n_fft, cfg.hop_length, cfg.pad_mode, support=_frontend_constants(cfg)[3]
    )
    spec = power_spectrum(frames, cos_m, sin_m)
    if cfg.dither > 0:
        spec = spec + cfg.dither**2
    mel = torch.matmul(spec, fbt) + 1e-20
    if cfg.log:
        mel = torch.log(mel)
    return _finish(mel, x_lens // cfg.hop_length + 1, cfg)


def fused_mel_reference(x: torch.Tensor, n_frames: int, cfg: FeaturizerConfig) -> torch.Tensor:
    """Kernel D's plain twin: x {N, S'} (preemphasized, padded, trimmed to
    the window support) -> log(|DFT(frame t)|^2 + dither^2) . fb + 1e-20)
    {N, n_frames, n_mels}, frame t = x[:, t*hop : t*hop + flen]."""
    cos_m, sin_m, fbt = device_constants(cfg, str(x.device))
    frames = frames_at(x, n_frames, cfg.hop_length, cos_m.shape[0])
    spec = power_spectrum(frames, cos_m, sin_m) + float(cfg.dither) ** 2
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
    cos_m, sin_m, fbt = device_constants(cfg, str(x.device))
    return features_cuda.log_mel_cuda(
        x, n_frames, cos_m, sin_m, fbt, cfg.hop_length, float(cfg.dither) ** 2
    )


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
    function, the log is always taken.  Needs win_length == 2 * hop."""
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
