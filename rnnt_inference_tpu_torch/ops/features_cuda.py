"""Kernel D: the fused featurizer middle in CUDA C++ (csrc/mel.cu).

Replaces rnnt_inference_tpu/ops/features_pallas.py::_mel_kernel.
``log_mel_cuda`` launches it on PyTorch's current stream (one launch per
call) and counts every launch in ``log_mel_cuda.launches``.  Its plain twin
is ops/features.py fused_mel_reference; ops/features.py fused_mel chooses
between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "mel"


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_log_mel.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rnnt_log_mel.argtypes = [p, p, p, p, p] + [i] * 6 + [f, p]
        lib.rnnt_log_mel.restype = ctypes.c_int
    return lib


def log_mel_cuda(
    x: torch.Tensor,
    n_frames: int,
    cos_m: torch.Tensor,
    sin_m: torch.Tensor,
    fbt: torch.Tensor,
    hop: int,
    dither2: float,
) -> torch.Tensor:
    """x {N, S} f32 (preemphasized, padded, trimmed to the window support)
    -> log(|DFT|^2 + dither2) . fbT + 1e-20) {N, n_frames, n_mels} f32, frame
    t = x[:, t*hop : t*hop + 2*hop] (zeros past S)."""
    N, S = x.shape
    flen, K = cos_m.shape
    M = fbt.shape[1]
    for name, t, shape in (("x", x, (N, S)), ("cos", cos_m, (flen, K)),
                           ("sin", sin_m, (flen, K)), ("fbT", fbt, (K, M))):
        cuda_build.require(t, name, torch.float32, shape)
    if flen != 2 * hop or hop % 4:
        raise ValueError(f"kernel D needs frame length 2*hop and hop % 4 == 0 (hop {hop})")
    out = torch.empty((N, n_frames, M), dtype=torch.float32, device=x.device)
    if N == 0 or n_frames <= 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):  # the C side sets its attribute on the current device
        err = lib.rnnt_log_mel(
            x.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(), fbt.data_ptr(), out.data_ptr(),
            N, S, n_frames, hop, K, M, float(dither2),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "log_mel kernel")
    log_mel_cuda.launches += 1
    return out


log_mel_cuda.launches = 0
