"""Kernel D: the fused featurizer middle in CUDA C++ (csrc/mel.cu).

Replaces rnnt_inference_tpu/ops/features_pallas.py::_mel_kernel.
``log_mel_cuda`` launches it on PyTorch's current stream (one launch per
call) and counts every launch in ``log_mel_cuda.launches``.  Its plain twin
is ops/features.py fused_mel_reference; ops/features.py fused_mel chooses
between them by device.  The kernel's constants are ops/features.py
``MelOperands`` (tf32 pieces in fragment order).
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
        lib.rnnt_log_mel.argtypes = [p] * 6 + [i] * 8 + [f, p]
        lib.rnnt_log_mel.restype = ctypes.c_int
        lib.rnnt_log_mel_smem.argtypes = [i, i, i]
        lib.rnnt_log_mel_smem.restype = ctypes.c_size_t
    return lib


def log_mel_cuda(x: torch.Tensor, n_frames: int, ops, hop: int, dither2: float) -> torch.Tensor:
    """x {N, S} f32 (preemphasized, padded, trimmed to the window support)
    -> log((|DFT|^2 + dither2) . fbT + 1e-20) {N, n_frames, n_mels} f32,
    frame t = x[:, t*hop : t*hop + 2*hop] (zeros past S).  ops: the
    constants' ``MelOperands`` on x's device.  Rows of S % 4 != 0 samples,
    or an x off a 16-byte boundary, are first copied into rows padded with
    zeros to a multiple of 4 samples."""
    N, S = x.shape
    K, M = ops.n_bins, ops.n_mels
    nbt, sk, mp = -(-K // 8), ops.dft.shape[1], -(-M // 8) * 8
    cuda_build.require(x, "x", torch.float32, (N, S))
    if S % 4 or x.data_ptr() % 16:  # the kernel copies rows 16 bytes at a time
        xp = torch.zeros((N, S + -S % 4), dtype=x.dtype, device=x.device)
        xp[:, :S] = x  # zeros past S, as the function reads them
        x, S = xp, xp.shape[1]
    flen = 8 * sk
    if flen != 2 * hop or hop % 8 or mp > 256:
        raise ValueError(f"kernel D needs frame length 2*hop, hop % 8 == 0 and at most 256 "
                         f"mels (frame {flen}, hop {hop}, {M} mels)")
    n3 = ops.dft3.shape[0]
    for name, t, dtype, shape in (
        ("dft", ops.dft, torch.float32, (nbt, sk, 2, 32, 4)),
        ("dft3", ops.dft3, torch.float32, (n3, sk, 32, 4)),
        ("fb", ops.fb, torch.float32, (nbt, mp // 8, 32, 4)),
        ("fb_steps", ops.fb_steps, torch.int32, (mp // 8, 2)),
    ):
        cuda_build.require(t, name, dtype, shape)
    out = torch.empty((N, n_frames, M), dtype=torch.float32, device=x.device)
    if N == 0 or n_frames <= 0:
        return out
    lib = _lib()
    smem = lib.rnnt_log_mel_smem(hop, nbt, ops.fb_frags)
    if smem > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(f"kernel D needs {smem} bytes of shared memory at hop {hop}, "
                         f"{K} bins (at most {cuda_build.SMEM_PER_BLOCK})")
    with torch.cuda.device(x.device):  # the C side sets its attribute on the current device
        err = lib.rnnt_log_mel(
            x.data_ptr(), ops.dft.data_ptr(), ops.dft3.data_ptr(), ops.fb.data_ptr(),
            ops.fb_steps.data_ptr(), out.data_ptr(),
            N, S, n_frames, hop, K, M, n3, ops.fb_frags, float(dither2),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "log_mel kernel")
    log_mel_cuda.launches += 1
    return out


log_mel_cuda.launches = 0
