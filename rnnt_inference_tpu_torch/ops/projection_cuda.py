"""Kernel E: a bf16 product summed in f32 on the tensor cores, in CUDA C++
(csrc/projection.cu): the float encoder's hoisted projection x @ W_ih + b
first.

Replaces no Pallas kernel: the JAX package leaves ``jnp.dot(...,
preferred_element_type=jnp.float32)`` to XLA.  ``project`` chooses by what
it can observe: bf16 operands on the card launch the kernel
(``project_cuda``); anything else (CPU tensors, f32 or mixed operands, or
impl="reference") takes the plain twin ``project_reference``, the upcast
f32 matmul of ops/lstm.py dot_f32.  With a bias, the kernel's epilogue adds
it and rounds once to bf16 (the projection xw of ops/lstm.py lstm_layer and
lstm_layer_tp, which kernel C reads); without one it stores the f32 sums
(the joint's fproj in models/decoder.py and parallel/tensor.py, kernel B's
eproj).  Every launch is counted in ``project_cuda.launches``
(runtime/offline.py launch_counts' "projection").
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "projection"


def project_reference(a: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E's plain twin: a @ w with f32 sums (operands upcast; a
    product of two bf16 values is exact in f32); with a bias b, + b in f32,
    rounded once to w's dtype."""
    y = torch.matmul(a.float(), w.float())
    return y if b is None else (y + b.float()).to(w.dtype)


def project(a: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            impl: Optional[str] = None) -> torch.Tensor:
    """a {..., K} @ w {K, N} with f32 sums; with a bias b {N}, + b and
    rounded once to w's dtype, else f32.  Kernel E for bf16 operands on the
    card (w 2-D) unless impl="reference"; the plain twin for everything
    else."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl is None and a.is_cuda and a.dtype == w.dtype == torch.bfloat16 and w.dim() == 2:
        return project_cuda(a, w, b)
    return project_reference(a, w, b)


def weight_operand(w: torch.Tensor) -> torch.Tensor:
    """w {K, N} bf16 as the kernel reads it: w^T {N, K8}, K padded with zeros
    to a multiple of 8 (TMA's 16-byte row stride); kept until w is freed and
    made again if w changes."""

    def build():
        K = w.shape[0]
        return F.pad(w.t(), (0, -K % 8)).contiguous()

    return cuda_build.cached_operands(w, NAME, (w,), build)


def _bias_operand(b: torch.Tensor) -> torch.Tensor:
    """b as the kernel's contiguous f32 bias (made once per bias tensor)."""
    if b.dtype == torch.float32 and b.is_contiguous() and b.data_ptr() % 16 == 0:
        return b
    return cuda_build.cached_operands(b, f"{NAME}/bias", (b,), lambda: b.float().contiguous())


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_projection.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_projection.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.rnnt_projection.restype = ctypes.c_int
    return lib


def project_cuda(a: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E on the card: a {..., K} @ w {K, N}, both bf16, in one launch;
    with b {N}: bf16 round(sum + b) (epilogue a), else the f32 sums
    (epilogue b).  No rows or no columns return without a launch; a
    shape or device the kernel cannot take raises."""
    if not a.is_cuda:
        raise ValueError("kernel E takes CUDA tensors (project takes the twin elsewhere)")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.dim() != 2:
        raise ValueError(f"kernel E takes bf16 a and 2-D bf16 w, got {a.dtype} and "
                         f"{w.dtype} {tuple(w.shape)}")
    K, N = w.shape
    if a.dim() == 0 or a.shape[-1] != K:
        raise ValueError(f"kernel E: a {tuple(a.shape)} against w {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (N,):
        raise ValueError(f"kernel E: bias {tuple(b.shape)}, want ({N},)")
    dev = a.device
    for name, t in (("w", w), ("bias", b)):
        if t is not None and t.device != dev:
            raise ValueError(f"kernel E: {name} on {t.device}, a on {dev}")
    lead = a.shape[:-1]
    x = a.reshape(-1, K)
    M = x.shape[0]
    if M == 0 or N == 0 or K == 0:
        return project_reference(a, w, b)
    wt = weight_operand(w)
    Kp = wt.shape[1]
    x = F.pad(x, (0, Kp - K)) if Kp != K else x.contiguous()
    if x.data_ptr() % 16:  # TMA reads from 16-byte boundaries
        x = x.clone()
    bias = None if b is None else _bias_operand(b)
    out = torch.empty((M, N), dtype=torch.float32 if b is None else torch.bfloat16, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        err = lib.rnnt_projection(
            x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, N, Kp, int(b is not None), cuda_build.sm_count(dev),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "projection kernel")
    project_cuda.launches += 1
    return out.reshape(*lead, N)


project_cuda.launches = 0
