"""Kernel G: the Conformer convolution module's depthwise convolution, its
bias (BatchNorm folded in) and Swish in one pass over the varlen rows, in
CUDA C++ (csrc/depthwise.cu), and its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package has no convolution module.  It
was added because the library's path is slow on the varlen layout: a
depthwise Conv1d over (1, D, R) needs the (R, D) rows transposed to
channels first and back (two strided copies of the whole rep), and PyTorch
runs it on its generic depthwise kernel, together 60 ms of a 171 ms block
on an H100 at a rep's 1.7 M rows (PERF.md).  Here

    out[r, c] = silu(sum_k w[k, c] x[r + k - K // 2, c] + b[c])

reads x (R, D) bf16 as it lies, rows of ``gaps`` (the rows no utterance
owns, models/conformer.py) and rows past either end read as zero, so no
sum reaches across utterances; sums, bias and Swish in f32, the output
rounded once to bf16.

What bounds it: 2 K operations per element against 4 bytes (one bf16 read
of x, one bf16 write), far below the card's ridge: bandwidth.  The design
(csrc/depthwise.cu): a block stages the 128 + K - 1 rows of 64 channels
its taps reach in shared memory once (gaps zero-filled by the copy), a
lane keeps two channels' K weights in registers and sums 16 rows from
the staged rows, each staged row feeding up to K of its sums.

``depthwise_silu`` is the wrapper: CUDA tensors launch the kernel
(``depthwise_silu_cuda``, counted in its ``launches``; runtime/offline.py
launch_counts' "depthwise"), CPU tensors or impl="reference" take the twin.
The kernel is built on its first launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "depthwise"
BC = 64  # channels a block: the launch takes a multiple of it


def depthwise_silu_reference(x: torch.Tensor, gaps: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Kernel G's plain twin: x (R, D), gaps (R,) bool, w (K, D), b (D,)."""
    K, D = w.shape
    xz = x.float().masked_fill(gaps[:, None], 0.0)
    y = F.conv1d(xz.t()[None], w.float().t()[:, None, :], b.float(), padding=K // 2, groups=D)
    return F.silu(y[0].t()).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_depthwise_silu.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnnt_depthwise_silu.argtypes = [p] * 5 + [ll, i, i, p]
        lib.rnnt_depthwise_silu.restype = ctypes.c_int
    return lib


def depthwise_silu_cuda(x: torch.Tensor, gaps: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Kernel G on the card: one launch over all rows.  A shape, type or
    device it cannot take raises."""
    R, D = x.shape
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"kernel G takes contiguous bf16 CUDA rows, got {x.dtype} on {x.device}")
    K = w.shape[0] if w.dim() == 2 else 0
    if D % BC or K != 31:
        raise ValueError(f"kernel G takes a multiple of {BC} channels and 31 taps (the "
                         f"Conformer's), got {D} channels and w {tuple(w.shape)}")
    if w.shape[1] != D or tuple(b.shape) != (D,) or tuple(gaps.shape) != (R,):
        raise ValueError(f"kernel G: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, gaps {tuple(gaps.shape)}")
    if gaps.dtype != torch.bool or w.dtype != torch.bfloat16:
        raise ValueError(f"kernel G: gaps must be bool and w bf16, got {gaps.dtype}, {w.dtype}")
    for name, t in (("w", w), ("b", b), ("gaps", gaps)):
        if t.device != x.device:
            raise ValueError(f"kernel G: {name} on {t.device}, x on {x.device}")
    out = torch.empty_like(x)
    if R == 0:
        return out
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    wc, bc, gc = w.contiguous(), b.float().contiguous(), gaps.contiguous().view(torch.uint8)
    lib = _lib()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.rnnt_depthwise_silu(x.data_ptr(), gc.data_ptr(), wc.data_ptr(), bc.data_ptr(),
                                      out.data_ptr(), R, D, K,
                                      torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "kernel G (depthwise_silu)")
    depthwise_silu_cuda.launches += 1
    return out


depthwise_silu_cuda.launches = 0


def depthwise_silu(x: torch.Tensor, gaps: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Kernel G's wrapper: the kernel for CUDA tensors, the plain twin for
    CPU tensors or when impl="reference"."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "reference" or not x.is_cuda:
        return depthwise_silu_reference(x, gaps, w, b)
    return depthwise_silu_cuda(x, gaps, w, b)
