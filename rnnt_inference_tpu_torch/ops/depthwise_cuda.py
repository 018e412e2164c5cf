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

The causal form (``depthwise_causal``, kernel ``depthwise_causal`` in the
same source; launch_counts' "depthwise_causal") serves NeMo's cache-aware
FastConformer (models/fastconformer.py): each of N slots brings one chunk
of C rows, and its convolution reads K - 1 rows back and none ahead, the
first K - 1 from the slot's cache (N, K - 1, D) (zeros at an utterance's
start), which the same launch replaces with the last K - 1 rows of [cache;
chunk].  Then the convolution module's LayerNorm over the D channels and
Swish, all in f32:

    y[s, t, c] = sum_k w[k, c] xs[s, t + k, c] + b[c],  xs = [cache; x]
    out        = silu(LayerNorm(y)),  rounded once to bf16

A block owns a slot, a thread two neighbouring channels of it: its K taps
and its rows stay in registers (each thread reads and writes only its own
channels of the cache, so the in-place update needs no barrier), and the
LayerNorm's row statistics are two block reductions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.ops import cuda_build
from rnnt_inference_tpu_torch.utils.profiler import record_call

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


# -- the causal form --------------------------------------------------------

CAUSAL_MAX_ROWS = 16  # rows of a slot's chunk the kernel holds
CAUSAL_TAPS = 9  # the kernel's taps (the streaming FastConformer's)


def depthwise_causal_reference(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, ln_g: torch.Tensor, ln_b: torch.Tensor,
                               eps: float) -> torch.Tensor:
    """The causal form's plain twin: x (N C, D), cache (N, K - 1, D)
    (replaced in place), w (K, D), b, ln_g, ln_b (D,) -> (N C, D) in x's
    type."""
    N, K1, D = cache.shape
    xs = torch.cat([cache, x.reshape(N, -1, D)], 1)  # (N, K - 1 + C, D)
    C = xs.shape[1] - K1
    xf, wf = xs.float(), w.float()
    y = wf[0] * xf[:, :C]
    for k in range(1, K1 + 1):
        y = y + wf[k] * xf[:, k : k + C]
    y = F.layer_norm(y + b.float(), (D,), ln_g.float(), ln_b.float(), eps)
    cache.copy_(xs[:, C:])
    return F.silu(y).to(x.dtype).reshape(N * C, D)


def depthwise_causal_cuda(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, ln_g: torch.Tensor, ln_b: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """The causal form on the card: one launch over every slot.  A shape,
    type or device it cannot take raises.  While a torch profiler runs the
    call is recorded (utils/profiler.py ``REGISTRY.calls``)."""
    N, K1, D = cache.shape
    K = w.shape[0] if w.dim() == 2 else 0
    C = x.shape[0] // N if N else 0
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"kernel G (causal) takes contiguous bf16 CUDA rows, got {x.dtype} "
                         f"on {x.device}")
    if (K != CAUSAL_TAPS or K1 != K - 1 or D % 64 or D > 1024 or x.shape != (N * C, D)
            or not 1 <= C <= CAUSAL_MAX_ROWS or w.shape[1] != D):
        raise ValueError(f"kernel G (causal) takes {CAUSAL_TAPS} taps, a multiple of 64 "
                         f"channels up to 1,024 and chunks of at most {CAUSAL_MAX_ROWS} rows: "
                         f"x {tuple(x.shape)}, cache {tuple(cache.shape)}, w {tuple(w.shape)}")
    if cache.dtype != torch.bfloat16 or not cache.is_contiguous() or w.dtype != torch.bfloat16:
        raise ValueError("kernel G (causal): the cache must be contiguous bf16 and w bf16")
    for name, t in (("cache", cache), ("w", w), ("b", b), ("ln_g", ln_g), ("ln_b", ln_b)):
        if t.device != x.device:
            raise ValueError(f"kernel G (causal): {name} on {t.device}, x on {x.device}")
        if name in ("b", "ln_g", "ln_b") and tuple(t.shape) != (D,):
            raise ValueError(f"kernel G (causal): {name} {tuple(t.shape)}, want ({D},)")
    out = torch.empty_like(x)
    if N == 0:
        return out
    wc = w.contiguous()
    bc, gc, bbc = (t.float().contiguous() for t in (b, ln_g, ln_b))
    lib = _lib_causal()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.rnnt_depthwise_causal(x.data_ptr(), cache.data_ptr(), wc.data_ptr(),
                                        bc.data_ptr(), gc.data_ptr(), bbc.data_ptr(),
                                        out.data_ptr(), N, C, D, K, float(eps),
                                        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "kernel G (depthwise_causal)")
    depthwise_causal_cuda.launches += 1
    record_call("kernel_g_causal", depthwise_causal_cuda.launches, slots=N, chunk_rows=C,
                cache_rows=K1, channels=D, taps=K)
    return out


depthwise_causal_cuda.launches = 0


def _lib_causal() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_depthwise_causal.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_depthwise_causal.argtypes = [p] * 7 + [i] * 4 + [ctypes.c_float, p]
        lib.rnnt_depthwise_causal.restype = ctypes.c_int
    return lib


def depthwise_causal(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     ln_g: torch.Tensor, ln_b: torch.Tensor, eps: float,
                     impl: Optional[str] = None) -> torch.Tensor:
    """The causal form's wrapper: the kernel for CUDA tensors, the plain twin
    for CPU tensors or when impl="reference"."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "reference" or not x.is_cuda:
        return depthwise_causal_reference(x, cache, w, b, ln_g, ln_b, eps)
    return depthwise_causal_cuda(x, cache, w, b, ln_g, ln_b, eps)
