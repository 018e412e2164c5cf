"""Kernel A: the int8 LSTM layer in CUDA C++ (csrc/quant_lstm.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_quant_lstm_cat_kernel.
``quant_lstm_layer_cuda`` launches it on PyTorch's current stream: one
cooperative launch per call, all T steps inside, H / U blocks that each
keep U hidden units' columns of W_ih and W_hh in shared memory (``plan``,
``kernel_operands``) and multiply on the int8 tensor cores.  Every layer
call is counted once in ``quant_lstm_layer_cuda.launches``.  Its plain
twin is ops/lstm_int8.py quant_lstm_layer, which it equals bit for bit;
ops/lstm_int8.py quant_lstm_layer_op chooses between them by device.

Calls of many lanes (``hoists``, from the call's shape alone) take the
hoisted path: x . W_ih for all T N rows first, as one int8 tensor-core
GEMM (``input_products_cuda``, the kernel quant_lstm_xw, whose plain twin
is ``input_products``; its operand ``xw_operand``), then the time loop on
h . W_hh alone, which adds the precomputed sums.  Such calls are counted
also in ``quant_lstm_layer_cuda.hoisted``.

The kernel serves one card's whole grid.  Tensor parallelism (a mesh's
"model" axis, parallel/tensor.py) has no kernel: it runs the plain rank
steps of ops/lstm_int8.py (``quant_lstm_layer_tp``), on the card only
with impl="reference".
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "quant_lstm"
U = 8  # hidden units per block the kernel is built for
PASS_LANES = 128  # lane rows of one pass of the time loop (csrc/hopper.cuh RMAX)
# the warps' sums, which the hoisted loop keeps beside its two h slots
# (csrc/quant_lstm.cu PART_BYTES: 8 warps x 16 rows x (4U + 8) words)
_PART_BYTES = 8 * 16 * (4 * U + 8) * 4
# The hoisted path's rows T N: at least HOIST_MIN_ROWS, where the GEMM's
# launch is paid back, and at most HOIST_MAX_ROWS, which bounds its sums'
# scratch (16,384 x 4H s32: 268 MB at H = 1,024).  Set from chip_smoke.py
# kernel_a's times of both paths on an H100 (ms a call at H = 1,024,
# fused -> hoisted): the packed runner's T = 16, N = 1,024 at IC = 240
# 1.414 -> 1.142 and at IC = 1,024 1.986 -> 1.212; its T = 8 at IC =
# 2,048 1.697 -> 0.668 and at 1,024 1.049 -> 0.627; at IC = 240, T = 4,
# N = 256 (1,024 rows) 0.098 -> 0.087, but T = 3, N = 200 (600 rows)
# 0.068 -> 0.109.
HOIST_MIN_ROWS = 1024
HOIST_MAX_ROWS = 16384


def _pad64(k: int) -> int:
    return -(-k // 64) * 64


def hoists(T: int, N: int, IC: int) -> bool:
    """Whether a layer call of T steps, N lanes and IC inputs takes the
    hoisted path (x . W_ih as one GEMM before the time loop): calls of more
    lanes than one pass of the loop takes, whose rows T N lie in
    [HOIST_MIN_ROWS, HOIST_MAX_ROWS], at every IC.  The fused loop takes
    the first pass's x product between a step's barrier arrive and wait;
    every further pass of 128 lanes takes its own after the wait, each
    block re-reading x from L2, so the gain grows with the passes: a step
    at the packed Offline runner's 1,024 lanes and IC = 2,048 takes about
    3x less.  Calls of one pass (the Server's 128 slots, the bucketed
    runners' 16 or 128 lanes, SingleStream's one) keep the fused loop,
    though the device alone would gain there too (T = 48, N = 128, IC =
    1,024: 0.77 -> 0.53 ms): the Server's pace is set on the host, where
    the GEMM adds a launch to each of a dispatch's 20 layer calls, and
    whole utterances of 128 lanes would pass the scratch's bound."""
    del IC  # every input width gains at the packed runner's shapes
    return N > PASS_LANES and HOIST_MIN_ROWS <= T * N <= HOIST_MAX_ROWS


@functools.lru_cache(maxsize=64)
def plan(H: int, IC: int, N: int, sms: int, hoisted: bool = False) -> int:
    """The least shared bytes per block for H hidden units, IC inputs and N
    lanes on a card with ``sms`` SMs: H / U blocks, one to an SM (the
    kernel's staging ring then takes the rest of shared memory); the
    hoisted path stages no W_ih.  Raises ValueError for a shape the kernel
    cannot take."""
    if H <= 0 or IC <= 0 or H % 16 or IC % 16:
        raise ValueError(
            f"kernel A copies rows in 16-byte pieces: H and IC must be multiples of 16, "
            f"got H={H} IC={IC}")
    if H // U > sms:
        raise ValueError(f"kernel A: H={H} needs {H // U} blocks, the card has {sms} SMs")
    smem = (((0 if hoisted else _pad64(IC)) + _pad64(H)) * 4 * U + -(-N * U // 4) * 16
            + cuda_build.ring_min_bytes(torch.int8) + (_PART_BYTES if hoisted else 0))
    if smem > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(
            f"kernel A: N={N} lanes at IC={IC}, H={H} need {smem} bytes of shared memory "
            f"per block, more than {cuda_build.SMEM_PER_BLOCK}"
        )
    return smem


def kernel_operand(w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """W_ih {IC, 4H} and W_hh {H, 4H} int8 in the kernel's per-block order,
    {H / U, (ICP + HP) 4U}: block b's columns of W_ih, then of W_hh
    (cuda_build.block_columns: gate g of unit b U + u, in int8 mma fragment
    order), each padded with zero rows to ICP, HP, multiples of 64."""
    pad = lambda w: torch.cat([w, w.new_zeros((_pad64(w.shape[0]) - w.shape[0], w.shape[1]))])
    ops = [cuda_build.block_columns(pad(w), U) for w in (w_ih, w_hh)]  # {H/U, K/32, 4, 32, 8}
    return torch.cat(ops, dim=1).reshape(ops[0].shape[0], -1)


def kernel_operand_inverse(op: torch.Tensor, IC: int, H: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_ih {IC, 4H}, W_hh {H, 4H}) back from ``kernel_operand``."""
    f = op.reshape(op.shape[0], -1, U // 2, 32, 8)
    ks = _pad64(IC) // 32
    return (cuda_build.block_columns_inverse(f[:, :ks], H, U)[:IC],
            cuda_build.block_columns_inverse(f[:, ks:], H, U)[:H])


def xw_operand(w_ih: torch.Tensor) -> torch.Tensor:
    """W_ih {IC, 4H} int8 as the input product reads it: W_ih^T {4H, IC},
    row b 4U + 4u + g holding column g H + b U + u (block b's unit u, gate
    g), so that the product's columns come out in the (block, unit, gate)
    order of the time loop's sums (``input_products``)."""
    IC, G = w_ih.shape
    return w_ih.reshape(IC, 4, G // 4 // U, U).permute(2, 3, 1, 0).reshape(G, IC).contiguous()


def xw_operand_inverse(op: torch.Tensor) -> torch.Tensor:
    """W_ih {IC, 4H} back from ``xw_operand``."""
    G, IC = op.shape
    return op.reshape(G // 4 // U, U, 4, IC).permute(3, 2, 0, 1).reshape(IC, G).contiguous()


def xw_layout(xw: torch.Tensor) -> torch.Tensor:
    """The s32 sums x . W_ih {T, N, 4H} (gate g of unit j at column g H + j)
    in the time loop's order {T, H / U, N, U, 4}: step t's sums of block b
    one contiguous piece, the four gates of a (lane, unit) adjacent."""
    T, N, G = xw.shape
    return xw.reshape(T, N, 4, G // 4 // U, U).permute(0, 3, 1, 4, 2).contiguous()


def input_products(x_i8: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """The hoisted GEMM's plain twin: x {T, N, IC} int8 . W_ih {IC, 4H} int8,
    exact (float64 sums of int8 products, as ops/lstm_int8.py int_dot), as
    int32 in ``xw_layout``."""
    return xw_layout(torch.matmul(x_i8.double(), w_ih.double()).to(torch.int32))


def kernel_operands(layer) -> tuple:
    """(w_op, bias f32, rb, in_scale, out_scale) of a QuantLSTMLayerWeights:
    w_op is ``kernel_operand`` of its W_ih and W_hh; the scales travel as
    the f32 values of the layer's 0-d tensors.  Built on the layer's first
    call and kept until the layer is freed; rebuilt if one of its tensors is
    replaced or changed in place."""

    def build():
        return (
            kernel_operand(layer.w_ih, layer.w_hh),
            layer.b.float().contiguous(),
            float(layer.rb_scale),
            float(layer.in_scale),
            float(layer.out_scale),
        )

    tensors = (layer.w_ih, layer.w_hh, layer.b, layer.in_scale, layer.w_scale, layer.out_scale)
    return cuda_build.cached_operands(layer, NAME, tensors, build)


def xw_operands(layer):
    """``xw_operand`` of a QuantLSTMLayerWeights' W_ih, kept beside
    ``kernel_operands`` (built on the first hoisted call, rebuilt if W_ih is
    replaced or changed in place)."""
    return cuda_build.cached_operands(layer, f"{NAME}/xw", (layer.w_ih,),
                                      lambda: xw_operand(layer.w_ih))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_quant_lstm_layer.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rnnt_quant_lstm_layer.argtypes = [p] * 11 + [i] * 4 + [f] * 3 + [i, p]
        lib.rnnt_quant_lstm_layer.restype = ctypes.c_int
        lib.rnnt_quant_lstm_xw.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.rnnt_quant_lstm_xw.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _scratch(dev: torch.device, stream: int, N: int, H: int):
    """Kernel A's scratch for one stream and shape, made once and reused by
    every launch: the ping-pong h {2, N, H} int8 and the grid barrier's
    word (zeroed here; every launch leaves its count at zero)."""
    hbuf = torch.empty((2, N, H), dtype=torch.int8, device=dev)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    return hbuf, bar


@functools.lru_cache(maxsize=16)
def _xw_scratch(dev: torch.device, stream: int, H: int) -> torch.Tensor:
    """The hoisted path's sums for one stream, made once at the most rows a
    hoisted call has (HOIST_MAX_ROWS x 4H int32: 268 MB at H = 1,024); a
    call's GEMM writes its {T, H / U, N, U, 4} into the front and the
    launch after it on the stream reads them."""
    return torch.empty((HOIST_MAX_ROWS * 4 * H,), dtype=torch.int32, device=dev)


def _launch_input_products(lib, x_i8: torch.Tensor, w_xw: torch.Tensor, out: torch.Tensor,
                           stream: int) -> None:
    T, N, IC = x_i8.shape
    err = lib.rnnt_quant_lstm_xw(x_i8.data_ptr(), w_xw.data_ptr(), out.data_ptr(), T, N, IC,
                                 w_xw.shape[0] // 4, cuda_build.sm_count(x_i8.device), stream)
    cuda_build.check(lib, err, "quant_lstm input products")


def input_products_cuda(layer, x_i8: torch.Tensor) -> torch.Tensor:
    """The hoisted path's GEMM alone, on the card: x {T, N, IC} int8 .
    layer.w_ih, in ``xw_layout`` {T, H / U, N, U, 4} int32 (a new tensor;
    equal to ``input_products``)."""
    T, N, IC = x_i8.shape
    H = layer.w_hh.shape[0]
    cuda_build.require(x_i8, "x", torch.int8, (T, N, IC))
    if x_i8.data_ptr() % 16 or IC % 16:
        raise ValueError("the input product reads x rows by TMA: IC a multiple of 16, x "
                         "16-byte aligned")
    w_xw = xw_operands(layer)
    cuda_build.require(w_xw, "w_xw", torch.int8, (4 * H, IC))
    out = torch.empty((T, H // U, N, U, 4), dtype=torch.int32, device=x_i8.device)
    if T and N:
        with torch.cuda.device(x_i8.device):
            _launch_input_products(_lib(), x_i8, w_xw, out,
                                   torch.cuda.current_stream(x_i8.device).cuda_stream)
    return out


def quant_lstm_layer_cuda(
    layer, x_i8: torch.Tensor, h_i8: torch.Tensor, c: torch.Tensor, emit_f32: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 LSTM layer over x_i8 {T, N, IC} on the card: one launch, or
    on the hoisted path (``hoists``) the input GEMM's and the loop's.
    Returns (y {T,N,H} int8 or f32, hT int8, cT f32).  A shape the kernel
    cannot take raises ValueError before any launch; a refused launch
    raises RuntimeError."""
    hoist = hoists(*x_i8.shape)
    out, launched = layer_on_path(layer, x_i8, h_i8, c, emit_f32, hoist)
    if launched:
        quant_lstm_layer_cuda.launches += 1
        _counters.hoisted += hoist
    return out


quant_lstm_layer_cuda.launches = 0
quant_lstm_layer_cuda.hoisted = 0
# ``hoisted`` is counted on the function itself: a recorder that stands in
# for the module's name while it runs (benchmark/models/rnnt.py recording)
# carries ``launches`` over and back, not this count
_counters = quant_lstm_layer_cuda


def layer_on_path(layer, x_i8: torch.Tensor, h_i8: torch.Tensor, c: torch.Tensor,
                  emit_f32: bool, hoist: bool):
    """``quant_lstm_layer_cuda`` on the path given (hoisted or fused),
    counted nowhere: ((y, hT, cT), whether it launched).  The wrapper's
    body; the smoke run and the card tests time and hold both paths at one
    shape through it."""
    T, N, IC = x_i8.shape
    H = layer.w_hh.shape[0]
    x_i8, h_i8, c = x_i8.contiguous(), h_i8.contiguous(), c.contiguous()
    cuda_build.require(x_i8, "x", torch.int8, (T, N, IC))
    cuda_build.require(h_i8, "h", torch.int8, (N, H))
    cuda_build.require(c, "c", torch.float32, (N, H))
    if x_i8.data_ptr() % 16 or h_i8.data_ptr() % 16:
        raise ValueError("kernel A copies x and h rows in 16-byte pieces: align them")
    dev = x_i8.device
    y = torch.empty((T, N, H), dtype=torch.float32 if emit_f32 else torch.int8, device=dev)
    if T == 0 or N == 0:
        return (y, h_i8.clone(), c.clone()), False
    plan(H, IC, N, cuda_build.sm_count(dev), hoisted=hoist)
    w_op, bias, rb, in_scale, out_scale = kernel_operands(layer)
    cuda_build.require(w_op, "w_op", torch.int8, (H // U, (_pad64(IC) + _pad64(H)) * 4 * U))
    cuda_build.require(bias, "bias", torch.float32, (4 * H,))
    if w_op.device != dev:
        raise ValueError(f"kernel A: weights on {w_op.device}, x on {dev}")
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        hbuf, bar = _scratch(dev, stream, N, H)
        xw = None
        if hoist:
            if T * N > HOIST_MAX_ROWS:
                raise ValueError(f"kernel A: {T * N} rows, more than the hoisted path's "
                                 f"{HOIST_MAX_ROWS}")
            xw = _xw_scratch(dev, stream, H)[:T * N * 4 * H]
            _launch_input_products(lib, x_i8, xw_operands(layer), xw, stream)
        hT = torch.empty((N, H), dtype=torch.int8, device=dev)
        cT = torch.empty((N, H), dtype=torch.float32, device=dev)
        err = lib.rnnt_quant_lstm_layer(
            x_i8.data_ptr(), w_op.data_ptr(), bias.data_ptr(), h_i8.data_ptr(), c.data_ptr(),
            y.data_ptr(), hT.data_ptr(), cT.data_ptr(), hbuf.data_ptr(), bar.data_ptr(),
            None if xw is None else xw.data_ptr(),
            T, N, IC, H, rb, in_scale, out_scale, int(emit_f32), stream,
        )
    cuda_build.check(lib, err, "quant_lstm kernel")
    return (y, hT, cT), True

