"""Kernel A: the int8 LSTM layer in CUDA C++ (csrc/quant_lstm.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_quant_lstm_cat_kernel.
``quant_lstm_layer_cuda`` launches it on PyTorch's current stream: one
cooperative launch per call, all T steps inside, H / U blocks that each
keep U hidden units' columns of W_ih and W_hh in shared memory (``plan``,
``kernel_operands``) and multiply on the int8 tensor cores.  Every launch
is counted in ``quant_lstm_layer_cuda.launches``.  Its plain twin is
ops/lstm_int8.py quant_lstm_layer, which it equals bit for bit;
ops/lstm_int8.py quant_lstm_layer_op chooses between them by device.

Rank mode (tensor parallelism): ``quant_lstm_rank_step_cuda`` launches
one step of one model rank's units (its weight slice, parallel/mesh.py
rank_weights), which stores its slice of h_t and y_t into every rank's
full-width buffers; counted apart, in
``quant_lstm_rank_step_cuda.launches``.  Its plain twin is ops/lstm_int8.py
quant_lstm_rank_step; ops/lstm_int8.py quant_lstm_layer_tp runs a layer
of them on every rank.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "quant_lstm"
U = 8  # hidden units per block the kernel is built for


def _pad64(k: int) -> int:
    return -(-k // 64) * 64


@functools.lru_cache(maxsize=64)
def plan(H: int, IC: int, N: int, sms: int, Hl: int = 0) -> int:
    """The least shared bytes per block for H hidden units, IC inputs and N
    lanes on a card with ``sms`` SMs: H / U blocks, one to an SM (the
    kernel's staging ring then takes the rest of shared memory); a rank
    computing Hl of the H units (rank mode): Hl / U blocks.  Raises
    ValueError for a shape the kernel cannot take."""
    Hl = Hl or H
    if H <= 0 or IC <= 0 or H % 16 or IC % 16:
        raise ValueError(
            f"kernel A copies rows in 16-byte pieces: H and IC must be multiples of 16, "
            f"got H={H} IC={IC}")
    if Hl <= 0 or Hl % U:
        raise ValueError(f"kernel A: a rank's {Hl} units are not a whole number of "
                         f"{U}-unit blocks")
    if Hl // U > sms:
        raise ValueError(f"kernel A: H={Hl} needs {Hl // U} blocks, the card has {sms} SMs")
    smem = ((_pad64(IC) + _pad64(H)) * 4 * U + -(-N * U // 4) * 16
            + cuda_build.ring_min_bytes(torch.int8))
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


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_quant_lstm_layer.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rnnt_quant_lstm_layer.argtypes = [p] * 10 + [i] * 4 + [f] * 3 + [i, p]
        lib.rnnt_quant_lstm_layer.restype = ctypes.c_int
        lib.rnnt_quant_lstm_rank_step.argtypes = [p] * 7 + [i] * 6 + [f] * 3 + [i, p]
        lib.rnnt_quant_lstm_rank_step.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _scratch(dev: torch.device, stream: int, N: int, H: int):
    """Kernel A's scratch for one stream and shape, made once and reused by
    every launch: the ping-pong h {2, N, H} int8 and the grid barrier's
    word (zeroed here; every launch leaves its count at zero)."""
    hbuf = torch.empty((2, N, H), dtype=torch.int8, device=dev)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)
    return hbuf, bar


def quant_lstm_layer_cuda(
    layer, x_i8: torch.Tensor, h_i8: torch.Tensor, c: torch.Tensor, emit_f32: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 LSTM layer over x_i8 {T, N, IC} on the card, in one launch.
    Returns (y {T,N,H} int8 or f32, hT int8, cT f32).  A shape the kernel
    cannot take raises ValueError before any launch; a refused launch
    raises RuntimeError."""
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
        return y, h_i8.clone(), c.clone()
    plan(H, IC, N, cuda_build.sm_count(dev))
    w_op, bias, rb, in_scale, out_scale = kernel_operands(layer)
    cuda_build.require(w_op, "w_op", torch.int8, (H // U, (_pad64(IC) + _pad64(H)) * 4 * U))
    cuda_build.require(bias, "bias", torch.float32, (4 * H,))
    if w_op.device != dev:
        raise ValueError(f"kernel A: weights on {w_op.device}, x on {dev}")
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        hbuf, bar = _scratch(dev, stream, N, H)
        hT = torch.empty((N, H), dtype=torch.int8, device=dev)
        cT = torch.empty((N, H), dtype=torch.float32, device=dev)
        err = lib.rnnt_quant_lstm_layer(
            x_i8.data_ptr(), w_op.data_ptr(), bias.data_ptr(), h_i8.data_ptr(), c.data_ptr(),
            y.data_ptr(), hT.data_ptr(), cT.data_ptr(), hbuf.data_ptr(), bar.data_ptr(),
            T, N, IC, H, rb, in_scale, out_scale, int(emit_f32), stream,
        )
    cuda_build.check(lib, err, "quant_lstm kernel")
    quant_lstm_layer_cuda.launches += 1
    return y, hT, cT


quant_lstm_layer_cuda.launches = 0


def quant_lstm_rank_step_cuda(layer, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                              h_dests, y_dests, unit0: int, emit_f32: bool) -> None:
    """Kernel A's rank mode: one step of the model rank whose weight slice
    ``layer`` holds units [unit0, unit0 + Hl), in one launch.  x_t {N, IC}
    int8, h {N, H} int8 the full-width h_{t-1}, c {N, Hl} f32 (updated in
    place); the launch stores its slice of h_t (int8) into each of
    ``h_dests`` and of y_t (int8, or f32 with emit_f32) into each of
    ``y_dests``, {N, H} each, one per rank, this rank's first (on other
    cards: peer pointers, ops/cuda_build.py enable_peer_access).  A shape
    the kernel cannot take, a slice that is not a whole number of blocks
    or a refused launch raises."""
    N, IC = x_t.shape
    H, G = layer.w_hh.shape
    Hl = G // 4
    cuda_build.require(x_t, "x_t", torch.int8, (N, IC))
    cuda_build.require(h, "h", torch.int8, (N, H))
    cuda_build.require(c, "c", torch.float32, (N, Hl))
    if not 1 <= len(h_dests) == len(y_dests) <= cuda_build.MAX_RANKS:
        raise ValueError(f"kernel A rank mode: {len(h_dests)} h and {len(y_dests)} y "
                         f"destinations, want 1 to {cuda_build.MAX_RANKS} of each")
    for d in h_dests:
        cuda_build.require(d, "h destination", torch.int8, (N, H))
    for d in y_dests:
        cuda_build.require(d, "y destination", torch.float32 if emit_f32 else torch.int8, (N, H))
    if unit0 < 0 or unit0 % U or unit0 + Hl > H:
        raise ValueError(f"kernel A rank mode: units {unit0}..{unit0 + Hl} of {H} are not "
                         f"whole {U}-unit blocks of the layer")
    if x_t.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("kernel A copies x and h rows in 16-byte pieces: align them")
    dev = x_t.device
    plan(H, IC, N, cuda_build.sm_count(dev), Hl)
    w_op, bias, rb, in_scale, out_scale = kernel_operands(layer)
    cuda_build.require(w_op, "w_op", torch.int8, (Hl // U, (_pad64(IC) + _pad64(H)) * 4 * U))
    if w_op.device != dev or h_dests[0].device != dev:
        raise ValueError(f"kernel A rank mode: weights on {w_op.device}, own h on "
                         f"{h_dests[0].device}, x on {dev}")
    lib = _lib()
    if N == 0:
        return
    with torch.cuda.device(dev):  # the C side launches on the current device
        cuda_build.enable_peer_access([d.device for d in (*h_dests, *y_dests)], lib)
        err = lib.rnnt_quant_lstm_rank_step(
            x_t.data_ptr(), w_op.data_ptr(), bias.data_ptr(), h.data_ptr(), c.data_ptr(),
            cuda_build.pointers(h_dests), cuda_build.pointers(y_dests), len(h_dests),
            N, IC, H, Hl, unit0, rb, in_scale, out_scale, int(emit_f32),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "quant_lstm rank step")
    quant_lstm_rank_step_cuda.launches += 1


quant_lstm_rank_step_cuda.launches = 0
