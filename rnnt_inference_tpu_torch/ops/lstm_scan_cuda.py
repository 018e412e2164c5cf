"""Kernel C: the float (f32 / bf16) LSTM recurrence in CUDA C++
(csrc/lstm_scan.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_lstm_scan_kernel.
``lstm_recurrence_cuda`` launches it on PyTorch's current stream: one
cooperative launch per call, all T steps inside, H / U blocks that each
keep U hidden units' W_hh columns in shared memory (``plan``,
``recurrent_weight``).  Every launch is counted in
``lstm_recurrence_cuda.launches``.  Its plain twin is ops/lstm.py
lstm_recurrence; ops/lstm.py lstm_layer chooses between them by device.

Rank mode (tensor parallelism): ``lstm_rank_step_cuda`` launches one step
of one model rank's units (its W_hh slice, parallel/mesh.py
rank_weights) with the one-card plan's U, storing its slice of h_t into
every rank's full-width y_t; counted apart, in
``lstm_rank_step_cuda.launches``.  Its plain twin is ops/lstm.py
lstm_rank_step; ops/lstm.py lstm_layer_tp runs a layer of them on every
rank.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "lstm_scan"
U = 8  # hidden units per block the kernel is built for


def plan(H: int, N: int, dtype: torch.dtype, sms: int) -> Tuple[int, int]:
    """(U, least shared bytes per block) for H hidden units and N lanes on a
    card with ``sms`` SMs: H / U blocks, one to an SM (the kernel's staging
    ring then takes the rest of shared memory).  Raises ValueError for a
    shape the kernel cannot take."""
    if H <= 0 or H % 128:
        raise ValueError(f"kernel C needs H a multiple of 128, got H={H}")
    if H // U > sms:
        raise ValueError(f"kernel C: H={H} needs {H // U} blocks, the card has {sms} SMs")
    es = 2 if dtype == torch.bfloat16 else 4
    smem = H * 4 * U * es + cuda_build.ring_min_bytes(dtype) + -(-N * U // 4) * 16
    if smem > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(
            f"kernel C: N={N} lanes at H={H} need {smem} bytes of shared memory "
            f"per block, more than {cuda_build.SMEM_PER_BLOCK}"
        )
    return U, smem


def recurrent_weight(layer, U: int) -> torch.Tensor:
    """W_hh {H, 4H} of an LSTMLayerWeights in the kernel's per-block order
    (cuda_build.block_columns: {H / U, H, 4U}, in bf16 in mma fragment
    order), kept until the layer is freed and made again if W_hh changes."""
    return cuda_build.cached_operands(
        layer, f"{NAME}/U{U}", (layer.w_hh,), lambda: cuda_build.block_columns(layer.w_hh, U)
    )


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_lstm_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lstm_scan.argtypes = [i, i] + [p] * 7 + [i] * 3 + [p]
        lib.rnnt_lstm_scan.restype = ctypes.c_int
        lib.rnnt_lstm_scan_rank_step.argtypes = [i, i] + [p] * 5 + [i] * 5 + [p]
        lib.rnnt_lstm_scan_rank_step.restype = ctypes.c_int
    return lib


def lstm_recurrence_cuda(
    layer, xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence of one float LSTM layer on the card, given
    xw = x @ W_ih + b {T, N, 4H} in the compute dtype (the layer's).
    h0 {N, H} compute dtype, c0 {N, H} f32.  Returns (y {T,N,H}, hT, cT f32).
    A refused cooperative launch raises."""
    dt = layer.w_hh.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel C takes bf16 or f32 weights, got {dt}")
    T, N, G = xw.shape
    H = layer.w_hh.shape[0]
    if G != 4 * H:
        raise ValueError(f"kernel C needs xw (T, N, 4H), got {tuple(xw.shape)} for H={H}")
    xw, h0, c0 = xw.contiguous(), h0.contiguous(), c0.contiguous()
    cuda_build.require(xw, "xw", dt, (T, N, 4 * H))
    cuda_build.require(h0, "h0", dt, (N, H))
    cuda_build.require(c0, "c0", torch.float32, (N, H))
    if h0.data_ptr() % 16:
        raise ValueError("kernel C copies h0 rows in 16-byte pieces: align it")
    dev = xw.device
    y = torch.empty((T, N, H), dtype=dt, device=dev)
    if T == 0 or N == 0:
        return y, h0.clone(), c0.clone()
    plan(H, N, dt, cuda_build.sm_count(dev))
    w_op = recurrent_weight(layer, U)
    cuda_build.require(w_op, "w_hh operand", dt, w_op.shape)
    if w_op.device != dev:
        raise ValueError(f"kernel C: W_hh on {w_op.device}, xw on {dev}")
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        hT = torch.empty((N, H), dtype=dt, device=dev)
        cT = torch.empty((N, H), dtype=torch.float32, device=dev)
        err = lib.rnnt_lstm_scan(
            int(dt == torch.bfloat16), U, xw.data_ptr(), w_op.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, N, H,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "lstm_scan kernel")
    lstm_recurrence_cuda.launches += 1
    return y, hT, cT


lstm_recurrence_cuda.launches = 0


def lstm_rank_step_cuda(layer, xw_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, y_dests,
                        unit0: int) -> None:
    """Kernel C's rank mode: one step of the model rank whose weight slice
    ``layer`` (W_hh {H, 4Hl}) holds units [unit0, unit0 + Hl), in one
    launch of Hl / U blocks (U of the one-card plan).  xw_t {N, 4Hl} the
    rank's columns of x.W_ih + b, h {N, H} the full-width h_{t-1}, both in
    the compute dtype; c {N, Hl} f32 (updated in place); the launch stores
    its slice of h_t into each of ``y_dests`` ({N, H}, one per rank, this
    rank's first; peer pointers across cards).  A shape the kernel cannot
    take, a slice that is not a whole number of blocks or a refused launch
    raises."""
    dt = layer.w_hh.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel C takes bf16 or f32 weights, got {dt}")
    N = xw_t.shape[0]
    H, G = layer.w_hh.shape
    Hl = G // 4
    cuda_build.require(xw_t, "xw_t", dt, (N, 4 * Hl))
    cuda_build.require(h, "h", dt, (N, H))
    cuda_build.require(c, "c", torch.float32, (N, Hl))
    if not 1 <= len(y_dests) <= cuda_build.MAX_RANKS:
        raise ValueError(f"kernel C rank mode: {len(y_dests)} destinations, want 1 to "
                         f"{cuda_build.MAX_RANKS}")
    for d in y_dests:
        cuda_build.require(d, "y destination", dt, (N, H))
    if Hl <= 0 or Hl % U or unit0 < 0 or unit0 % U or unit0 + Hl > H:
        raise ValueError(f"kernel C rank mode: units {unit0}..{unit0 + Hl} of {H} are not "
                         f"whole {U}-unit blocks of the layer")
    if h.data_ptr() % 16:
        raise ValueError("kernel C copies h rows in 16-byte pieces: align it")
    dev = xw_t.device
    plan(H, N, dt, cuda_build.sm_count(dev))
    if Hl // U > cuda_build.sm_count(dev):
        raise ValueError(f"kernel C: {Hl} units need {Hl // U} blocks, more than the SMs")
    w_op = recurrent_weight(layer, U)
    cuda_build.require(w_op, "w_hh operand", dt, w_op.shape)
    if w_op.device != dev or y_dests[0].device != dev:
        raise ValueError(f"kernel C rank mode: W_hh on {w_op.device}, own y on "
                         f"{y_dests[0].device}, xw on {dev}")
    if N == 0:
        return
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        cuda_build.enable_peer_access([d.device for d in y_dests], lib)
        err = lib.rnnt_lstm_scan_rank_step(
            int(dt == torch.bfloat16), U, xw_t.data_ptr(), w_op.data_ptr(), h.data_ptr(),
            c.data_ptr(), cuda_build.pointers(y_dests), len(y_dests), N, H, Hl, unit0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "lstm_scan rank step")
    lstm_rank_step_cuda.launches += 1


lstm_rank_step_cuda.launches = 0
