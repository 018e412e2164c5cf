"""Kernel C: the float (f32 / bf16) LSTM recurrence in CUDA C++
(csrc/lstm_scan.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_lstm_scan_kernel.
``lstm_recurrence_cuda`` launches it on PyTorch's current stream: one
cooperative launch per call, all T steps inside, H / U blocks that each
keep U hidden units' W_hh columns in shared memory (``plan``,
``recurrent_weight``).  Every launch is counted in
``lstm_recurrence_cuda.launches``.  Its plain twin is ops/lstm.py
lstm_recurrence; ops/lstm.py lstm_layer chooses between them by device.

The kernel serves one card's whole grid.  Tensor parallelism (a mesh's
"model" axis, parallel/tensor.py) has no kernel: it runs the plain rank
steps of ops/lstm.py (``lstm_layer_tp``), on the card only with
impl="reference".
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

