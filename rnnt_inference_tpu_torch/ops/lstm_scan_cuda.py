"""Kernel C: the float (f32 / bf16) LSTM recurrence in CUDA C++
(csrc/lstm_scan.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_lstm_scan_kernel.
``lstm_recurrence_cuda`` launches it on PyTorch's current stream, one
launch per time step, and counts every launch in
``lstm_recurrence_cuda.launches``.  Its plain twin is ops/lstm.py
lstm_recurrence; ops/lstm.py lstm_layer chooses between them by device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "lstm_scan"


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_lstm_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lstm_scan.argtypes = [i] + [p] * 7 + [i] * 3 + [p]
        lib.rnnt_lstm_scan.restype = ctypes.c_int
    return lib


def recurrent_weight(layer) -> torch.Tensor:
    """W_hh of an LSTMLayerWeights transposed to contiguous (4H, H) rows, K
    contiguous for the kernel's loads; kept until the layer is freed."""
    return cuda_build.cached_operands(
        layer, NAME, (layer.w_hh,), lambda: layer.w_hh.t().contiguous()
    )


def lstm_recurrence_cuda(
    layer, xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence of one float LSTM layer on the card, given
    xw = x @ W_ih + b {T, N, 4H} in the compute dtype (the layer's).
    h0 {N, H} compute dtype, c0 {N, H} f32.  Returns (y {T,N,H}, hT, cT f32)."""
    dt = layer.w_hh.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel C takes bf16 or f32 weights, got {dt}")
    T, N, G = xw.shape
    H = layer.w_hh.shape[0]
    if G != 4 * H or H % 8:
        raise ValueError(f"kernel C needs xw (T, N, 4H) and H % 8 == 0, got {tuple(xw.shape)}")
    w_t = recurrent_weight(layer)
    xw, h0, c0 = xw.contiguous(), h0.contiguous(), c0.contiguous()
    cuda_build.require(xw, "xw", dt, (T, N, 4 * H))
    cuda_build.require(h0, "h0", dt, (N, H))
    cuda_build.require(c0, "c0", torch.float32, (N, H))
    cuda_build.require(w_t, "w_hh_t", dt, (4 * H, H))
    dev = xw.device
    y = torch.empty((T, N, H), dtype=dt, device=dev)
    if T == 0 or N == 0:
        return y, h0.clone(), c0.clone()
    hT = torch.empty((N, H), dtype=dt, device=dev)
    cT = torch.empty((N, H), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.rnnt_lstm_scan(
        int(dt == torch.bfloat16), xw.data_ptr(), w_t.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, N, H,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "lstm_scan kernel")
    lstm_recurrence_cuda.launches += T
    return y, hT, cT


lstm_recurrence_cuda.launches = 0
