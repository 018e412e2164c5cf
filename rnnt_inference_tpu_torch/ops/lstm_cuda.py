"""Kernel A: the int8 LSTM layer recurrence in CUDA C++ (csrc/quant_lstm.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_quant_lstm_cat_kernel.
``quant_lstm_layer_cuda`` launches it on PyTorch's current stream, one
launch per time step, and counts every launch in
``quant_lstm_layer_cuda.launches``.  Its plain twin is
ops/lstm_int8.py quant_lstm_layer; ops/lstm_int8.py quant_lstm_layer_op
chooses between them by device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "quant_lstm"


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_quant_lstm_layer.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rnnt_quant_lstm_layer.argtypes = [p] * 9 + [i] * 5 + [f] * 3 + [i, p]
        lib.rnnt_quant_lstm_layer.restype = ctypes.c_int
    return lib


def kernel_operands(layer) -> tuple:
    """(w_cat_t (4H, KP) int8, bias f32, rb, in_scale, out_scale) of a
    QuantLSTMLayerWeights: row r of w_cat_t is [W_ih[:, r]; W_hh[:, r]]
    zero-padded to KP = roundup(IC+H, 16), so K is contiguous for the
    kernel's loads.  The scales travel as the f32 values of the layer's 0-d
    tensors.  Built on the layer's first call and kept until the layer is
    freed; rebuilt if one of its tensors is replaced or changed in place."""

    def build():
        w_cat = torch.cat([layer.w_ih, layer.w_hh], dim=0)  # (K, 4H)
        K, G = w_cat.shape
        w_t = torch.zeros((G, -(-K // 16) * 16), dtype=torch.int8, device=w_cat.device)
        w_t[:, :K] = w_cat.t()
        return (
            w_t,
            layer.b.float().contiguous(),
            float(layer.rb_scale),
            float(layer.in_scale),
            float(layer.out_scale),
        )

    tensors = (layer.w_ih, layer.w_hh, layer.b, layer.in_scale, layer.w_scale, layer.out_scale)
    return cuda_build.cached_operands(layer, NAME, tensors, build)


def quant_lstm_layer_cuda(
    layer, x_i8: torch.Tensor, h_i8: torch.Tensor, c: torch.Tensor, emit_f32: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 LSTM layer over x_i8 {T, N, IC} on the card.
    Returns (y {T,N,H} int8 or f32, hT int8, cT f32)."""
    w_t, bias, rb, in_scale, out_scale = kernel_operands(layer)
    T, N, IC = x_i8.shape
    H = layer.w_hh.shape[0]
    KP = w_t.shape[1]
    if IC % 16 or H % 16:
        raise ValueError(f"kernel A needs IC and H multiples of 16, got {IC}, {H}")
    x_i8 = x_i8.contiguous()
    h_i8 = h_i8.contiguous()
    c = c.contiguous()
    cuda_build.require(x_i8, "x", torch.int8, (T, N, IC))
    cuda_build.require(h_i8, "h", torch.int8, (N, H))
    cuda_build.require(c, "c", torch.float32, (N, H))
    cuda_build.require(w_t, "w_cat_t", torch.int8, (4 * H, KP))
    if any(t.data_ptr() % 16 for t in (w_t, x_i8, h_i8)):
        raise ValueError("kernel A needs 16-byte aligned weights, x and h")
    dev = x_i8.device
    y = torch.empty((T, N, H), dtype=torch.float32 if emit_f32 else torch.int8, device=dev)
    if T == 0:
        return y, h_i8.clone(), c.clone()
    hT = torch.empty((N, H), dtype=torch.int8, device=dev)
    cT = torch.empty((N, H), dtype=torch.float32, device=dev)
    hbuf = torch.empty((2, N, H), dtype=torch.int8, device=dev)
    lib = _lib()
    err = lib.rnnt_quant_lstm_layer(
        x_i8.data_ptr(), w_t.data_ptr(), bias.data_ptr(), h_i8.data_ptr(),
        c.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), hbuf.data_ptr(),
        T, N, IC, H, KP, rb, in_scale, out_scale, int(emit_f32),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "quant_lstm kernel")
    quant_lstm_layer_cuda.launches += T
    return y, hT, cT


quant_lstm_layer_cuda.launches = 0
