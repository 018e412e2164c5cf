"""Int8 LSTM execution path (counterpart of rnnt_inference_tpu/ops/lstm_int8.py).

Per layer and step:
  gates = float(x_t_i8 @ Wih_i8 + h_i8 @ Whh_i8) * rb_scale + (b_ih + b_hh)
  i, f, g, o activations and the cell in f32;
  h re-quantized with the layer's own in_scale (x and h share it);
  y quantized with out_scale (the next layer's in_scale), or f32 for the
  last post layer.

``quant_lstm_layer`` is the plain PyTorch twin of kernel A
(ops/lstm_cuda.py, csrc/quant_lstm.cu).  ``quant_lstm_layer_op`` is the
wrapper the stack calls: CPU tensors take the twin, CUDA tensors launch the
kernel (or the twin when ``impl="reference"`` is asked for explicitly).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rnnt_inference_tpu_torch.models.quant import QuantLSTMLayerWeights, quantize
from rnnt_inference_tpu_torch.ops import lstm_cuda


def int_dot(a_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> exact integer products summed over the last axis of a.

    torch's int8 matmul returns int8 (and overflows), so the operands go to
    float64: every partial sum (|sum| <= K * 128 * 128 < 2**53) is an exact
    integer there, whatever the summation order."""
    return torch.matmul(a_i8.double(), w_i8.double())


def quant_lstm_layer(
    layer: QuantLSTMLayerWeights,
    x_i8: torch.Tensor,
    h_i8: torch.Tensor,
    c: torch.Tensor,
    emit_f32: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 LSTM layer over a chunk, in plain PyTorch (kernel A's twin).

    x_i8 {T, N, IC} int8; h_i8 {N, H} int8; c {N, H} f32.
    Returns (y {T,N,H} int8 or f32, h' int8, c' f32).
    """
    rb = layer.rb_scale
    xw = int_dot(x_i8, layer.w_ih)  # hoisted input projection, exact
    w_hh = layer.w_hh.double()  # int_dot's operand, converted once per chunk
    h, c = h_i8, c.float()
    ys = []
    for t in range(x_i8.shape[0]):
        acc = (xw[t] + torch.matmul(h.double(), w_hh)).float()
        gates = acc * rb + layer.b
        i, f, g, o = gates.chunk(4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c = f * c + i * g
        h_f = o * torch.tanh(c)
        h = quantize(h_f, layer.in_scale)
        ys.append(h_f if emit_f32 else quantize(h_f, layer.out_scale))
    if not ys:
        H = layer.w_hh.shape[0]
        dt = torch.float32 if emit_f32 else torch.int8
        return x_i8.new_zeros((0, x_i8.shape[1], H), dtype=dt), h, c
    return torch.stack(ys), h, c


def quant_lstm_layer_op(
    layer: QuantLSTMLayerWeights,
    x_i8: torch.Tensor,
    h_i8: torch.Tensor,
    c: torch.Tensor,
    emit_f32: bool,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A's wrapper: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors or when impl="reference"."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "reference" or not x_i8.is_cuda:
        return quant_lstm_layer(layer, x_i8, h_i8, c, emit_f32)
    return lstm_cuda.quant_lstm_layer_cuda(layer, x_i8, h_i8, c, emit_f32)


def quant_lstm_stack(
    layers: Sequence[QuantLSTMLayerWeights],
    x: torch.Tensor,
    hs_i8: torch.Tensor,
    cs: torch.Tensor,
    skip_quant_y: bool,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer int8 LSTM.  x: int8 {T,N,C}, or float (then quantized
    here with layer 0's in_scale).  The last layer emits f32 when
    skip_quant_y.  hs_i8/cs are stacked (L, N, H)."""
    if x.dtype != torch.int8:
        x = quantize(x.float(), layers[0].in_scale)
    new_h, new_c = [], []
    y = x
    for l, layer in enumerate(layers):
        emit_f32 = skip_quant_y and l == len(layers) - 1
        y, h, c = quant_lstm_layer_op(layer, y, hs_i8[l], cs[l], emit_f32, impl)
        new_h.append(h)
        new_c.append(c)
    return y, torch.stack(new_h), torch.stack(new_c)
