"""Float LSTM as plain PyTorch ops (counterpart of rnnt_inference_tpu/ops/lstm.py).

The input projection ``x @ W_ih + b`` of a whole (T, N) chunk is hoisted out
of the recurrence into one matmul; only ``h @ W_hh`` and the gate math run
per step.  Matmuls take their operands in the weights' dtype and accumulate
in f32 (bf16 operands are upcast, which is exact); the cell state is f32.

The recurrence runs kernel C (ops/lstm_scan_cuda.py, the counterpart of
the JAX package's Pallas _lstm_scan_kernel) on CUDA tensors; its plain twin
``lstm_recurrence`` is the counterpart of the default XLA scan, and runs on
CPU tensors or when impl="reference" is asked for.  The float encoder (run
modes f32 and bf16) and calibration go through here; the int8 serving path
runs ops/lstm_int8.py.  The fake_quant encoder (``fake_quant_lstm_stack``)
runs here as eager PyTorch on either device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights
from rnnt_inference_tpu_torch.ops import lstm_scan_cuda
from rnnt_inference_tpu_torch.ops.activations import gate_fns


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation (jnp.dot(..., preferred_element_type=f32)).
    torch's bf16 matmul would round its result to bf16, so reduced-precision
    operands are upcast first; a product of two bf16 values is exact in f32."""
    return torch.matmul(a.float(), b.float())


def xw_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The dtype the hoisted projection xw is stored in: the compute dtype
    (accumulated in f32, then rounded once), the JAX package's default."""
    return compute_dtype


def lstm_cell(
    xw: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step given ``xw = x@W_ih + b``.  Gate order i, f, g, o.
    Returns (h', c') with c' in f32."""
    sigmoid, tanh = gate_fns()
    gates = xw + dot_f32(h, w_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    i = sigmoid(i)
    f = sigmoid(f)
    g = tanh(g)
    o = sigmoid(o)
    c_new = f * c.float() + i * g
    h_new = o * tanh(c_new)
    return h_new, c_new


def lstm_recurrence(
    xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence in plain PyTorch (kernel C's twin): xw {T, N, 4H} and
    h0 {N, H} in the compute dtype (w_hh's), c0 {N, H} f32.
    Returns (y {T,N,H}, hT, cT f32)."""
    compute_dtype = w_hh.dtype
    h, c = h0, c0
    ys = []
    for t in range(xw.shape[0]):
        h_new, c = lstm_cell(xw[t], h, c, w_hh)
        h = h_new.to(compute_dtype)
        ys.append(h)
    y = torch.stack(ys) if ys else xw.new_zeros((0,) + h.shape, dtype=compute_dtype)
    return y, h, c


def lstm_layer(
    layer: LSTMLayerWeights,
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM layer over a (T, N, IC) chunk: the hoisted projection as one
    plain product, then the recurrence (kernel C on CUDA tensors, its plain
    twin on CPU tensors or when impl="reference").
    Returns (y {T,N,H} in the weights' dtype, h {N,H}, c {N,H} f32)."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    compute_dtype = layer.w_ih.dtype
    x = x.to(compute_dtype)
    xw = (dot_f32(x, layer.w_ih) + layer.b.float()).to(xw_dtype(compute_dtype))
    h = h0.to(compute_dtype)
    c = c0.float()
    if impl == "reference" or not xw.is_cuda:
        return lstm_recurrence(xw, layer.w_hh, h, c)
    return lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, h, c)


def lstm_stack(
    layers: Sequence[LSTMLayerWeights],
    x: torch.Tensor,
    hs: torch.Tensor,
    cs: torch.Tensor,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer LSTM over a chunk; hs/cs are stacked (L, N, H)."""
    new_h, new_c = [], []
    y = x
    for l, layer in enumerate(layers):
        y, h, c = lstm_layer(layer, y, hs[l], cs[l], impl)
        new_h.append(h)
        new_c.append(c)
    return y, torch.stack(new_h), torch.stack(new_c)


def fake_quant_lstm_layer(
    layer: LSTMLayerWeights,
    in_scale: torch.Tensor,
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fake_quant LSTM layer: f32 cell math with the layer's input pair
    cat(x_t, h_{t-1}) quantize-dequantized at every step with one
    calibrated scale.  The fake quantization is elementwise with a shared
    scale, so x is fake-quantized once for the chunk and its projection
    hoisted; only fq(h) runs per step.  The carried h stays raw f32, and the
    output sequence is the raw h.  Eager PyTorch on either device, as the
    JAX package runs it as an XLA scan (no kernel)."""

    def fq(v):
        return torch.clamp(torch.round(v * in_scale), -128.0, 127.0) / in_scale

    xw = dot_f32(fq(x.float()), layer.w_ih) + layer.b.float()
    h, c = h0.float(), c0.float()
    ys = []
    for t in range(xw.shape[0]):
        h, c = lstm_cell(xw[t], fq(h), c, layer.w_hh)
        ys.append(h)
    y = torch.stack(ys) if ys else xw.new_zeros((0,) + h.shape)
    return y, h, c


def fake_quant_lstm_stack(
    layers: Sequence[LSTMLayerWeights],
    in_scales: torch.Tensor,
    x: torch.Tensor,
    hs: torch.Tensor,
    cs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer fake_quant LSTM; hs/cs are stacked (L, N, H)."""
    new_h, new_c = [], []
    y = x
    for l, layer in enumerate(layers):
        y, h, c = fake_quant_lstm_layer(layer, in_scales[l], y, hs[l], cs[l])
        new_h.append(h)
        new_c.append(c)
    return y, torch.stack(new_h), torch.stack(new_c)


def lstm_single_step(
    layers: Sequence[LSTMLayerWeights],
    x: torch.Tensor,
    hs: torch.Tensor,
    cs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One timestep through a multi-layer LSTM (the prediction net's step).
    x: (N, IC).  Returns (y {N,H}, hs', cs')."""
    new_h, new_c = [], []
    y = x
    for l, layer in enumerate(layers):
        compute_dtype = layer.w_ih.dtype
        xw = dot_f32(y.to(compute_dtype), layer.w_ih) + layer.b.float()
        h_new, c_new = lstm_cell(xw, hs[l].to(compute_dtype), cs[l], layer.w_hh)
        y = h_new.to(compute_dtype)
        new_h.append(y)
        new_c.append(c_new)
    return y, torch.stack(new_h), torch.stack(new_c)


def stack_time(x: torch.Tensor, x_lens: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Time-downsample {T,N,C} -> {ceil(T/factor),N,C*factor}, zeroing frames
    beyond each utterance's length first."""
    T, N, C = x.shape
    valid = torch.arange(T, device=x.device)[:, None] < x_lens.to(x.device)[None, :]
    x = x.masked_fill(~valid[:, :, None], 0)
    pad = (-T) % factor
    if pad:
        x = torch.cat([x, x.new_zeros((pad, N, C))], dim=0)
    Tp = x.shape[0] // factor
    # {T,N,C} -> {N,T,C} -> {N,Tp,factor*C} -> {Tp,N,factor*C}
    return x.transpose(0, 1).reshape(N, Tp, factor * C).transpose(0, 1).contiguous()
