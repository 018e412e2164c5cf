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

Tensor parallelism (parallel/tensor.py): ``quant_lstm_layer_tp`` runs one
layer on the k model ranks of a data shard, each holding the weight slice
of H/k units (parallel/mesh.py rank_weights), one step at a time: every
rank computes its units' h_t and stores it into every rank's full-width
ping-pong h buffer (2, N, H), and its y_t into every rank's full-width y,
then the next step begins.  The recurrence exchanges int8 h
(``in_scale``), y keeps its own type, and c never leaves its rank.  A
step is the plain ``quant_lstm_rank_step``: the twin on the rank's
slice, whose exchange is a copy of the slice into each buffer, ordered
across cards by PyTorch's copies between devices.  Kernel A serves one
card's whole grid and has no rank mode, so on CUDA tensors the layer runs
only when impl="reference" asks for the plain steps (it raises
otherwise); the CPU tests hold it against JAX's tensor parallelism.
int8 sums are exact, so the layer's output equals the one-device layer's
bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rnnt_inference_tpu_torch.models.quant import QuantLSTMLayerWeights, quantize
from rnnt_inference_tpu_torch.ops import cuda_build, lstm_cuda


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


def quant_lstm_rank_step(layer: QuantLSTMLayerWeights, x_t: torch.Tensor, h: torch.Tensor,
                         c: torch.Tensor, h_dests, y_dests, unit0: int, emit_f32: bool) -> None:
    """One step of the model rank whose weight slice ``layer`` holds units
    [unit0, unit0 + Hl), in plain PyTorch: the twin on the slice; its h_t
    and y_t slices copied into each destination's columns ({N, H}, one per
    rank, on any device), c {N, Hl} updated in place."""
    y, h_q, c_new = quant_lstm_layer(layer, x_t[None], h, c, emit_f32)
    cols = slice(unit0, unit0 + c.shape[1])
    for d in h_dests:
        d[:, cols] = h_q.to(d.device)
    for d in y_dests:
        d[:, cols] = y[0].to(d.device)
    c.copy_(c_new)


def quant_lstm_layer_tp(
    layers: Sequence[QuantLSTMLayerWeights],
    x: Sequence[torch.Tensor],
    h: Sequence[torch.Tensor],
    c: Sequence[torch.Tensor],
    emit_f32: bool,
    impl: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """One int8 LSTM layer on k model ranks (module docstring), one list
    entry per rank, each on its device: layers[r] rank r's slice, x[r]
    {T, N, IC} int8 and h[r] {N, H} int8 full width (equal on every rank),
    c[r] {N, H/k} f32 its units' cell.  Returns (y, hT, cT) per rank: y
    {T, N, H} and hT full width, cT {N, H/k}.  CUDA tensors need
    impl="reference" (ops/cuda_build.py plain_impl)."""
    cuda_build.plain_impl(impl, x[0], "quant_lstm_layer_tp")
    k = len(layers)
    T, N, _ = x[0].shape
    H = h[0].shape[1]
    Hl = H // k
    hbuf = [hr.new_empty((2, N, H)) for hr in h]
    for r in range(k):
        hbuf[r][1].copy_(h[r])  # step 0 reads slot (0 - 1) & 1
    cs = [cr.float().clone().contiguous() for cr in c]
    y = [xr.new_empty((T, N, H), dtype=torch.float32 if emit_f32 else torch.int8) for xr in x]
    for t in range(T):
        for r in range(k):
            quant_lstm_rank_step(layers[r], x[r][t], hbuf[r][(t - 1) & 1], cs[r],
                                 [b[t & 1] for b in hbuf], [yr[t] for yr in y], r * Hl,
                                 emit_f32)
    return y, [b[(T - 1) & 1] if T else hr for b, hr in zip(hbuf, h)], cs


def quant_lstm_stack_tp(
    layers: Sequence[Sequence[QuantLSTMLayerWeights]],
    x: Sequence[torch.Tensor],
    hs_i8: Sequence[torch.Tensor],
    cs: Sequence[torch.Tensor],
    skip_quant_y: bool,
    impl: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """``quant_lstm_stack`` on k model ranks: layers[r] rank r's slices of
    the stack, x[r] its copy of the input, hs_i8[r] (L, N, H) and cs[r]
    (L, N, H/k).  Returns per rank (y full width, h (L, N, H), c (L, N,
    H/k))."""
    k = len(layers)
    y = [xr if xr.dtype == torch.int8 else quantize(xr.float(), layers[r][0].in_scale)
         for r, xr in enumerate(x)]
    new_h, new_c = [[] for _ in range(k)], [[] for _ in range(k)]
    for l in range(len(layers[0])):
        emit_f32 = skip_quant_y and l == len(layers[0]) - 1
        y, h, c = quant_lstm_layer_tp([lr[l] for lr in layers], y, [t[l] for t in hs_i8],
                                      [t[l] for t in cs], emit_f32, impl)
        for r in range(k):
            new_h[r].append(h[r])
            new_c[r].append(c[r])
    return y, [torch.stack(t) for t in new_h], [torch.stack(t) for t in new_c]
