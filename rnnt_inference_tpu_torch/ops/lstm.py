"""Float LSTM as plain PyTorch ops (counterpart of rnnt_inference_tpu/ops/lstm.py).

The input projection ``x @ W_ih + b`` of a whole (T, N) chunk is hoisted out
of the recurrence into one product; only ``h @ W_hh`` and the gate math run
per step.  Products take their operands in the weights' dtype and sum in
f32.  The projection of bf16 operands on the card runs kernel E
(ops/projection_cuda.py: bf16 tensor-core products, f32 sums, the bias and
the one rounding to bf16 in its epilogue); elsewhere, and in the plain
twins, a product is one f32 matmul on upcast operands (``dot_f32``; a
product of two bf16 values is exact in f32).  The cell state is f32.

The recurrence runs kernel C (ops/lstm_scan_cuda.py, the counterpart of
the JAX package's Pallas _lstm_scan_kernel) on CUDA tensors; its plain twin
``lstm_recurrence`` is the counterpart of the default XLA scan, and runs on
CPU tensors or when impl="reference" is asked for.  The float encoder (run
modes f32 and bf16) and calibration go through here; the int8 serving path
runs ops/lstm_int8.py.  The fake_quant encoder (``fake_quant_lstm_stack``)
runs here as eager PyTorch on either device.

Tensor parallelism (parallel/tensor.py): ``lstm_layer_tp`` runs one float
layer on the k model ranks of a data shard, each holding the weight slice
of H/k units (parallel/mesh.py rank_weights): each rank's projection xw
on its own columns (kernel E or its twin), then one step at a time
every rank computes its units' h_t and stores it into every rank's
full-width y_t, which is the next step's h; c never leaves its rank.  A
step is the plain ``lstm_rank_step``, whose exchange is a copy of the
slice into each rank's y, ordered across cards by PyTorch's copies
between devices.  Kernel C serves one card's whole grid and has no rank
mode, so on CUDA tensors the layer runs only when impl="reference" asks
for the plain steps (it raises otherwise).  The products of a column slice may sum in
another order than the full product's, so the float layer agrees with
the one-device layer to f32 rounding.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights
from rnnt_inference_tpu_torch.ops import cuda_build, lstm_scan_cuda, projection_cuda
from rnnt_inference_tpu_torch.ops.activations import gate_fns


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums (jnp.dot(..., preferred_element_type=f32)) as one
    plain f32 matmul on upcast operands: torch's bf16 matmul would round its
    result to bf16, and a product of two bf16 values is exact in f32.  The
    plain twins (kernel C's recurrence, kernel B's iteration, the reference
    joint) use it; the main path's large products call
    projection_cuda.project, which runs bf16 operands on the card on kernel
    E and takes this same formula elsewhere."""
    return torch.matmul(a.float(), b.float())


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
    """One LSTM layer over a (T, N, IC) chunk: the hoisted projection xw =
    x @ W_ih + b, summed in f32 and stored in the compute dtype (kernel E on
    bf16 CUDA tensors), then the recurrence (kernel C on CUDA tensors); both
    plain twins on CPU tensors or when impl="reference".
    Returns (y {T,N,H} in the weights' dtype, h {N,H}, c {N,H} f32)."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    compute_dtype = layer.w_ih.dtype
    xw = projection_cuda.project(x.to(compute_dtype), layer.w_ih, layer.b, impl)
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


def lstm_rank_step(layer: LSTMLayerWeights, xw_t: torch.Tensor, h: torch.Tensor,
                   c: torch.Tensor, y_dests, unit0: int) -> None:
    """One step of the model rank whose weight slice ``layer`` (W_hh
    {H, 4Hl}) holds units [unit0, unit0 + Hl), in plain PyTorch: the cell
    on xw_t {N, 4Hl} and the full-width h {N, H}; h_t's slice (in the
    compute dtype) copied into each of ``y_dests``' columns ({N, H}, one
    per rank, on any device), c {N, Hl} f32 updated in place."""
    h_new, c_new = lstm_cell(xw_t, h, c, layer.w_hh)
    h_new = h_new.to(layer.w_hh.dtype)
    cols = slice(unit0, unit0 + c.shape[1])
    for d in y_dests:
        d[:, cols] = h_new.to(d.device)
    c.copy_(c_new)


def lstm_layer_tp(
    layers: Sequence[LSTMLayerWeights],
    x: Sequence[torch.Tensor],
    h0: Sequence[torch.Tensor],
    c0: Sequence[torch.Tensor],
    impl: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """One float LSTM layer on k model ranks (module docstring), one list
    entry per rank, each on its device: layers[r] rank r's slice, x[r]
    {T, N, IC} and h0[r] {N, H} full width (equal on every rank), c0[r]
    {N, H/k} f32.  Returns (y {T, N, H}, hT {N, H}, cT {N, H/k}) per
    rank.  CUDA tensors need impl="reference" (ops/cuda_build.py
    plain_impl)."""
    cuda_build.plain_impl(impl, x[0], "lstm_layer_tp")
    k = len(layers)
    dt = layers[0].w_ih.dtype
    xw = [projection_cuda.project(xr.to(dt), l.w_ih, l.b, impl) for xr, l in zip(x, layers)]
    h = [hr.to(dt) for hr in h0]
    cs = [cr.float().clone().contiguous() for cr in c0]
    T, N = x[0].shape[:2]
    H = h[0].shape[1]
    y = [hr.new_empty((T, N, H)) for hr in h]
    for t in range(T):
        for r in range(k):
            lstm_rank_step(layers[r], xw[r][t], h[r] if t == 0 else y[r][t - 1], cs[r],
                           [yr[t] for yr in y], r * (H // k))
    return y, [yr[T - 1] if T else hr for yr, hr in zip(y, h)], cs


def lstm_stack_tp(
    layers: Sequence[Sequence[LSTMLayerWeights]],
    x: Sequence[torch.Tensor],
    hs: Sequence[torch.Tensor],
    cs: Sequence[torch.Tensor],
    impl: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """``lstm_stack`` on k model ranks: layers[r] rank r's slices of the
    stack; hs[r] (L, N, H), cs[r] (L, N, H/k).  Returns per rank (y, h,
    c)."""
    k = len(layers)
    new_h, new_c = [[] for _ in range(k)], [[] for _ in range(k)]
    y = list(x)
    for l in range(len(layers[0])):
        y, h, c = lstm_layer_tp([lr[l] for lr in layers], y, [t[l] for t in hs],
                                [t[l] for t in cs], impl)
        for r in range(k):
            new_h[r].append(h[r])
            new_c[r].append(c[r])
    return y, [torch.stack(t) for t in new_h], [torch.stack(t) for t in new_c]


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
