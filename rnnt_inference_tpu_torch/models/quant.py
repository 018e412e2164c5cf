"""Int8 quantization: calibration, weight quantization, scale propagation
(counterpart of rnnt_inference_tpu/models/quant.py).

  - symmetric per-tensor int8: scale = 127 / amax; round half to even, then
    clamp to [-128, 127]
  - activation amax per encoder layer: running max of |cat(x_t, h_{t-1})|
    over valid calibration frames (x and h share one scale)
  - weight amax per layer over |cat(w_ih, w_hh)|
  - out_scale[l] = in_scale[l+1], across StackTime too (the last pre layer
    takes the first post layer's in_scale); the last post layer emits f32,
    marked by the sentinel out_scale = 0
  - the prediction net, embedding and joint are cast to bf16

and, as in the JAX package, the iLinear quantized linear (dormant: no
serving path uses it) and the fake_quant model (FakeQuantRNNTWeights).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models.weights import (
    LSTMLayerWeights,
    RNNTWeights,
    map_tensors,
)
from rnnt_inference_tpu_torch.ops.lstm import dot_f32, lstm_layer, stack_time

MAX_BOUND = 127.0
MIN_BOUND = -128.0


def scale_for(amax: torch.Tensor) -> torch.Tensor:
    """127 / amax, as one f32 division.  (torch's ``scalar / tensor``
    multiplies by the reciprocal, which rounds twice and can land one ulp
    from the JAX package's scale.)"""
    amax = amax.float()
    return torch.full_like(amax, MAX_BOUND) / amax


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """round(x*scale) (half to even) clamped to [-128, 127] -> int8."""
    return torch.clamp(torch.round(x * scale), MIN_BOUND, MAX_BOUND).to(torch.int8)


@dataclasses.dataclass
class QuantLSTMLayerWeights:
    """One int8 LSTM layer.

    w_ih int8 (IC, 4H); w_hh int8 (H, 4H); b f32 (4H,) = b_ih + b_hh, added
    in the float domain after dequantization.  in_scale: the x/h shared
    scale; w_scale: the weight scale; out_scale: the next layer's in_scale
    (0 marks the f32-emitting last layer).  Scales are 0-d f32 tensors.
    """

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b: torch.Tensor
    in_scale: torch.Tensor
    w_scale: torch.Tensor
    out_scale: torch.Tensor

    @property
    def rb_scale(self) -> torch.Tensor:
        return 1.0 / (self.in_scale * self.w_scale)


@dataclasses.dataclass
class QuantRNNTWeights:
    """Int8 encoder, bf16 prediction net and joint."""

    pre_rnn: List[QuantLSTMLayerWeights]
    post_rnn: List[QuantLSTMLayerWeights]
    embed: torch.Tensor
    pred_rnn: List[LSTMLayerWeights]
    joint: object  # JointWeights

    def to(self, device=None) -> "QuantRNNTWeights":
        return map_tensors(self, lambda t: t.to(device=device))


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CalibState:
    """Running amax per encoder LSTM layer: pre (2) + post (3)."""

    pre_amax: torch.Tensor  # (PRE_L,)
    post_amax: torch.Tensor  # (POST_L,)


def init_calib_state(params: RNNTParams = RNNTParams(), device="cuda") -> CalibState:
    return CalibState(
        pre_amax=torch.zeros((params.pre_num_layers,), device=device),
        post_amax=torch.zeros((params.post_num_layers,), device=device),
    )


def _layer_amax(
    x: torch.Tensor, x_lens: torch.Tensor, h0: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """max |cat(x_t, h_{t-1})| over valid timesteps: the quantizer sees
    h_0 .. h_{T-1}; padded timesteps (t >= x_lens) are excluded."""
    T = x.shape[0]
    valid = (torch.arange(T, device=x.device)[:, None] < x_lens[None, :])[:, :, None]
    x_amax = torch.max(torch.abs(x.float().masked_fill(~valid, 0.0)))
    h_seq = torch.cat([h0[None].to(ys.dtype), ys[:-1]], dim=0)
    h_amax = torch.max(torch.abs(h_seq.float().masked_fill(~valid, 0.0)))
    return torch.maximum(x_amax, h_amax)


def calibrate_batch(
    weights: RNNTWeights,
    x: torch.Tensor,
    x_lens: torch.Tensor,
    calib: CalibState,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
) -> CalibState:
    """One calibration step: float encoder forward over whole utterances with
    zero initial state, recording the activation amax of every layer
    (kernel C on CUDA tensors; impl="reference" takes its plain twin)."""
    N = x.shape[1]
    H = params.trans_hidden_size
    dev = x.device
    x_lens = x_lens.to(dev)
    pre_amax = list(calib.pre_amax)
    post_amax = list(calib.post_amax)

    y = x
    for l, layer in enumerate(weights.pre_rnn):
        h0 = torch.zeros((N, H), device=dev)
        ys, _, _ = lstm_layer(layer, y, h0, torch.zeros((N, H), device=dev), impl)
        pre_amax[l] = torch.maximum(calib.pre_amax[l], _layer_amax(y, x_lens, h0, ys))
        y = ys

    y = stack_time(y, x_lens, params.stack_time_factor)
    y_lens = -(-x_lens // params.stack_time_factor)
    for l, layer in enumerate(weights.post_rnn):
        h0 = torch.zeros((N, H), device=dev)
        ys, _, _ = lstm_layer(layer, y, h0, torch.zeros((N, H), device=dev), impl)
        post_amax[l] = torch.maximum(calib.post_amax[l], _layer_amax(y, y_lens, h0, ys))
        y = ys
    return CalibState(pre_amax=torch.stack(pre_amax), post_amax=torch.stack(post_amax))


def calibrate(
    weights: RNNTWeights,
    batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
) -> CalibState:
    """Run the whole calibration set: a list of (x {T,N,C}, x_lens {N})."""
    device = weights.embed.device
    calib = init_calib_state(params, device)
    with torch.no_grad():
        for x, x_lens in batches:
            calib = calibrate_batch(
                weights, torch.as_tensor(x, device=device).float(),
                torch.as_tensor(x_lens, device=device), calib, params, impl,
            )
    return calib


# ---------------------------------------------------------------------------
# Weight quantization + scale propagation
# ---------------------------------------------------------------------------


def quantize_lstm_layer(
    layer: LSTMLayerWeights, act_amax: torch.Tensor, out_scale: torch.Tensor
) -> QuantLSTMLayerWeights:
    w_amax = torch.max(torch.abs(torch.cat([layer.w_ih, layer.w_hh], dim=0))).float()
    w_scale = scale_for(w_amax)
    in_scale = scale_for(act_amax)
    return QuantLSTMLayerWeights(
        w_ih=quantize(layer.w_ih.float(), w_scale),
        w_hh=quantize(layer.w_hh.float(), w_scale),
        b=layer.b.float(),
        in_scale=in_scale.float(),
        w_scale=w_scale.float(),
        out_scale=torch.as_tensor(out_scale, dtype=torch.float32, device=layer.b.device),
    )


def quantize_weights(
    weights: RNNTWeights,
    calib: CalibState,
    params: RNNTParams = RNNTParams(),
    compute_dtype: torch.dtype = torch.bfloat16,
) -> QuantRNNTWeights:
    """The int8 model with propagated scales; the prediction net, embedding
    and joint are cast to ``compute_dtype``."""
    pre_in = [scale_for(a) for a in calib.pre_amax]
    post_in = [scale_for(a) for a in calib.post_amax]
    # out_scale[l] = in_scale[l+1]; pre[-1] ties across StackTime to post[0];
    # post[-1] emits f32 (sentinel 0.0)
    pre_out = pre_in[1:] + [post_in[0]]
    post_out = post_in[1:] + [torch.zeros((), device=calib.post_amax.device)]
    pre = [
        quantize_lstm_layer(l, calib.pre_amax[i], pre_out[i])
        for i, l in enumerate(weights.pre_rnn)
    ]
    post = [
        quantize_lstm_layer(l, calib.post_amax[i], post_out[i])
        for i, l in enumerate(weights.post_rnn)
    ]
    cast = lambda t: map_tensors(t, lambda a: a.to(compute_dtype))
    return QuantRNNTWeights(
        pre_rnn=pre,
        post_rnn=post,
        embed=cast(weights.embed),
        pred_rnn=cast(weights.pred_rnn),
        joint=cast(weights.joint),
    )


# ---------------------------------------------------------------------------
# Quantized linear (iLinear) and the fake_quant model
# ---------------------------------------------------------------------------
#
# As in the JAX package, iLinear exists with the reference's semantics
# (per-tensor int8 weight, calibrated per-tensor input scale, int32
# products, o_scale dequantization) and a joint wiring helper, but nothing
# on the serving path uses it.


def _fake_quant(v: torch.Tensor, scale) -> torch.Tensor:
    """clip(round(v*s), -128, 127) / s in f32: quantize, then dequantize by
    a division (the JAX expression, not a multiply by 1/s)."""
    return torch.clamp(torch.round(v * scale), MIN_BOUND, MAX_BOUND) / scale


@dataclasses.dataclass
class QuantLinearWeights:
    """int8 linear: y = q(x) @ w_i8 * o_scale + b.

    w_i8 int8 (IN, OUT), in the x @ W layout; b f32 (OUT,) in the float
    domain; in_scale, w_scale 0-d f32."""

    w_i8: torch.Tensor
    b: torch.Tensor
    in_scale: torch.Tensor
    w_scale: torch.Tensor

    @property
    def o_scale(self) -> torch.Tensor:
        return 1.0 / (self.in_scale * self.w_scale)


def quantize_linear(
    w: torch.Tensor, b: torch.Tensor, act_amax: torch.Tensor
) -> QuantLinearWeights:
    """w_scale = 127 / max|W| per tensor, in_scale = 127 / act_amax."""
    w_scale = scale_for(torch.max(torch.abs(w.float())))
    return QuantLinearWeights(
        w_i8=quantize(w.float(), w_scale),
        b=b.float(),
        in_scale=scale_for(torch.as_tensor(act_amax, device=w.device)),
        w_scale=w_scale,
    )


def quant_linear_apply(ql: QuantLinearWeights, x: torch.Tensor) -> torch.Tensor:
    """Quantize x with the calibrated scale, int8 x int8 products summed
    exactly (in f64, which holds any int32 sum of these products, on either
    device), dequantize with o_scale, add the bias.  Returns f32."""
    x_i8 = quantize(x.float(), ql.in_scale)
    acc = torch.matmul(x_i8.double(), ql.w_i8.double()).float()
    return acc * ql.o_scale + ql.b


def fake_quant_linear_apply(
    w: torch.Tensor, b: torch.Tensor, act_amax: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Weight and activation quantize-dequantized in f32, then an f32 GEMM."""
    w_scale = scale_for(torch.max(torch.abs(w)))
    in_scale = scale_for(torch.as_tensor(act_amax, device=w.device))
    return torch.matmul(_fake_quant(x, in_scale), _fake_quant(w, w_scale)) + b


def quantize_joint_fc1_trans(weights, act_amax: torch.Tensor) -> QuantLinearWeights:
    """The joint's transcription-side fc1 as iLinear (zero bias; the joint
    adds b1 once).  act_amax calibrates over the encoder output f."""
    w = weights.joint.w1_trans.float()
    return quantize_linear(w, torch.zeros((w.shape[1],), device=w.device), act_amax)


def joint_quant_fc1(weights, ql: QuantLinearWeights, f: torch.Tensor, g: torch.Tensor):
    """The joint with its transcription-side fc1 in int8; the prediction
    side, bias, relu and fc2 as in ``rnnt.joint``."""
    w = weights.joint
    y = quant_linear_apply(ql, f) + dot_f32(g.to(w.w1_pred.dtype), w.w1_pred) + w.b1.float()
    y = torch.clamp(y, min=0.0).to(w.w2.dtype)
    return dot_f32(y, w.w2) + w.b2.float()


@dataclasses.dataclass
class FakeQuantRNNTWeights:
    """The fake_quant run mode: f32 execution with int8 rounding simulated
    where the int8 path rounds.  Encoder weights are quantize-dequantized
    at build time; at every step the layer's input pair cat(x_t, h_{t-1})
    is quantize-dequantized with the layer's calibrated scale
    (ops/lstm.py fake_quant_lstm_stack).  Prediction net and joint stay
    f32 (kernel B's f32 instantiation on the card)."""

    pre_rnn: List[LSTMLayerWeights]  # weights already fake-quantized
    post_rnn: List[LSTMLayerWeights]
    pre_in_scale: torch.Tensor  # (PRE_L,) 127 / act_amax per layer
    post_in_scale: torch.Tensor  # (POST_L,)
    embed: torch.Tensor
    pred_rnn: List[LSTMLayerWeights]
    joint: object  # JointWeights

    def to(self, device=None) -> "FakeQuantRNNTWeights":
        return map_tensors(self, lambda t: t.to(device=device))


def fake_quantize_weights(
    weights: RNNTWeights,
    calib: CalibState,
    params: RNNTParams = RNNTParams(),
) -> FakeQuantRNNTWeights:
    """The fake_quant model from f32 weights: encoder weights fake-quantized
    with the amax of cat(w_ih, w_hh) per layer, and the calibrated
    activation scales of the per-step fake quantization."""

    def fq_layer(layer: LSTMLayerWeights) -> LSTMLayerWeights:
        scale = scale_for(torch.max(torch.abs(torch.cat([layer.w_ih, layer.w_hh], dim=0))))
        return LSTMLayerWeights(w_ih=_fake_quant(layer.w_ih, scale),
                                w_hh=_fake_quant(layer.w_hh, scale), b=layer.b)

    return FakeQuantRNNTWeights(
        pre_rnn=[fq_layer(l) for l in weights.pre_rnn],
        post_rnn=[fq_layer(l) for l in weights.post_rnn],
        pre_in_scale=scale_for(calib.pre_amax),
        post_in_scale=scale_for(calib.post_amax),
        embed=weights.embed,
        pred_rnn=weights.pred_rnn,
        joint=weights.joint,
    )
