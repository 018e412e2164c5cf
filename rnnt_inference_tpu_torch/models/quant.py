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
from rnnt_inference_tpu_torch.ops.lstm import lstm_layer, stack_time

MAX_BOUND = 127.0
MIN_BOUND = -128.0


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
    w_scale = MAX_BOUND / w_amax
    in_scale = MAX_BOUND / act_amax.float()
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
    pre_in = [MAX_BOUND / a for a in calib.pre_amax]
    post_in = [MAX_BOUND / a for a in calib.post_amax]
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
