"""RNN-T model functions: transcription (encoder), prediction, joint
(counterpart of rnnt_inference_tpu/models/rnnt.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models.quant import FakeQuantRNNTWeights, QuantRNNTWeights
from rnnt_inference_tpu_torch.ops.lstm import (
    dot_f32,
    fake_quant_lstm_stack,
    lstm_single_step,
    lstm_stack,
    stack_time,
)
from rnnt_inference_tpu_torch.ops.lstm_int8 import quant_lstm_stack


@dataclasses.dataclass
class EncoderState:
    """Carried LSTM state of the encoder, for chunked (streaming) operation."""

    pre_h: torch.Tensor  # (PRE_L, N, H)
    pre_c: torch.Tensor
    post_h: torch.Tensor  # (POST_L, N, H)
    post_c: torch.Tensor


def init_encoder_state(
    batch: int, params: RNNTParams = RNNTParams(), dtype=torch.float32, device="cuda"
) -> EncoderState:
    H = params.trans_hidden_size
    z = lambda L, dt: torch.zeros((L, batch, H), dtype=dt, device=device)
    return EncoderState(
        pre_h=z(params.pre_num_layers, dtype),
        pre_c=z(params.pre_num_layers, torch.float32),
        post_h=z(params.post_num_layers, dtype),
        post_c=z(params.post_num_layers, torch.float32),
    )


def transcription(
    weights,
    x: torch.Tensor,
    x_lens: torch.Tensor,
    state: EncoderState,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, EncoderState]:
    """Encoder over one chunk: pre-rnn -> stack_time -> post-rnn.

    x: {T, N, 240}, x_lens: {N} valid frames within this chunk.  Returns
    f {ceil(T/2), N, 1024} and the carried state.  QuantRNNTWeights run the
    int8 path (kernel A on CUDA tensors), FakeQuantRNNTWeights the
    fake_quant path (eager PyTorch, no kernel), float weights the float
    path (kernel C on CUDA tensors); impl="reference" takes the plain twins.
    """
    if isinstance(weights, QuantRNNTWeights):
        y, pre_h, pre_c = quant_lstm_stack(
            weights.pre_rnn, x, state.pre_h, state.pre_c, skip_quant_y=False, impl=impl
        )
        y = stack_time(y, x_lens, params.stack_time_factor)
        f, post_h, post_c = quant_lstm_stack(
            weights.post_rnn, y, state.post_h, state.post_c, skip_quant_y=True, impl=impl
        )
    elif isinstance(weights, FakeQuantRNNTWeights):
        y, pre_h, pre_c = fake_quant_lstm_stack(
            weights.pre_rnn, weights.pre_in_scale, x, state.pre_h, state.pre_c
        )
        y = stack_time(y, x_lens, params.stack_time_factor)
        f, post_h, post_c = fake_quant_lstm_stack(
            weights.post_rnn, weights.post_in_scale, y, state.post_h, state.post_c
        )
    else:
        y, pre_h, pre_c = lstm_stack(weights.pre_rnn, x, state.pre_h, state.pre_c, impl)
        y = stack_time(y, x_lens, params.stack_time_factor)
        f, post_h, post_c = lstm_stack(weights.post_rnn, y, state.post_h, state.post_c, impl)
    return f, EncoderState(pre_h=pre_h, pre_c=pre_c, post_h=post_h, post_c=post_c)


def prediction_step(
    weights,
    tokens: torch.Tensor,
    hg: torch.Tensor,
    cg: torch.Tensor,
    params: RNNTParams = RNNTParams(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prediction-net step on the last emitted symbols.  tokens (N,)
    int32; SOS (-1) embeds to the zero vector.  Returns (g {N,P}, hg', cg')."""
    sos_mask = tokens == params.SOS
    idx = torch.where(sos_mask, torch.zeros_like(tokens), tokens).long()
    emb = weights.embed[idx].masked_fill(sos_mask[:, None], 0)
    return lstm_single_step(weights.pred_rnn, emb, hg, cg)


def joint(weights, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """relu(f@W1t + g@W1p + b1) @ W2 + b2 on one (time, symbol) position per
    lane.  f (N, 1024), g (N, 320); returns f32 logits (N, 29)."""
    w = weights.joint
    y = (
        dot_f32(f.to(w.w1_trans.dtype), w.w1_trans)
        + dot_f32(g.to(w.w1_pred.dtype), w.w1_pred)
        + w.b1.float()
    )
    y = torch.clamp(y, min=0.0).to(w.w2.dtype)
    return dot_f32(y, w.w2) + w.b2.float()
