"""NeMo's cache-aware streaming FastConformer-Transducer (Large;
config.ConformerParams with ``subsampling="dw_striding"``, causal
downsampling, ``att_context_size`` and a causal convolution module): its
weights and its streaming step, which the Server's slots run
(runtime/server.py).

The model is trained so that streaming it chunk by chunk with caches gives
exactly its full forward under the chunked-limited attention mask and the
causal convolutions (what "cache-aware" means); the step computes one chunk
of C = att_context_size[1] + 1 encoder frames for every slot:

  window     the slot's mel frames 8 C c - 14 .. 8 C c + 8 C - 8 of chunk c
             (8 C + 7 frames; zero before the utterance and from its last
             frame on): encoder frame t reads mel frames 8 t - 14 .. 8 t, so
             the subsampling needs no cache of its own, it re-reads the 14
             frames before the chunk's 8 C
  subsample  dw_striding x8, causal (three stages, each L -> L // 2 + 1;
             2 zeros before and 1 after on time and frequency):
             ReLU(CConv2d(1 -> Ch, 3x3, stride 2)), then twice
             ReLU(Conv2d(Ch -> Ch, 1x1)(CConvDW2d(Ch, 3x3, stride 2))); a
             stage's outputs outside the utterance (before its first frame,
             from its length on) are zeroed, as the full forward's padding
             reads them; (frequency, channel) rows, Linear to d_model, times
             sqrt(d_model)
  blocks     models/conformer.py's block equations, with
             MHSA  relative-position attention under the chunked-limited
                   mask: the chunk's queries against the keys and values of
                   this chunk and the ``left_chunks`` before it (kernel F's
                   streaming form), read from the layer's ring of K and V
                   rows (``StreamState.kv``: R = left_chunks + 1 chunk places
                   a slot, this chunk written into place ``pos`` first);
                   positions p = W_pos PE of R C - 1 .. -(C - 1), one band a
                   layer made with the weights (``pos_band``)
             Conv  pointwise, GLU, then the causal depthwise convolution
                   (k taps, k - 1 rows back) with its bias, LayerNorm and
                   Swish in one pass (kernel G's causal form), the first
                   k - 1 rows from the layer's cache (``StreamState.conv``),
                   which the pass replaces with its chunk's last k - 1 rows;
                   then the second pointwise product

The K/V ring holds K and V (not the LayerNorm'd inputs): a cached chunk's
projections are reused by the next R - 1 chunks, so the step projects each
row once (on an H100 at 128 slots, 15 us a block of products and ring
write against 41 us re-projecting the 84 cached rows, for twice the ring's
187 MB).  Keys of chunks before an utterance's first are masked by the
slot's chunk index, so a slot's ring needs no reset when an utterance
starts there; its convolution cache is zeroed (``reset_slots``).

Numerics as models/conformer.py: the residual stream f32, LayerNorm and
softmax statistics f32, every product's input bf16 (kernel E on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.config import ConformerParams, causal_conv_out_len
from rnnt_inference_tpu_torch.models.conformer import (
    ConformerBlockWeights,
    LayerNorm,
    _ff,
    _ln,
    block_weights,
)
from rnnt_inference_tpu_torch.models.weights import JointWeights, LSTMLayerWeights, map_tensors
from rnnt_inference_tpu_torch.ops.attention_cuda import rel_attention_stream, stream_positions
from rnnt_inference_tpu_torch.ops.depthwise_cuda import depthwise_causal
from rnnt_inference_tpu_torch.ops.projection_cuda import project
from rnnt_inference_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class StreamBlockWeights(ConformerBlockWeights):
    """A block of the streaming model: dw_w (k, D) and dw_b the causal
    depthwise convolution's own (no BatchNorm to fold), and the LayerNorm
    that follows it."""

    conv_norm: LayerNorm


@dataclasses.dataclass
class FastConformerWeights:
    """The whole streaming model.  Subsampling: conv1 as the im2col
    product's (9, Ch) (taps in (time, frequency) order), dw{1,2}_w (Ch, 1, 3,
    3) and pw{1,2}_w (Ch_in, Ch_out) for the two depthwise-separable stages,
    sub_out (F3 Ch, D), NeMo's (channel, frequency) rows reordered to
    (frequency, channel); the blocks; each layer's projected position band
    ((R + 1) C - 1, D) in the weights' type; the prediction net and joint in
    the decoder's form."""

    conv1_w: torch.Tensor
    conv1_b: torch.Tensor
    dw1_w: torch.Tensor
    dw1_b: torch.Tensor
    pw1_w: torch.Tensor
    pw1_b: torch.Tensor
    dw2_w: torch.Tensor
    dw2_b: torch.Tensor
    pw2_w: torch.Tensor
    pw2_b: torch.Tensor
    sub_out_w: torch.Tensor
    sub_out_b: torch.Tensor
    blocks: List[StreamBlockWeights]
    pos_band: List[torch.Tensor]
    embed: torch.Tensor  # (num_labels - 1, P): blank has no row (SOS embeds to zeros)
    pred_rnn: List[LSTMLayerWeights]
    joint: JointWeights

    def to(self, device=None, dtype=None) -> "FastConformerWeights":
        return map_tensors(self, lambda t: t.to(device=device, dtype=dtype))

    @property
    def dtype(self) -> torch.dtype:
        return self.sub_out_w.dtype


def check_params(params: ConformerParams) -> None:
    """The streaming model's structure, as the step computes it."""
    if not (params.streaming and params.subsampling == "dw_striding"
            and params.causal_downsampling and params.subsampling_factor == 8
            and params.conv_causal and params.conv_norm == "layer_norm"):
        raise ValueError(f"not a cache-aware streaming FastConformer: {params}")


def weights_from_dict(w: dict, params: ConformerParams,
                      dtype: torch.dtype = torch.bfloat16) -> FastConformerWeights:
    """FastConformerWeights from the float weights of the plain dict the
    benchmark's reference takes (benchmark/models/fastconformer_streaming.py
    random_weights): matrices and convolution kernels in ``dtype``, the rest
    in f32; each layer's position band projected here, on the weights'
    device."""
    check_params(params)
    mat = lambda t: t.to(dtype).contiguous()
    f32 = lambda t: t.float().contiguous()

    def block(b: dict) -> StreamBlockWeights:
        c = b["conv"]
        base = block_weights(b, params, dtype, c["dw_w"].float().t(), c["dw_b"])
        return StreamBlockWeights(**{f.name: getattr(base, f.name)
                                     for f in dataclasses.fields(base)},
                                  conv_norm=LayerNorm(f32(c["norm"]["g"]), f32(c["norm"]["b"])))

    s = w["subsampling"]
    C, F3, D = params.conv_channels, params.sub_freq, params.d_model
    blocks = [block(b) for b in w["blocks"]]
    pe = stream_positions(params.left_chunks + 1, params.chunk_frames, D,
                          s["out_w"].device).to(dtype)
    return FastConformerWeights(
        conv1_w=mat(s["conv1_w"].reshape(C, 9).t()), conv1_b=f32(s["conv1_b"]),
        dw1_w=mat(s["dw1_w"]), dw1_b=f32(s["dw1_b"]),
        pw1_w=mat(s["pw1_w"].reshape(C, C).t()), pw1_b=f32(s["pw1_b"]),
        dw2_w=mat(s["dw2_w"]), dw2_b=f32(s["dw2_b"]),
        pw2_w=mat(s["pw2_w"].reshape(C, C).t()), pw2_b=f32(s["pw2_b"]),
        sub_out_w=mat(s["out_w"].reshape(C, F3, D).transpose(0, 1).reshape(F3 * C, D)),
        sub_out_b=f32(s["out_b"]), blocks=blocks,
        pos_band=[project(pe, b.w_pos).to(dtype) for b in blocks], embed=mat(w["embed"]),
        pred_rnn=[LSTMLayerWeights(w_ih=mat(a), w_hh=mat(b), b=f32(c)) for a, b, c in w["pred"]],
        joint=JointWeights(w1_trans=mat(w["joint"]["w1_trans"]),
                           w1_pred=mat(w["joint"]["w1_pred"]), b1=f32(w["joint"]["b1"]),
                           w2=mat(w["joint"]["w2"]), b2=f32(w["joint"]["b2"])))


# --------------------------------------------------------------------------
# the streaming state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StreamState:
    """What a slot carries between chunks, every layer at once: ``kv`` (L,
    N, R, C, 2 D) the ring of K and V rows of the slot's last R chunks,
    ``conv`` (L, N, k - 1, D) the depthwise convolution's last input rows,
    both in the weights' type; ``pos`` (host) the ring place the next chunk
    takes (every slot's chunks advance together, one a step)."""

    kv: torch.Tensor
    conv: torch.Tensor
    pos: int = 0


def init_stream_state(slots: int, params: ConformerParams, dtype, device) -> StreamState:
    L, D, C, R = params.num_blocks, params.d_model, params.chunk_frames, params.left_chunks + 1
    return StreamState(
        kv=torch.zeros((L, slots, R, C, 2 * D), dtype=dtype, device=device),
        conv=torch.zeros((L, slots, params.conv_kernel_size - 1, D), dtype=dtype,
                         device=device))


def reset_slots(st: StreamState, slots: torch.Tensor, valid: torch.Tensor) -> None:
    """Zero the convolution cache of ``slots`` (device indices) where
    ``valid`` (a bool each) holds: where an utterance starts (the K/V ring
    is masked by the chunk index instead)."""
    st.conv.index_copy_(1, slots, st.conv.index_select(1, slots).masked_fill(
        valid[None, :, None, None], 0))


def encoded_len(frames: torch.Tensor, params: ConformerParams) -> torch.Tensor:
    """Encoder frames of each utterance of ``frames`` feature frames (0 for
    none), on the device."""
    return torch.where(frames > 0, params.subsampled_len(frames.long()), 0).int()


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

LEAD = 14  # mel frames an encoder frame reads before its own 8 t


def window_frames(params: ConformerParams) -> int:
    """Mel frames a chunk's window holds: 8 C + 7."""
    return params.subsampling_factor * (params.chunk_frames - 1) + LEAD + 1


def gather_window(feats: torch.Tensor, first: torch.Tensor, frames: torch.Tensor,
                  params: ConformerParams) -> torch.Tensor:
    """Each slot's window: feats {T_max, N, n_mels} (time-major), first (N,)
    the window's first mel frame (may be negative), frames (N,) the
    utterance's mel frames -> (N, window_frames, n_mels) f32, zero outside
    the utterance."""
    T_max, N, M = feats.shape
    t = first.long()[:, None] + torch.arange(window_frames(params), device=feats.device)
    inside = (t >= 0) & (t < frames.long()[:, None])
    idx = t.clamp(0, T_max - 1)
    win = feats[idx, torch.arange(N, device=feats.device)[:, None]]  # (N, W, M)
    return win.masked_fill(~inside[:, :, None], 0.0)


def _stage_mask(y: torch.Tensor, first: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Zero the rows (dim 1) of y whose stage index first + i lies outside [0,
    length)."""
    i = first[:, None] + torch.arange(y.shape[1], device=y.device)
    keep = (i >= 0) & (i < length[:, None])
    return y.mul_(keep.to(y.dtype).reshape(keep.shape + (1,) * (y.dim() - 2)))


def _dw_stage(y: torch.Tensor, dw_w, dw_b, pw_w, pw_b, impl) -> torch.Tensor:
    """A depthwise-separable causal stage on channels-last y (N, W, Fr, Ch):
    the 3x3 stride-2 depthwise convolution (time already windowed; 2 zeros
    before and 1 after on frequency: padding 2 both sides, the extra last
    output dropped), then the pointwise product (kernel E) and ReLU."""
    Fr, Ch = y.shape[2], y.shape[3]
    z = F.conv2d(y.permute(0, 3, 1, 2), dw_w, dw_b.to(y.dtype), stride=2, padding=(0, 2),
                 groups=Ch)[..., : Fr // 2 + 1]
    return project(z.permute(0, 2, 3, 1), pw_w, pw_b, impl=impl).relu_()


def subsample_window(w: FastConformerWeights, win: torch.Tensor, chunk: torch.Tensor,
                     frames: torch.Tensor, params: ConformerParams,
                     impl: Optional[str] = None) -> torch.Tensor:
    """The causal dw_striding subsampling of each slot's window (N, W,
    n_mels) f32 for chunk ``chunk`` (N,) of an utterance of ``frames`` (N,)
    mel frames -> the chunk's encoder input rows (N C, d_model) f32."""
    N, W, M = win.shape
    C = params.chunk_frames
    dt = w.dtype
    x = F.pad(win.to(dt), (2, 1))  # frequency: 2 before, 1 after
    W1, F1 = (W - 3) // 2 + 1, M // 2 + 1
    patches = torch.stack([x[:, i : i + 2 * W1 - 1 : 2, j : j + 2 * F1 - 1 : 2]
                           for i in range(3) for j in range(3)], -1)
    y = project(patches, w.conv1_w, w.conv1_b, impl=impl).relu_()  # (N, W1, F1, Ch)
    c = chunk.long()
    t1 = causal_conv_out_len(frames.long())
    y = _stage_mask(y, 4 * C * c - 6, t1)
    y = _stage_mask(_dw_stage(y, w.dw1_w, w.dw1_b, w.pw1_w, w.pw1_b, impl), 2 * C * c - 2,
                    causal_conv_out_len(t1))
    y = _dw_stage(y, w.dw2_w, w.dw2_b, w.pw2_w, w.pw2_b, impl)  # (N, C, F3, Ch)
    out = project(y.reshape(N * C, -1), w.sub_out_w, impl=impl)
    return out.add_(w.sub_out_b).mul_(math.sqrt(params.d_model))


def stream_block(b: StreamBlockWeights, band: torch.Tensor, x: torch.Tensor,
                 kv: torch.Tensor, conv: torch.Tensor, chunk: torch.Tensor,
                 enc_len: torch.Tensor, pos: int, params: ConformerParams,
                 impl: Optional[str] = None) -> torch.Tensor:
    """One block over every slot's chunk, x (N C, D) f32 (updated in
    place); kv (N, R, C, 2D) and conv (N, k - 1, D) the layer's ring and
    cache (updated in place), chunk and enc_len (N,) int32, pos the ring
    place of this chunk.  Returns the block's output."""
    D, dt, eps = params.d_model, b.w_qkv.dtype, params.ln_eps
    N, C = kv.shape[0], kv.shape[2]
    x.add_(_ff(x, b.ff1_ln, b.ff1_w1, b.ff1_b1, b.ff1_w2, b.ff1_b2, params, impl), alpha=0.5)

    qkv = project(_ln(x, b.att_ln, eps).to(dt), b.w_qkv, b.b_qkv, impl=impl)
    kv[:, pos] = qkv[:, D:].view(N, C, 2 * D)
    ctx = rel_attention_stream(qkv[:, :D], kv, band, b.pos_u, b.pos_v, chunk, enc_len, pos,
                               impl)
    del qkv
    x.add_(project(ctx, b.w_out, b.b_out, impl=impl))
    del ctx

    g = F.glu(project(_ln(x, b.conv_ln, eps).to(dt), b.pw1_w, b.pw1_b, impl=impl), dim=-1)
    g = depthwise_causal(g, conv, b.dw_w, b.dw_b, b.conv_norm.g, b.conv_norm.b, eps, impl)
    x.add_(project(g, b.pw2_w, b.pw2_b, impl=impl))
    del g

    x.add_(_ff(x, b.ff2_ln, b.ff2_w1, b.ff2_b1, b.ff2_w2, b.ff2_b2, params, impl), alpha=0.5)
    return _ln(x, b.out_ln, eps)


def encode_chunk(w: FastConformerWeights, st: StreamState, win: torch.Tensor,
                 chunk: torch.Tensor, frames: torch.Tensor, enc_len: torch.Tensor,
                 params: ConformerParams, impl: Optional[str] = None,
                 layer_span: Optional[str] = None):
    """The step: each slot's chunk ``chunk`` (N,) int32 of an utterance of
    ``frames`` mel frames and ``enc_len`` encoder frames, from its window
    (``gather_window``) -> ((N, C, d_model) f32, the state with the ring
    advanced; its caches are updated in place).  ``layer_span`` names a span
    around each block."""
    N, C = win.shape[0], params.chunk_frames
    x = subsample_window(w, win, chunk, frames, params, impl)
    pos = st.pos
    for l, b in enumerate(w.blocks):
        if layer_span is None:
            x = stream_block(b, w.pos_band[l], x, st.kv[l], st.conv[l], chunk, enc_len, pos,
                             params, impl)
        else:
            with span(layer_span):
                x = stream_block(b, w.pos_band[l], x, st.kv[l], st.conv[l], chunk, enc_len,
                                 pos, params, impl)
    return x.view(N, C, params.d_model), dataclasses.replace(st, pos=(pos + 1) % st.kv.shape[2])


def encode(w: FastConformerWeights, feats: torch.Tensor, feat_lens, params: ConformerParams,
           impl: Optional[str] = None) -> List[torch.Tensor]:
    """The streaming encoder over a batch, chunk by chunk with its caches, an
    utterance a slot: feats {T, N, n_mels} f32 (log_mel_features'
    time-major output), feat_lens {N} -> each utterance's output (L_i,
    d_model) f32."""
    dev = feats.device
    frames = torch.as_tensor(feat_lens, device=dev).int()
    N, C = feats.shape[1], params.chunk_frames
    enc_len = encoded_len(frames, params)
    lens = enc_len.cpu().numpy()
    st = init_stream_state(N, params, w.dtype, dev)
    outs = []
    for c in range(-(-int(lens.max(initial=0)) // C)):
        chunk = torch.full((N,), c, dtype=torch.int32, device=dev)
        win = gather_window(feats, params.subsampling_factor * C * chunk - LEAD, frames, params)
        y, st = encode_chunk(w, st, win, chunk, frames, enc_len, params, impl)
        outs.append(y)
    y = torch.cat(outs, 1) if outs else torch.zeros((N, 0, params.d_model), device=dev)
    return [y[i, : int(n)] for i, n in enumerate(lens)]
