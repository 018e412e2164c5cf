"""The Conformer-Transducer's encoder (NeMo stt_en_conformer_transducer_large,
config.ConformerParams): its weights and the functions the packed Offline
runner calls, on a varlen layout of whole utterances.

Layout: the utterances of a group lie one after another in one (R,
d_model) buffer with ``gap`` rows before each and after the last
(``varlen_layout``), so position-wise work runs over the concatenated rows
and the depthwise convolution (kernel 31, padding 15; kernel G,
ops/depthwise_cuda.py) cannot reach across utterances: it reads the gap
rows as zeros.
Self-attention reads each utterance's own rows (kernel F,
ops/attention_cuda.py, from ``Segments``).

Encoder, per utterance (NeMo's modules, dropout off):
  subsample  features (T, 80) -> Conv2d(1 -> C, 3x3, stride 2, pad 1), ReLU,
             Conv2d(C -> C, 3x3, stride 2, pad 1), ReLU, flatten (C x 20),
             Linear to d_model, times sqrt(d_model); each stride takes L to
             (L - 1) // 2 + 1.  As for a batch of one: the first
             convolution's frames past the utterance's own are zero before
             the second reads them (NeMo's batched ConvSubsampling reads
             ReLU(bias) there at an odd length; a departure noted in
             PERF.md).
  block      x += FF(LN(x)) / 2;  x += MHSA(LN(x));  x += Conv(LN(x));
             x += FF(LN(x)) / 2;  x = LN(x)
             FF = Linear(D -> 4D), Swish, Linear(4D -> D)
             MHSA = relative-position attention, per-layer u and v (kernel F),
                    then Linear(D -> D); positions p = W_pos PE (no bias)
             Conv = Linear(D -> 2D) (pointwise), GLU, depthwise Conv1d (k 31),
                    BatchNorm (eval: a per-channel affine), Swish, Linear(D -> D)

Numerics: the residual stream is f32 and LayerNorm's statistics are f32;
every product's input is rounded to the weights' type.  Every linear and
pointwise product goes through ops/projection_cuda.project (kernel E for
bf16 on the card: f32 sums, the bias added in the epilogue and the sum
rounded once to bf16; the subsampling's Linear, which starts the residual
stream, is read in f32).  Swish and the GLU take the bf16 products and
compute in f32 inside one pass each, and each sublayer's bf16 output is
added to the f32 stream.  BatchNorm (eval) is folded into the depthwise
convolution's weights (rounded to the weights' type) and bias (f32);
kernel G sums the convolution, adds the bias and takes Swish in f32.  The
first subsampling convolution is an im2col product on kernel E; the
second (channels last, fused with its ReLU) is a torch convolution in the
weights' type (cuDNN on the card).

The prediction net and joint are the RNN-T's (models/decoder.py, kernel B),
with one LSTM layer: ConformerWeights carries ``embed``, ``pred_rnn`` and
``joint`` under the names the decoder reads.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rnnt_inference_tpu_torch.config import ConformerParams, conv_out_len
from rnnt_inference_tpu_torch.models.weights import (
    JointWeights,
    LSTMLayerWeights,
    map_tensors,
)
from rnnt_inference_tpu_torch.ops.attention_cuda import Segments, rel_attention, relative_positions
from rnnt_inference_tpu_torch.ops.depthwise_cuda import depthwise_silu
from rnnt_inference_tpu_torch.ops.projection_cuda import project

GAP = 15  # zero rows before each utterance: the depthwise convolution's reach


@dataclasses.dataclass
class LayerNorm:
    g: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass
class ConformerBlockWeights:
    """One Conformer block.  Matrices (in, out) in the weights' type; LayerNorm
    and BatchNorm parameters, biases, u and v in f32.  qkv: the three
    projections side by side (D, 3D); BatchNorm as its eval affine, scale
    gamma / sqrt(var + eps) and shift beta - mean scale, folded into the
    depthwise convolution: dw_w scale, dw_b scale + shift."""

    ff1_ln: LayerNorm
    ff1_w1: torch.Tensor
    ff1_b1: torch.Tensor
    ff1_w2: torch.Tensor
    ff1_b2: torch.Tensor
    att_ln: LayerNorm
    w_qkv: torch.Tensor
    b_qkv: torch.Tensor
    w_pos: torch.Tensor
    pos_u: torch.Tensor  # (H, d_head)
    pos_v: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    conv_ln: LayerNorm
    pw1_w: torch.Tensor  # (D, 2D)
    pw1_b: torch.Tensor
    dw_w: torch.Tensor  # (kernel, D), BatchNorm's scale folded in
    dw_b: torch.Tensor  # BatchNorm's shift folded in
    pw2_w: torch.Tensor
    pw2_b: torch.Tensor
    ff2_ln: LayerNorm
    ff2_w1: torch.Tensor
    ff2_b1: torch.Tensor
    ff2_w2: torch.Tensor
    ff2_b2: torch.Tensor
    out_ln: LayerNorm


@dataclasses.dataclass
class ConformerWeights:
    """The whole model: subsampling (conv1 as the im2col product's (9, C),
    taps in (time, frequency) order; conv2 (C, C, 3, 3) channels last;
    sub_out (F' C, D), NeMo's (channel, frequency) rows
    reordered to (frequency, channel), the order a channels-last output
    flattens in), the blocks, and the prediction net and joint in the
    decoder's form."""

    conv1_w: torch.Tensor
    conv1_b: torch.Tensor
    conv2_w: torch.Tensor
    conv2_b: torch.Tensor
    sub_out_w: torch.Tensor
    sub_out_b: torch.Tensor
    blocks: List[ConformerBlockWeights]
    embed: torch.Tensor  # (num_labels - 1, P): blank has no row (SOS embeds to zeros)
    pred_rnn: List[LSTMLayerWeights]
    joint: JointWeights

    def to(self, device=None, dtype=None) -> "ConformerWeights":
        return map_tensors(self, lambda t: t.to(device=device, dtype=dtype))

    @property
    def dtype(self) -> torch.dtype:
        return self.sub_out_w.dtype


def block_weights(b: dict, params: ConformerParams, dtype: torch.dtype, dw_w: torch.Tensor,
                  dw_b: torch.Tensor) -> ConformerBlockWeights:
    """One block's weights from the plain dict's, with the depthwise
    convolution's (kernel, D) taps and bias as given (matrices in
    ``dtype``, the rest in f32)."""
    mat = lambda t: t.to(dtype).contiguous()
    f32 = lambda t: t.float().contiguous()
    ln = lambda p: LayerNorm(f32(p["g"]), f32(p["b"]))
    H, dh = params.n_heads, params.d_head
    ff = lambda f, k: dict(**{f"{k}_ln": ln(f["ln"]), f"{k}_w1": mat(f["w1"]),
                              f"{k}_b1": f32(f["b1"]), f"{k}_w2": mat(f["w2"]),
                              f"{k}_b2": f32(f["b2"])})
    a, c = b["att"], b["conv"]
    return ConformerBlockWeights(
        **ff(b["ff1"], "ff1"), att_ln=ln(a["ln"]),
        w_qkv=mat(torch.cat([a["wq"], a["wk"], a["wv"]], 1)),
        b_qkv=f32(torch.cat([a["bq"], a["bk"], a["bv"]])), w_pos=mat(a["w_pos"]),
        pos_u=f32(a["u"].reshape(H, dh)), pos_v=f32(a["v"].reshape(H, dh)),
        w_out=mat(a["w_out"]), b_out=f32(a["b_out"]), conv_ln=ln(c["ln"]),
        pw1_w=mat(c["pw1_w"]), pw1_b=f32(c["pw1_b"]), dw_w=mat(dw_w), dw_b=f32(dw_b),
        pw2_w=mat(c["pw2_w"]), pw2_b=f32(c["pw2_b"]), **ff(b["ff2"], "ff2"),
        out_ln=ln(b["out_ln"]))


def weights_from_dict(w: dict, params: ConformerParams,
                      dtype: torch.dtype = torch.bfloat16) -> ConformerWeights:
    """ConformerWeights from float weights in the plain dict the benchmark's
    reference takes (benchmark/models/conformer_transducer.py
    random_weights): matrices and convolution kernels in ``dtype``, the
    rest in f32; BatchNorm folded into its eval affine."""
    mat = lambda t: t.to(dtype).contiguous()
    f32 = lambda t: t.float().contiguous()

    def block(b: dict) -> ConformerBlockWeights:
        c = b["conv"]
        scale = c["bn_g"].float() / torch.sqrt(c["bn_var"].float() + params.bn_eps)
        return block_weights(
            b, params, dtype, (c["dw_w"].float() * scale[:, None]).t(),
            c["dw_b"].float() * scale + c["bn_b"].float() - c["bn_mean"].float() * scale)

    s = w["subsampling"]
    cl = lambda t: t.to(dtype).contiguous(memory_format=torch.channels_last)
    C, F2, D = params.conv_channels, params.sub_freq, params.d_model
    return ConformerWeights(
        conv1_w=mat(s["conv1_w"].reshape(C, 9).t()), conv1_b=f32(s["conv1_b"]),
        conv2_w=cl(s["conv2_w"]),
        conv2_b=f32(s["conv2_b"]),
        sub_out_w=mat(s["out_w"].reshape(C, F2, D).transpose(0, 1).reshape(F2 * C, D)),
        sub_out_b=f32(s["out_b"]),
        blocks=[block(b) for b in w["blocks"]], embed=mat(w["embed"]),
        pred_rnn=[LSTMLayerWeights(w_ih=mat(a), w_hh=mat(b), b=f32(c)) for a, b, c in w["pred"]],
        joint=JointWeights(w1_trans=mat(w["joint"]["w1_trans"]),
                           w1_pred=mat(w["joint"]["w1_pred"]), b1=f32(w["joint"]["b1"]),
                           w2=mat(w["joint"]["w2"]), b2=f32(w["joint"]["b2"])))


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


def varlen_layout(lens: Sequence[int], gap: int = GAP) -> Tuple[np.ndarray, int]:
    """(first row of each utterance, rows in all) of the varlen buffer:
    ``gap`` rows no utterance owns before each utterance and after the
    last."""
    lens = np.asarray(lens, np.int64)
    starts = gap + np.concatenate([[0], np.cumsum(lens + gap)[:-1]]).astype(np.int64)
    rows = int(starts[-1] + lens[-1] + gap) if len(lens) else gap
    return starts, rows


def gap_mask(starts: np.ndarray, lens: np.ndarray, rows: int, device) -> torch.Tensor:
    """(rows,) bool, True on the rows no utterance owns."""
    owned = np.zeros(rows + 1, np.int64)
    np.add.at(owned, starts, 1)
    np.add.at(owned, starts + lens, -1)
    return torch.from_numpy(np.cumsum(owned[:rows]) == 0).to(device)


# --------------------------------------------------------------------------
# subsampling
# --------------------------------------------------------------------------


def _conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ReLU(Conv2d(x; 3x3, stride 2, padding 1) + b), channels last: cuDNN's
    fused convolution and ReLU on the card, the two torch calls elsewhere."""
    if x.is_cuda:
        return torch.cudnn_convolution_relu(x, w, b, (2, 2), (1, 1), (1, 1), 1)
    return F.conv2d(x, w, b, stride=2, padding=1).relu_()


def subsample(w: ConformerWeights, feats: torch.Tensor, lens: torch.Tensor,
              params: ConformerParams, impl: Optional[str] = None) -> torch.Tensor:
    """Striding subsampling of a padded group: feats (G, T, n_mels) f32,
    zeros past each utterance's ``lens`` (G,) frames -> the encoder's input
    rows (sum of encoded lengths, d_model) f32, utterance after utterance.

    The first convolution (one input channel, 9 taps) is an im2col product
    on kernel E, (G T' F', 9) x (9, C) with the bias in its epilogue, whose
    (G, T', F', C) output is the channels-last layout the second takes; the
    second is cuDNN's fused convolution and ReLU (PERF.md: at the cell's
    groups the first ran 1.7-3.6 times faster on E than on cuDNN, the
    second at 600-830 TFLOP/s on cuDNN against 164 as im2col on E).  The Linear runs over every
    (utterance, frame) of the group and keeps the valid rows."""
    G, T, M = feats.shape
    dt, C, dev = w.dtype, params.conv_channels, feats.device
    T1, F1 = conv_out_len(T), conv_out_len(M)
    x = F.pad(feats.to(dt), (1, 1, 1, 1))
    patches = torch.stack([x[:, i : i + 2 * T1 : 2, j : j + 2 * F1 : 2]
                           for i in range(3) for j in range(3)], -1)
    y = project(patches, w.conv1_w, w.conv1_b, impl=impl).relu_()  # (G, T1, F1, C)
    lens = lens.to(device=dev, dtype=torch.int64)
    l1 = conv_out_len(lens)
    # the second convolution reads frame l1 of an utterance whose l1 is odd:
    # zero there, as for a batch of one (the frames after it feed only
    # outputs past the utterance's own, which are dropped)
    pad = l1 < T1
    y[torch.arange(G, device=dev)[pad], l1[pad]] = 0
    y = _conv_relu(y.permute(0, 3, 1, 2), w.conv2_w, w.conv2_b.to(dt))
    T2 = y.shape[2]
    rows = y.permute(0, 2, 3, 1).contiguous().reshape(G * T2, -1)  # (frequency, channel)
    keep = (torch.arange(T2, device=dev)[None, :] < conv_out_len(l1)[:, None]).reshape(-1)
    out = project(rows, w.sub_out_w, impl=impl)[keep]
    return out.add_(w.sub_out_b).mul_(math.sqrt(params.d_model))


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _ln(x: torch.Tensor, p: LayerNorm, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p.g, p.b, eps)


def _ff(x: torch.Tensor, ln: LayerNorm, w1, b1, w2, b2, params: ConformerParams, impl):
    h = project(_ln(x, ln, params.ln_eps).to(w1.dtype), w1, b1, impl=impl)
    return project(F.silu(h, inplace=True), w2, b2, impl=impl)


@functools.lru_cache(maxsize=8)
def _positions(t_max: int, d_model: int, device: torch.device, dtype: torch.dtype):
    return relative_positions(t_max, d_model, device).to(dtype)


def positions(t_max: int, params: ConformerParams, device, dtype) -> torch.Tensor:
    """The sinusoidal table of relative positions t_max - 1 .. -(t_max - 1)
    in the weights' type (made once per length and device)."""
    return _positions(int(t_max), params.d_model, torch.device(device), dtype)


def block(b: ConformerBlockWeights, x: torch.Tensor, pe: torch.Tensor, segs: Segments,
          gaps: torch.Tensor, params: ConformerParams, impl: Optional[str] = None):
    """One Conformer block over the varlen rows x (R, D) f32 (updated in
    place); returns the block's output.  pe is the positions table of
    ``segs.t_max``, gaps (R,) the rows no utterance owns."""
    D, dt, eps = params.d_model, b.w_qkv.dtype, params.ln_eps
    x.add_(_ff(x, b.ff1_ln, b.ff1_w1, b.ff1_b1, b.ff1_w2, b.ff1_b2, params, impl), alpha=0.5)

    qkv = project(_ln(x, b.att_ln, eps).to(dt), b.w_qkv, b.b_qkv, impl=impl)
    p = project(pe, b.w_pos, impl=impl).to(dt)
    ctx = rel_attention(qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :], b.pos_u, b.pos_v, p,
                        segs, impl)
    del qkv
    x.add_(project(ctx, b.w_out, b.b_out, impl=impl))
    del ctx

    g = F.glu(project(_ln(x, b.conv_ln, eps).to(dt), b.pw1_w, b.pw1_b, impl=impl), dim=-1)
    g = depthwise_silu(g, gaps, b.dw_w, b.dw_b, impl)
    x.add_(project(g, b.pw2_w, b.pw2_b, impl=impl))
    del g

    x.add_(_ff(x, b.ff2_ln, b.ff2_w1, b.ff2_b1, b.ff2_w2, b.ff2_b2, params, impl), alpha=0.5)
    return _ln(x, b.out_ln, eps)


# --------------------------------------------------------------------------
# the whole encoder
# --------------------------------------------------------------------------


def encode(w: ConformerWeights, feats: torch.Tensor, feat_lens, params: ConformerParams,
           impl: Optional[str] = None) -> List[torch.Tensor]:
    """The encoder over a batch: feats {T, N, n_mels} f32, zeros past each
    utterance's feat_lens {N} frames (log_mel_features' time-major output)
    -> each utterance's output (L_i, d_model) f32, all encoded together in
    one varlen group."""
    dev = feats.device
    flens = np.asarray(torch.as_tensor(feat_lens).cpu(), np.int64)
    rows_in = subsample(w, feats.transpose(0, 1), torch.as_tensor(flens, device=dev), params,
                        impl)
    lens = np.array([params.encoded_len(int(f)) for f in flens], np.int64)
    starts, R = varlen_layout(lens)
    x = torch.zeros((R, params.d_model), dtype=torch.float32, device=dev)
    x[torch.as_tensor(np.concatenate([s + np.arange(n) for s, n in zip(starts, lens)]),
                      device=dev)] = rows_in
    segs = Segments.of(starts, lens, dev)
    gaps = gap_mask(starts, lens, R, dev)
    pe = positions(segs.t_max, params, dev, w.dtype)
    for b in w.blocks:
        x = block(b, x, pe, segs, gaps, params, impl)
    return [x[s : s + n] for s, n in zip(starts, lens)]
