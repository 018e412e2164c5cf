"""Weights of the RNN-T model, their initializer, and the bridge from the JAX
package's arrays (counterpart of rnnt_inference_tpu/models/weights.py).

Layout is the reference's, so the two packages exchange weights as plain
arrays:
  - LSTM weights pre-transposed as (in_features, 4*hidden), gate order
    i, f, g, o, and one folded bias b = b_ih + b_hh;
  - the joint's first linear split into a transcription half (1024, 512)
    and a prediction half (320, 512) with one folded bias.

The bridge (``weights_from_numpy_leaves`` / ``load_jax_npz``) reads the
leaves in ``jax.tree.flatten`` order, the order rnnt_inference_tpu's
checkpoint container writes, with bf16 stored as its uint16 bit pattern.
``load_torch_checkpoint`` imports the MLPerf zenodo ``rnnt.pt``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import RNNTParams


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``fn`` to every tensor of a weights dataclass (nested in
    dataclasses and lists), returning a new object of the same structure."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, list):
        return [map_tensors(o, fn) for o in obj]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{f.name: map_tensors(getattr(obj, f.name), fn)
               for f in dataclasses.fields(obj) if f.init},
        )
    raise TypeError(f"unexpected leaf {type(obj).__name__}")


def tensor_leaves(obj) -> List[torch.Tensor]:
    """Tensors of a weights dataclass in field order (jax.tree.flatten order)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, list):
        return [t for o in obj for t in tensor_leaves(o)]
    return [t for f in dataclasses.fields(obj) if f.init
            for t in tensor_leaves(getattr(obj, f.name))]


@dataclasses.dataclass
class LSTMLayerWeights:
    """One LSTM layer.  w_ih: (IC, 4H), w_hh: (H, 4H), b: (4H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass
class JointWeights:
    """relu(f@w1_trans + g@w1_pred + b1) @ w2 + b2.

    w1_trans (1024, 512), w1_pred (320, 512), b1 (512,), w2 (512, 29), b2 (29,).
    """

    w1_trans: torch.Tensor
    w1_pred: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


@dataclasses.dataclass
class RNNTWeights:
    """Float model: 2-layer pre-rnn + 3-layer post-rnn encoder, embedding +
    2-layer prediction rnn, joint."""

    pre_rnn: List[LSTMLayerWeights]
    post_rnn: List[LSTMLayerWeights]
    embed: torch.Tensor  # (num_labels - 1, pred_hidden)
    pred_rnn: List[LSTMLayerWeights]
    joint: JointWeights

    def to(self, device=None, dtype=None) -> "RNNTWeights":
        return map_tensors(self, lambda t: t.to(device=device, dtype=dtype))


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def _init_lstm_layer(gen, input_size: int, hidden_size: int) -> LSTMLayerWeights:
    # torch LSTM init: U(-k, k), k = 1/sqrt(hidden); the folded bias is the
    # sum of two such draws, as b_ih + b_hh
    k = 1.0 / np.sqrt(hidden_size)
    return LSTMLayerWeights(
        w_ih=_uniform(gen, (input_size, 4 * hidden_size), k),
        w_hh=_uniform(gen, (hidden_size, 4 * hidden_size), k),
        b=_uniform(gen, (4 * hidden_size,), k) + _uniform(gen, (4 * hidden_size,), k),
    )


def init_weights(
    params: RNNTParams = RNNTParams(),
    generator: torch.Generator = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> RNNTWeights:
    """Random weights with the JAX package's distributions (weights.py
    init_weights): torch-style uniform LSTM init, N(0, 1) embedding,
    U(+-1/sqrt(fan_in)) joint.  Drawn on the CPU from ``generator`` (a CPU
    torch.Generator), so one seed gives the same weights on every device."""
    if generator is None:
        raise ValueError("init_weights needs an explicit torch.Generator")
    pre_sizes = [params.trans_input_size] + [params.trans_hidden_size] * (
        params.pre_num_layers - 1
    )
    post_in = params.trans_hidden_size * params.stack_time_factor
    post_sizes = [post_in] + [params.trans_hidden_size] * (params.post_num_layers - 1)
    pred_sizes = [params.pred_hidden_size] * params.pred_num_layers
    H, P, J, K = (
        params.trans_hidden_size,
        params.pred_hidden_size,
        params.joint_hidden_size,
        params.num_labels,
    )
    g = generator
    w = RNNTWeights(
        pre_rnn=[_init_lstm_layer(g, s, H) for s in pre_sizes],
        post_rnn=[_init_lstm_layer(g, s, H) for s in post_sizes],
        embed=torch.randn((K - 1, P), generator=g, dtype=torch.float32),
        pred_rnn=[_init_lstm_layer(g, s, P) for s in pred_sizes],
        joint=JointWeights(
            w1_trans=_uniform(g, (H, J), 1 / np.sqrt(H + P)),
            w1_pred=_uniform(g, (P, J), 1 / np.sqrt(H + P)),
            b1=_uniform(g, (J,), 1 / np.sqrt(H + P)),
            w2=_uniform(g, (J, K), 1 / np.sqrt(J)),
            b2=_uniform(g, (K,), 1 / np.sqrt(J)),
        ),
    )
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Bridge from the JAX package's arrays
# ---------------------------------------------------------------------------


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy; keeps 0-d scalars 0-d
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        # bf16 travels as its 16-bit pattern (numpy has no bf16)
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layers(it, count: int, make):
    return [make(it) for _ in range(count)]


def weights_from_numpy_leaves(
    leaves: Sequence[np.ndarray],
    kind: str,
    params: RNNTParams = RNNTParams(),
    device="cuda",
):
    """Rebuild the port's weights from arrays in ``jax.tree.flatten`` order.

    kind: "rnnt_weights" -> RNNTWeights; "rnnt_quant_weights" ->
    QuantRNNTWeights (int8 encoder layers carry w_ih, w_hh, b, in_scale,
    w_scale, out_scale).  bf16 leaves may be given as uint16 bit patterns.
    """
    from rnnt_inference_tpu_torch.models.quant import (
        QuantLSTMLayerWeights,
        QuantRNNTWeights,
    )

    it = iter([_to_tensor(a, device) for a in leaves])
    lstm = lambda i: LSTMLayerWeights(w_ih=next(i), w_hh=next(i), b=next(i))
    if kind == "rnnt_weights":
        enc_layer, cls = lstm, RNNTWeights
    elif kind == "rnnt_quant_weights":
        enc_layer = lambda i: QuantLSTMLayerWeights(
            w_ih=next(i), w_hh=next(i), b=next(i),
            in_scale=next(i), w_scale=next(i), out_scale=next(i),
        )
        cls = QuantRNNTWeights
    else:
        raise ValueError(f"unknown weights kind {kind!r}")
    out = cls(
        pre_rnn=_layers(it, params.pre_num_layers, enc_layer),
        post_rnn=_layers(it, params.post_num_layers, enc_layer),
        embed=next(it),
        pred_rnn=_layers(it, params.pred_num_layers, lstm),
        joint=JointWeights(
            w1_trans=next(it), w1_pred=next(it), b1=next(it), w2=next(it), b2=next(it)
        ),
    )
    if next(it, None) is not None:
        raise ValueError("more leaves than the model structure holds")
    return out


def numpy_leaves(weights) -> List[np.ndarray]:
    """The inverse of the bridge: arrays in ``jax.tree.flatten`` order, bf16
    as uint16 bit patterns."""
    out = []
    for t in tensor_leaves(weights):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out.append(t.view(torch.int16).numpy().view(np.uint16))
        else:
            out.append(t.numpy())
    return out


def read_npz(path: str):
    """(meta, leaves) of a container in the format of rnnt_inference_tpu's
    checkpoint.save_pytree: keys a0..a{n-1} in ``jax.tree.flatten`` order and
    __meta__ (json: kind, n, dtypes).  bf16 leaves come back as uint16 bit
    patterns."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"a{i}"] for i in range(meta["n"])]
    for i, dt in enumerate(meta["dtypes"]):
        if dt == "bfloat16":
            leaves[i] = leaves[i].view(np.uint16)
    return meta, leaves


def load_jax_npz(path: str, params: RNNTParams = RNNTParams(), device="cuda"):
    """Read a container written by rnnt_inference_tpu's checkpoint.save_pytree
    (``rnnt_weights`` or ``rnnt_quant_weights``) without JAX."""
    meta, leaves = read_npz(path)
    return weights_from_numpy_leaves(leaves, meta["kind"], params, device)


# ---------------------------------------------------------------------------
# Checkpoint import (zenodo rnnt.pt -> RNNTWeights)
# ---------------------------------------------------------------------------


def _get(sd: Dict[str, Any], key: str) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _lstm_from_torch(sd: Dict[str, Any], prefix: str, num_layers: int, device):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [
        LSTMLayerWeights(
            w_ih=t(_get(sd, f"{prefix}.weight_ih_l{l}").T),  # (4H, IC) -> (IC, 4H)
            w_hh=t(_get(sd, f"{prefix}.weight_hh_l{l}").T),
            b=t(_get(sd, f"{prefix}.bias_ih_l{l}") + _get(sd, f"{prefix}.bias_hh_l{l}")),
        )
        for l in range(num_layers)
    ]


def weights_from_torch_state_dict(
    state_dict: Dict[str, Any], params: RNNTParams = RNNTParams(), device="cuda"
) -> RNNTWeights:
    """Import the MLPerf RNN-T checkpoint (the JAX package's
    weights_from_torch_state_dict, leaf for leaf).

    Accepts the raw zenodo keys (encoder.pre_rnn.lstm.*, joint_net.0.*) or
    the migrated ones (transcription.pre_rnn.*, joint.linear1_trans.*), bare
    or under a "state_dict" entry; the key migration mirrors the reference's
    models/utils.py:60-81.  The joint's first linear is split at
    trans_hidden_size, its bias going to the prediction half (the
    transcription half's bias is zero).  Featurizer buffers are ignored.
    """
    sd = dict(state_dict)
    if "state_dict" in sd:
        sd = dict(sd["state_dict"])

    migrated: Dict[str, Any] = {}
    for key, value in sd.items():
        if key == "joint_net.0.weight":
            w = _get(sd, key)  # (J, H + P)
            migrated["joint.linear1_trans.weight"] = w[:, : params.trans_hidden_size]
            migrated["joint.linear1_pred.weight"] = w[:, params.trans_hidden_size :]
            continue
        if key == "joint_net.0.bias":
            migrated["joint.linear1_trans.bias"] = np.zeros(params.joint_hidden_size, np.float32)
            migrated["joint.linear1_pred.bias"] = value
            continue
        key = key.replace("encoder.pre_rnn.lstm", "transcription.pre_rnn")
        key = key.replace("encoder.post_rnn.lstm", "transcription.post_rnn")
        key = key.replace("dec_rnn.lstm", "pred_rnn")
        key = key.replace("joint_net.0", "joint.linear1")
        key = key.replace("joint_net.3", "joint.linear2")
        migrated[key] = value
    sd = migrated

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return RNNTWeights(
        pre_rnn=_lstm_from_torch(sd, "transcription.pre_rnn", params.pre_num_layers, device),
        post_rnn=_lstm_from_torch(sd, "transcription.post_rnn", params.post_num_layers, device),
        embed=t(_get(sd, "prediction.embed.weight")),
        pred_rnn=_lstm_from_torch(sd, "prediction.pred_rnn", params.pred_num_layers, device),
        joint=JointWeights(
            w1_trans=t(_get(sd, "joint.linear1_trans.weight").T),
            w1_pred=t(_get(sd, "joint.linear1_pred.weight").T),
            b1=t(_get(sd, "joint.linear1_trans.bias") + _get(sd, "joint.linear1_pred.bias")),
            w2=t(_get(sd, "joint.linear2.weight").T),
            b2=t(_get(sd, "joint.linear2.bias")),
        ),
    )


def torch_state_dict_from_weights(weights: RNNTWeights) -> Dict[str, torch.Tensor]:
    """The float weights under the zenodo checkpoint's keys and layouts, on
    the CPU (the inverse of weights_from_torch_state_dict: each folded bias
    as bias_ih with a zero bias_hh, the joint's first linear joined).  For
    writing checkpoints of seeded weights."""
    w = weights.to(device="cpu", dtype=torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    for prefix, layers in (("encoder.pre_rnn.lstm", w.pre_rnn),
                           ("encoder.post_rnn.lstm", w.post_rnn),
                           ("prediction.dec_rnn.lstm", w.pred_rnn)):
        for l, layer in enumerate(layers):
            sd[f"{prefix}.weight_ih_l{l}"] = layer.w_ih.T.contiguous()
            sd[f"{prefix}.weight_hh_l{l}"] = layer.w_hh.T.contiguous()
            sd[f"{prefix}.bias_ih_l{l}"] = layer.b.clone()
            sd[f"{prefix}.bias_hh_l{l}"] = torch.zeros_like(layer.b)
    sd["prediction.embed.weight"] = w.embed.clone()
    sd["joint_net.0.weight"] = torch.cat([w.joint.w1_trans.T, w.joint.w1_pred.T], dim=1)
    sd["joint_net.0.bias"] = w.joint.b1.clone()
    sd["joint_net.3.weight"] = w.joint.w2.T.contiguous()
    sd["joint_net.3.bias"] = w.joint.b2.clone()
    return sd


def load_torch_checkpoint(path: str, params: RNNTParams = RNNTParams(), device="cuda"):
    """Load the zenodo rnnt.pt on the CPU and import it.  weights_only=False
    as the JAX importer: a real zenodo file holds non-tensor entries that
    torch's weights-only loader may refuse."""
    return weights_from_torch_state_dict(
        torch.load(path, map_location="cpu", weights_only=False), params, device)
