"""The benchmark's model weights: random float32 weights drawn on the device
from a configuration's weight seed, the emission model that makes them emit
as speech does, and the program's weight objects made from them.

``random_weights`` returns a plain dict, the form the reference takes:
  {"pre": [(w_ih (IC, 4H), w_hh (H, 4H), b (4H,)), ...], "post": [...],
   "embed": (V - 1, P), "pred": [(w_ih, w_hh, b), ...],
   "joint": {"w1_trans" (H, J), "w1_pred" (P, J), "b1" (J,), "w2" (J, V), "b2" (V,)}}
LSTM gates in the order i, f, g, o, one folded bias.  The distributions are
PyTorch's LSTM and Linear defaults: U(+-1/sqrt(H)) for LSTM weights (the bias
a sum of two such draws, b_ih + b_hh), N(0, 1) for the embedding,
U(+-1/sqrt(fan_in)) for the joint.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _shapes(c: dict) -> List[Tuple[str, tuple, float]]:
    """(leaf, shape, uniform bound) of every uniform leaf, in draw order."""
    H, P, J, V = (c["trans_hidden_size"], c["pred_hidden_size"], c["joint_hidden_size"],
                  c["num_labels"])
    pre_in = [c["trans_input_size"]] + [H] * (c["pre_num_layers"] - 1)
    post_in = [H * c["stack_time_factor"]] + [H] * (c["post_num_layers"] - 1)
    out = []
    for stage, sizes, hid in (("pre", pre_in, H), ("post", post_in, H),
                              ("pred", [P] * c["pred_num_layers"], P)):
        k = hid ** -0.5
        for l, ic in enumerate(sizes):
            out += [(f"{stage}.{l}.w_ih", (ic, 4 * hid), k), (f"{stage}.{l}.w_hh", (hid, 4 * hid), k),
                    (f"{stage}.{l}.b_ih", (4 * hid,), k), (f"{stage}.{l}.b_hh", (4 * hid,), k)]
    kj = (H + P) ** -0.5
    out += [("joint.w1_trans", (H, J), kj), ("joint.w1_pred", (P, J), kj), ("joint.b1", (J,), kj),
            ("joint.w2", (J, V), J ** -0.5), ("joint.b2", (V,), J ** -0.5)]
    return out


def random_weights(config: dict, device) -> dict:
    """float32 weights from ``config["weight_seed"]``, drawn on ``device`` in
    two calls (one uniform block, the embedding)."""
    shapes = _shapes(config)
    sizes = [int(torch.tensor(s).prod()) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(config["weight_seed"]))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    embed = torch.randn((config["num_labels"] - 1, config["pred_hidden_size"]), generator=gen,
                        device=device)
    leaves, off = {}, 0
    for (name, shape, bound), n in zip(shapes, sizes):
        leaves[name] = (flat[off : off + n] * bound).reshape(shape)
        off += n

    def layers(stage, count):
        return [(leaves[f"{stage}.{l}.w_ih"], leaves[f"{stage}.{l}.w_hh"],
                 leaves[f"{stage}.{l}.b_ih"] + leaves[f"{stage}.{l}.b_hh"]) for l in range(count)]

    return {
        "pre": layers("pre", config["pre_num_layers"]),
        "post": layers("post", config["post_num_layers"]),
        "embed": embed,
        "pred": layers("pred", config["pred_num_layers"]),
        "joint": {k: leaves[f"joint.{k}"] for k in ("w1_trans", "w1_pred", "b1", "w2", "b2")},
    }


def program_weights(w: dict, config: dict, calib_feats=None):
    """The program's weight object for ``w``: float RNNTWeights cast to the
    configuration's precision, or, for an int8 encoder, the program's own
    calibration over ``calib_feats`` ((features {T, N, 240}, lengths {N}) of
    the calibration audio) and quantization."""
    from rnnt_inference_tpu_torch.models.weights import (JointWeights, LSTMLayerWeights,
                                                         RNNTWeights)

    lstm = lambda layers: [LSTMLayerWeights(w_ih=a, w_hh=b, b=c) for a, b, c in layers]
    w32 = RNNTWeights(pre_rnn=lstm(w["pre"]), post_rnn=lstm(w["post"]), embed=w["embed"],
                      pred_rnn=lstm(w["pred"]), joint=JointWeights(**w["joint"]))
    prec = config["precision"]
    if prec["encoder"] == "int8":
        from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights

        params = program_params(config)
        return quantize_weights(w32, calibrate(w32, [calib_feats], params), params)
    if set(prec.values()) == {"bf16"}:
        return w32.to(dtype=torch.bfloat16)
    raise ValueError(f"no program path for precision {prec}")


def program_params(config: dict, max_symbols_per_step: int = 1):
    from rnnt_inference_tpu_torch.config import RNNTParams

    keys = ("trans_input_size", "trans_hidden_size", "pre_num_layers", "post_num_layers",
            "stack_time_factor", "pred_hidden_size", "pred_num_layers", "joint_hidden_size",
            "num_labels", "max_res_len")
    return RNNTParams(**{k: config[k] for k in keys}, max_symbols_per_step=max_symbols_per_step)


def program_featurizer(config: dict):
    from rnnt_inference_tpu_torch.config import FeaturizerConfig

    return FeaturizerConfig(**config["featurizer"])
