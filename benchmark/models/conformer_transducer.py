"""NVIDIA NeMo's Conformer-Transducer Large
(benchmark/configs/nemo_conformer_transducer_large.json): what of the
harness depends on this architecture, reached as ``cell.model``
(benchmark/models/__init__.py gives the interface).

Weights: random float32 weights drawn on the device from the
configuration's weight seed, as a plain dict, the form the reference
(benchmark/reference/conformer_transducer.py) takes:
  {"subsampling": {"conv1_w" (C, 1, 3, 3), "conv1_b", "conv2_w" (C, C, 3, 3),
                   "conv2_b", "out_w" (C F', D), "out_b"},
   "blocks": [{"ff1": FF, "att": {"ln", "wq", "bq", "wk", "bk", "wv", "bv",
               "w_pos", "u" (D,), "v" (D,), "w_out", "b_out"},
               "conv": {"ln", "pw1_w" (D, 2D), "pw1_b", "dw_w" (D, k), "dw_b",
                        "bn_mean", "bn_var", "bn_g", "bn_b", "pw2_w", "pw2_b"},
               "ff2": FF, "out_ln"}, ...],
   "embed": (V - 1, P), "pred": [(w_ih (P, 4P), w_hh (P, 4P), b (4P,))],
   "joint": {"w1_trans" (D, J), "w1_pred" (P, J), "b1" (J,), "w2" (J, V), "b2" (V,)}}
with FF = {"ln", "w1" (D, 4D), "b1", "w2" (4D, D), "b2"} and every LayerNorm
{"g", "b"}; matrices (in, out).  The distributions are PyTorch's defaults
(U(+-1/sqrt(fan_in)) for Linear and Conv weights and biases, N(0, 1) for the
embedding, U(+-1/sqrt(H)) for the LSTM, the bias a sum of two such draws),
with LayerNorm gains 1 + U(+-0.1), biases U(+-0.1), the q k v biases, u
and v U(+-0.1) (NeMo starts u and v at zero; trained ones are not), and
BatchNorm running means U(+-0.1), variances 1 + U(+-0.5) (positive), gains
1 + U(+-0.1) and shifts U(+-0.1).

The program's objects: ConformerWeights in bf16 (models/conformer.py),
ConformerParams, the FeaturizerConfig.  Work counts feature frames, encoder
frames, symbols and the attention's sum of squared lengths; least times
count the subsampling's and the blocks' products, the prediction net's step
and the joint; the recorder wraps kernels E and F.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import emission as emission_models
from benchmark.models import from_file
from benchmark.roofline import ITEM, PEAK_OPS

REPO = Path(__file__).resolve().parents[2]  # the checkout this module is in


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def _dims(c: dict):
    D, C, k = c["d_model"], c["conv_channels"], c["conv_kernel_size"]
    F2 = ((c["featurizer"]["n_mels"] - 1) // 2 + 1 - 1) // 2 + 1
    return D, C, k, F2, c["ff_expansion"] * D, c["pred_hidden_size"], c["joint_hidden_size"], \
        c["num_labels"]


def _shapes(c: dict) -> List[Tuple[str, tuple, str, float]]:
    """(leaf, shape, law, scale) of every leaf in draw order, named by its
    path in the weights dict: law "u" is U(+-scale), "one" 1 + U(+-scale)."""
    D, C, k, F2, FF, P, J, V = _dims(c)
    lin = lambda w, b, i, o: [(w, (i, o), "u", i ** -0.5), (b, (o,), "u", i ** -0.5)]
    ln = lambda name: [(f"{name}.g", (D,), "one", 0.1), (f"{name}.b", (D,), "u", 0.1)]
    s = "subsampling"
    out = [(f"{s}.conv1_w", (C, 1, 3, 3), "u", 9 ** -0.5), (f"{s}.conv1_b", (C,), "u", 9 ** -0.5),
           (f"{s}.conv2_w", (C, C, 3, 3), "u", (9 * C) ** -0.5),
           (f"{s}.conv2_b", (C,), "u", (9 * C) ** -0.5)] + lin(f"{s}.out_w", f"{s}.out_b", C * F2, D)
    for i in range(c["num_blocks"]):
        b = f"blocks.{i}"
        for f in ("ff1", "ff2"):
            out += (ln(f"{b}.{f}.ln") + lin(f"{b}.{f}.w1", f"{b}.{f}.b1", D, FF)
                    + lin(f"{b}.{f}.w2", f"{b}.{f}.b2", FF, D))
        a = f"{b}.att"
        out += ln(f"{a}.ln")
        for name in ("q", "k", "v"):
            out += [(f"{a}.w{name}", (D, D), "u", D ** -0.5), (f"{a}.b{name}", (D,), "u", 0.1)]
        out += [(f"{a}.w_pos", (D, D), "u", D ** -0.5), (f"{a}.u", (D,), "u", 0.1),
                (f"{a}.v", (D,), "u", 0.1)] + lin(f"{a}.w_out", f"{a}.b_out", D, D)
        v = f"{b}.conv"
        out += ln(f"{v}.ln") + lin(f"{v}.pw1_w", f"{v}.pw1_b", D, 2 * D)
        out += [(f"{v}.dw_w", (D, k), "u", k ** -0.5), (f"{v}.dw_b", (D,), "u", k ** -0.5),
                (f"{v}.bn_mean", (D,), "u", 0.1), (f"{v}.bn_var", (D,), "one", 0.5),
                (f"{v}.bn_g", (D,), "one", 0.1), (f"{v}.bn_b", (D,), "u", 0.1)]
        out += lin(f"{v}.pw2_w", f"{v}.pw2_b", D, D) + ln(f"{b}.out_ln")
    for l in range(c["pred_num_layers"]):
        out += [(f"pred.{l}.{n}", shape, "u", P ** -0.5) for n, shape in
                (("w_ih", (P, 4 * P)), ("w_hh", (P, 4 * P)), ("b_ih", (4 * P,)),
                 ("b_hh", (4 * P,)))]
    kj = (D + P) ** -0.5
    out += [("joint.w1_trans", (D, J), "u", kj), ("joint.w1_pred", (P, J), "u", kj),
            ("joint.b1", (J,), "u", kj), ("joint.w2", (J, V), "u", J ** -0.5),
            ("joint.b2", (V,), "u", J ** -0.5)]
    return out


def random_weights(config: dict, device) -> dict:
    """float32 weights from ``config["weight_seed"]``, drawn on ``device`` in
    two calls (one uniform block, the embedding)."""
    shapes = _shapes(config)
    sizes = [math.prod(s) for _, s, _, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(config["weight_seed"]))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    embed = torch.randn((config["num_labels"] - 1, config["pred_hidden_size"]), generator=gen,
                        device=device)
    w: dict = {}
    off = 0
    for (name, shape, law, scale), n in zip(shapes, sizes):
        x = flat[off : off + n].reshape(shape) * scale
        off += n
        *path, leaf = name.split(".")
        d = w
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = x + 1.0 if law == "one" else x
    pred = w["pred"]
    return dict(w, embed=embed,
                blocks=[w["blocks"][str(i)] for i in range(config["num_blocks"])],
                pred=[(pred[str(l)]["w_ih"], pred[str(l)]["w_hh"],
                       pred[str(l)]["b_ih"] + pred[str(l)]["b_hh"])
                      for l in range(config["pred_num_layers"])])


def apply_emission(weights: dict, emission: dict, config: dict) -> dict:
    """The cell's emission model (benchmark/emission.py) on the float32
    weights; the blank is the last label."""
    return emission_models.apply(weights, emission, config["num_labels"] - 1)


# --------------------------------------------------------------------------
# the program's objects
# --------------------------------------------------------------------------

PARAM_KEYS = ("d_model", "num_blocks", "n_heads", "ff_expansion", "conv_kernel_size",
              "conv_channels", "subsampling_factor", "pred_hidden_size", "pred_num_layers",
              "joint_hidden_size", "num_labels", "max_res_len")


def program_params(config: dict, max_symbols_per_step: int = 1):
    from rnnt_inference_tpu_torch.config import ConformerParams

    return ConformerParams(**{k: config[k] for k in PARAM_KEYS},
                           n_mels=config["featurizer"]["n_mels"],
                           BLANK=config["num_labels"] - 1,
                           max_symbols_per_step=max_symbols_per_step)


def program_featurizer(config: dict):
    from rnnt_inference_tpu_torch.config import FeaturizerConfig

    return FeaturizerConfig(**config["featurizer"])


def program_weights(w: dict, config: dict):
    from rnnt_inference_tpu_torch.models.conformer import weights_from_dict

    if set(config["precision"].values()) != {"bf16"}:
        raise ValueError(f"no program path for precision {config['precision']}")
    return weights_from_dict(w, program_params(config), torch.bfloat16)


def program(config: dict, weights: dict, device, max_symbols_per_step: int):
    """(served ConformerWeights, ConformerParams, FeaturizerConfig)."""
    return (program_weights(weights, config), program_params(config, max_symbols_per_step),
            program_featurizer(config))


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------


def reference(config: dict, weights: dict, device, lower: bool = False):
    """The plain Conformer-Transducer of the file the configuration's
    "reference" names (in this module's checkout)."""
    path = REPO / config["reference"]
    ref = from_file(path, f"benchmark.reference.{path.stem}")
    return ref.ConformerTransducer(weights, config, device, lower=lower)


# --------------------------------------------------------------------------
# work and least times
# --------------------------------------------------------------------------


def _enc_len(frames: np.ndarray) -> np.ndarray:
    l1 = (frames - 1) // 2 + 1
    return (l1 - 1) // 2 + 1


def work(config: dict, params, featurizer, lens, tokens, reps: int) -> Dict[str, float]:
    """Feature frames, encoder frames, symbols and the sum of squared encoder
    lengths (the attention's pairs) of ``reps`` reps."""
    frames = np.array([featurizer.num_frames(int(s)) for s in lens], np.int64)
    post = _enc_len(frames).astype(np.float64)
    syms = np.array([len(t) for t in tokens], np.float64)
    return dict(frames=float(frames.sum()) * reps, post_frames=post.sum() * reps,
                symbols=syms.sum() * reps, attention_pairs=float((post ** 2).sum()) * reps)


def decode_iteration_ops(c: dict) -> float:
    """One decode iteration of one lane, the products kernel B computes: the
    prediction net's h W_hh on every layer and x W_ih above the first, and
    the joint (g W1p, z W2).  The first layer's x W_ih + b is a row of the
    eproj table, made once per weight (ops/decode_cuda.py), so it is read
    and not computed."""
    P, J, V, L = (c["pred_hidden_size"], c["joint_hidden_size"], c["num_labels"],
                  c["pred_num_layers"])
    return 2.0 * ((2 * L - 1) * P * 4 * P + P * J + J * V)


def decode_costs(config: dict) -> dict:
    """Kernel B's costs: a lane-iteration's operations, the weights read a
    launch (the prediction net's and the joint's matrices in the joint's
    type, with the f32 eproj table, V rows of 4 P, in place of the
    embedding and the first layer's W_ih), the joint's hoisted projection
    of a frame read in f32."""
    c, prec = config, config["precision"]["joint"]
    P, J, V, L = (c["pred_hidden_size"], c["joint_hidden_size"], c["num_labels"],
                  c["pred_num_layers"])
    weight_bytes = ITEM[prec] * ((2 * L - 1) * P * 4 * P + P * J + J * V) + 4 * V * 4 * P
    return dict(iteration_ops=decode_iteration_ops(c), weight_bytes=weight_bytes,
                frame_bytes=J * 4, precision=prec)


def subsampling_ops(c: dict, frames: float, post_frames: float) -> float:
    """The subsampling's products: conv1 at each of its output positions
    (about frames / 2 times F1 bins), conv2 at each encoder frame's F' bins,
    and the Linear."""
    D, C, _, F2, *_ = _dims(c)
    F1 = (c["featurizer"]["n_mels"] - 1) // 2 + 1
    return 2.0 * (frames / 2 * F1 * C * 9 + post_frames * F2 * C * C * 9 + post_frames * C * F2 * D)


def block_ops(c: dict, post_frames: float, attention_pairs: float) -> float:
    """One block's products over ``post_frames`` encoder frames: the two FF
    modules, q k v and the output, the pointwise convolutions, the
    depthwise one, and the attention core (6 T^2 D a block: (q + u) k,
    (q + v) p, . v)."""
    D, _, k, _, FF, *_ = _dims(c)
    per_frame = 2 * (2 * 2 * D * FF) + 2 * (4 * D * D) + 2 * (2 * D * D + D * D) + 2 * D * k
    return post_frames * per_frame + 6.0 * attention_pairs * D


def model_least(c: dict, w: Dict[str, float]) -> float:
    """The least time of the model's products for the work ``w``, each at
    its precision's peak."""
    prec = c["precision"]
    enc = (subsampling_ops(c, w["frames"], w["post_frames"])
           + c["num_blocks"] * block_ops(c, w["post_frames"], w["attention_pairs"]))
    fproj = 2.0 * w["post_frames"] * c["d_model"] * c["joint_hidden_size"]
    dec = (w["post_frames"] + w["symbols"]) * decode_iteration_ops(c) + fproj
    return enc / PEAK_OPS[prec["encoder"]] + dec / PEAK_OPS[prec["joint"]]


def least(config: dict, work: Dict[str, float]) -> float:
    return model_least(config, work)


# --------------------------------------------------------------------------
# the kernels' calls
# --------------------------------------------------------------------------


@contextlib.contextmanager
def recording():
    """Shapes of the calls into kernels E and F while the block runs:
    {"kernel_e": [(M, K, N, bias, out dtype)], "kernel_f": [(utterance
    lengths, heads, d_head)]}; a call is recorded when it launched."""
    from rnnt_inference_tpu_torch.ops import attention_cuda, projection_cuda

    calls: Dict[str, list] = {"kernel_e": [], "kernel_f": []}
    e, f = projection_cuda.project_cuda, attention_cuda.rel_attention_cuda

    def rec_e(x, w, b=None):
        launched = rec_e.launches
        out = e(x, w, b)
        if rec_e.launches > launched:
            K, N = w.shape
            calls["kernel_e"].append((x.numel() // K, K, N, b is not None,
                                      "bf16" if out.dtype == torch.bfloat16 else "f32"))
        return out

    def rec_f(q, k, v, u, vb, pos, seg):
        launched = rec_f.launches
        out = f(q, k, v, u, vb, pos, seg)
        if rec_f.launches > launched:
            calls["kernel_f"].append((tuple(int(n) for n in seg.lens_host), u.shape[0],
                                      u.shape[1]))
        return out

    # each wrapper counts its launches on the module's name for it, which is
    # the recorder while it stands in: carry the counts over and back
    rec_e.launches, rec_f.launches = e.launches, f.launches
    projection_cuda.project_cuda, attention_cuda.rel_attention_cuda = rec_e, rec_f
    try:
        yield calls
    finally:
        projection_cuda.project_cuda, attention_cuda.rel_attention_cuda = e, f
        e.launches, f.launches = rec_e.launches, rec_f.launches


# --------------------------------------------------------------------------
# emission calibration
# --------------------------------------------------------------------------


def emission_probe(config: dict, weights: dict, wav: torch.Tensor, lens: np.ndarray, device):
    """The program's encoder (models/conformer.py encode) run once over
    ``wav`` on the program form of ``weights``; returns ``symbols(w, cap)``:
    (symbols, encoder frames) of each utterance under the program's greedy
    decode (models/decoder.py greedy_decode_chunk, kernel B on a card) with
    w's prediction net and joint, cast to the served dtype."""
    from rnnt_inference_tpu_torch.models import conformer
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode_chunk, init_decode_state
    from rnnt_inference_tpu_torch.models.weights import JointWeights, LSTMLayerWeights
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    n = len(lens)
    featurizer = program_featurizer(config)
    with torch.no_grad():
        feats, flens = log_mel_features(wav, torch.as_tensor(lens, device=device), featurizer)
        base, params, _ = program(config, weights, device, 1)
        base = base.to(device)
        outs = conformer.encode(base, feats, flens, params)
    f_lens = torch.as_tensor([o.shape[0] for o in outs], dtype=torch.int32, device=device)
    f = torch.zeros((int(f_lens.max()), n, params.d_model), dtype=base.dtype, device=device)
    for i, o in enumerate(outs):
        f[: o.shape[0], i] = o.to(base.dtype)
    frames = f_lens.cpu().numpy().astype(np.float64)
    cast = lambda t: t.to(base.embed.dtype)

    def symbols(w: dict, cap: int):
        served = dataclasses.replace(
            base, embed=cast(w["embed"]),
            pred_rnn=[LSTMLayerWeights(cast(a), cast(b), c.float()) for a, b, c in w["pred"]],
            joint=JointWeights(w1_trans=cast(w["joint"]["w1_trans"]),
                               w1_pred=cast(w["joint"]["w1_pred"]), b1=w["joint"]["b1"].float(),
                               w2=cast(w["joint"]["w2"]), b2=w["joint"]["b2"].float()))
        p = dataclasses.replace(params, max_symbols_per_step=cap)
        with torch.no_grad():
            st = greedy_decode_chunk(served, init_decode_state(
                n, p, base.dtype, base.dtype, device), f, f_lens, p)
        return (st.res_idx + 1).cpu().numpy().astype(np.float64), frames

    return symbols
