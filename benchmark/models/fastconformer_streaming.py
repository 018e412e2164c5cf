"""NVIDIA NeMo's cache-aware streaming FastConformer-Transducer, Large
(benchmark/configs/nemo_fastconformer_transducer_large_streaming.json): what
of the harness depends on this architecture, reached as ``cell.model``
(benchmark/models/__init__.py gives the interface).  Its one cell is a
Server cell: the program streams it through ServerRunner's slots.

Weights: random float32 weights drawn on the device from the configuration's
weight seed, as a plain dict, the form the reference
(benchmark/reference/fastconformer_streaming.py) takes:
  {"subsampling": {"conv1_w" (C, 1, 3, 3), "conv1_b", "dw1_w" (C, 1, 3, 3),
                   "dw1_b", "pw1_w" (C, C, 1, 1), "pw1_b", "dw2_w", "dw2_b",
                   "pw2_w", "pw2_b", "out_w" (C F3, D), "out_b"},
   "blocks": [{"ff1": FF, "att": as the Conformer-Transducer's,
               "conv": {"ln", "pw1_w" (D, 2D), "pw1_b", "dw_w" (D, k), "dw_b",
                        "norm", "pw2_w", "pw2_b"},
               "ff2": FF, "out_ln"}, ...],
   "embed", "pred", "joint": as the Conformer-Transducer's}
with out_w's rows in NeMo's (channel, frequency) order.  Distributions as
benchmark/models/conformer_transducer.py states them (PyTorch's defaults,
LayerNorm gains 1 + U(+-0.1) and shifts U(+-0.1), the q k v biases, u and v
U(+-0.1)).

The program's objects: FastConformerWeights in bf16
(models/fastconformer.py), ConformerParams with the streaming fields, the
FeaturizerConfig.  Work counts feature frames, encoder frames, symbols and
the attention's pairs under the chunk mask; least times count the
subsampling's and the blocks' products, the prediction net's step and the
joint.  The kernels' calls are recorded by the program itself
(utils/profiler.py ``REGISTRY.calls``, read by the kernel_f_stream and
kernel_g_causal readers), so ``recording`` records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.models import from_file
from benchmark.roofline import PEAK_OPS

REPO = Path(__file__).resolve().parents[2]  # the checkout this module is in
_large = from_file(Path(__file__).with_name("conformer_transducer.py"),
                   "benchmark.models.conformer_transducer")
apply_emission = _large.apply_emission
decode_iteration_ops = _large.decode_iteration_ops
decode_costs = _large.decode_costs


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def _stage_len(n):
    """A causal 3x3 stride-2 stage: L -> L // 2 + 1."""
    return n // 2 + 1


def _dims(c: dict):
    D, C, k = c["d_model"], c["subsampling_conv_channels"], c["conv_kernel_size"]
    F3 = _stage_len(_stage_len(_stage_len(c["featurizer"]["n_mels"])))
    return D, C, k, F3, c["ff_expansion"] * D, c["pred_hidden_size"], c["joint_hidden_size"], \
        c["num_labels"]


def _shapes(c: dict) -> List[Tuple[str, tuple, str, float]]:
    """(leaf, shape, law, scale) of every leaf in draw order, named by its
    path in the weights dict: law "u" is U(+-scale), "one" 1 + U(+-scale)."""
    D, C, k, F3, FF, P, J, V = _dims(c)
    lin = lambda w, b, i, o: [(w, (i, o), "u", i ** -0.5), (b, (o,), "u", i ** -0.5)]
    ln = lambda name: [(f"{name}.g", (D,), "one", 0.1), (f"{name}.b", (D,), "u", 0.1)]
    s = "subsampling"
    out = [(f"{s}.conv1_w", (C, 1, 3, 3), "u", 9 ** -0.5), (f"{s}.conv1_b", (C,), "u", 9 ** -0.5)]
    for n in (1, 2):
        out += [(f"{s}.dw{n}_w", (C, 1, 3, 3), "u", 9 ** -0.5),
                (f"{s}.dw{n}_b", (C,), "u", 9 ** -0.5),
                (f"{s}.pw{n}_w", (C, C, 1, 1), "u", C ** -0.5), (f"{s}.pw{n}_b", (C,), "u", C ** -0.5)]
    out += lin(f"{s}.out_w", f"{s}.out_b", C * F3, D)
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
        out += [(f"{v}.dw_w", (D, k), "u", k ** -0.5), (f"{v}.dw_b", (D,), "u", k ** -0.5)]
        out += ln(f"{v}.norm") + lin(f"{v}.pw2_w", f"{v}.pw2_b", D, D) + ln(f"{b}.out_ln")
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


# --------------------------------------------------------------------------
# the program's objects
# --------------------------------------------------------------------------

PARAM_KEYS = ("d_model", "num_blocks", "n_heads", "ff_expansion", "conv_kernel_size",
              "subsampling_factor", "pred_hidden_size", "pred_num_layers", "joint_hidden_size",
              "num_labels", "max_res_len")


def program_params(config: dict, max_symbols_per_step: int = 1):
    from rnnt_inference_tpu_torch.config import ConformerParams

    return ConformerParams(**{k: config[k] for k in PARAM_KEYS},
                           conv_channels=config["subsampling_conv_channels"],
                           n_mels=config["featurizer"]["n_mels"],
                           BLANK=config["num_labels"] - 1,
                           max_symbols_per_step=max_symbols_per_step,
                           subsampling=config["subsampling"],
                           causal_downsampling=config["causal_downsampling"],
                           att_context_size=tuple(config["att_context_size"]),
                           conv_causal=config["conv_context_size"] == "causal",
                           conv_norm=config["conv_norm_type"])


def program_featurizer(config: dict):
    from rnnt_inference_tpu_torch.config import FeaturizerConfig

    return FeaturizerConfig(**config["featurizer"])


def program_weights(w: dict, config: dict):
    from rnnt_inference_tpu_torch.models.fastconformer import weights_from_dict

    if set(config["precision"].values()) != {"bf16"}:
        raise ValueError(f"no program path for precision {config['precision']}")
    return weights_from_dict(w, program_params(config), torch.bfloat16)


def program(config: dict, weights: dict, device, max_symbols_per_step: int):
    """(served FastConformerWeights, ConformerParams, FeaturizerConfig)."""
    return (program_weights(weights, config), program_params(config, max_symbols_per_step),
            program_featurizer(config))


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------


def reference(config: dict, weights: dict, device, lower: bool = False):
    """The plain streaming FastConformer-Transducer of the file the
    configuration's "reference" names (in this module's checkout)."""
    path = REPO / config["reference"]
    ref = from_file(path, f"benchmark.reference.{path.stem}")
    return ref.FastConformerStreaming(weights, config, device, lower=lower)


# --------------------------------------------------------------------------
# work and least times
# --------------------------------------------------------------------------


def enc_len(frames: np.ndarray) -> np.ndarray:
    """Encoder frames of utterances of ``frames`` feature frames (three causal
    stages)."""
    frames = np.asarray(frames, np.int64)
    return np.where(frames > 0, _stage_len(_stage_len(_stage_len(frames))), 0)


def masked_pairs(config: dict, T: int) -> int:
    """The (query, key) pairs the chunked-limited mask lets an utterance of
    T encoder frames attend: chunk c's rows against the keys of chunks c -
    left .. c that exist."""
    left, right = config["att_context_size"]
    C = right + 1
    L = left // C
    total = 0
    for c in range(-(-T // C)):
        rows = min(T, C * (c + 1)) - C * c
        total += rows * (min(T, C * (c + 1)) - C * max(0, c - L))
    return total


def work(config: dict, params, featurizer, lens, tokens, reps: int) -> Dict[str, float]:
    """Feature frames, encoder frames, symbols and the attention's pairs
    under the chunk mask of ``reps`` reps."""
    frames = np.array([featurizer.num_frames(int(s)) for s in lens], np.int64)
    post = enc_len(frames)
    syms = np.array([len(t) for t in tokens], np.float64)
    pairs = sum(masked_pairs(config, int(t)) for t in post)
    return dict(frames=float(frames.sum()) * reps, post_frames=float(post.sum()) * reps,
                symbols=syms.sum() * reps, attention_pairs=float(pairs) * reps)


def subsampling_ops(c: dict, frames: float, post_frames: float) -> float:
    """The subsampling's products: conv1 (9 taps a channel) at each of its
    output positions (about frames / 2 times F1 bins), each depthwise stage
    (9 taps) and its pointwise product at its outputs (about frames / 4
    times F2, then the encoder frames times F3), and the Linear."""
    D, C, _, F3, *_ = _dims(c)
    F1 = _stage_len(c["featurizer"]["n_mels"])
    F2 = _stage_len(F1)
    s2, s3 = frames / 4 * F2, post_frames * F3
    return 2.0 * (frames / 2 * F1 * C * 9 + (s2 + s3) * (C * 9 + C * C) + post_frames * C * F3 * D)


def block_ops(c: dict, post_frames: float, attention_pairs: float) -> float:
    """One block's products over ``post_frames`` encoder frames: the two FF
    modules, q k v and the output, the pointwise convolutions, the
    depthwise one, and the attention core (6 d_model a pair the mask
    keeps: (q + u) k, (q + v) p, . v)."""
    D, _, k, _, FF, *_ = _dims(c)
    per_frame = 2 * (2 * 2 * D * FF) + 2 * (4 * D * D) + 2 * (2 * D * D + D * D) + 2 * D * k
    return post_frames * per_frame + 6.0 * attention_pairs * D


def least(config: dict, w: Dict[str, float]) -> float:
    """The least time of the model's products for the work ``w``, each at
    its precision's peak."""
    c, prec = config, config["precision"]
    enc = (subsampling_ops(c, w["frames"], w["post_frames"])
           + c["num_blocks"] * block_ops(c, w["post_frames"], w["attention_pairs"]))
    fproj = 2.0 * w["post_frames"] * c["d_model"] * c["joint_hidden_size"]
    dec = (w["post_frames"] + w["symbols"]) * decode_iteration_ops(c) + fproj
    return enc / PEAK_OPS[prec["encoder"]] + dec / PEAK_OPS[prec["joint"]]


# --------------------------------------------------------------------------
# the kernels' calls
# --------------------------------------------------------------------------


@contextlib.contextmanager
def recording():
    """Nothing: the streaming kernels record their calls in the program
    (utils/profiler.py ``REGISTRY.calls``) while the Server driver's profile
    runs, and their readers read that record."""
    yield {}


# --------------------------------------------------------------------------
# emission calibration
# --------------------------------------------------------------------------


def emission_probe(config: dict, weights: dict, wav: torch.Tensor, lens: np.ndarray, device):
    """The program's streaming encoder (models/fastconformer.py encode, chunk
    by chunk with its caches) run once over ``wav`` on the program form of
    ``weights``; returns ``symbols(w, cap)``: (symbols, encoder frames) of
    each utterance under the program's greedy decode (models/decoder.py
    greedy_decode_chunk, kernel B on a card) with w's prediction net and
    joint, cast to the served dtype."""
    from rnnt_inference_tpu_torch.models import fastconformer
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode_chunk, init_decode_state
    from rnnt_inference_tpu_torch.models.weights import JointWeights, LSTMLayerWeights
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    n = len(lens)
    featurizer = program_featurizer(config)
    with torch.no_grad():
        feats, flens = log_mel_features(wav, torch.as_tensor(lens, device=device), featurizer)
        base, params, _ = program(config, weights, device, 1)
        base = base.to(device)
        outs = fastconformer.encode(base, feats, flens, params)
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


# --------------------------------------------------------------------------
# the streaming kernels' traced calls (the kernel_f_stream and
# kernel_g_causal readers)
# --------------------------------------------------------------------------


def profiled_calls(kernel: str) -> list:
    """The program's record of ``kernel``'s calls during its last profile
    (utils/profiler.py ``REGISTRY.calls``): the record's last run of
    consecutive launch numbers, so every launch of that profile is in it.
    Empty for a program that keeps no such record."""
    try:
        from rnnt_inference_tpu_torch.utils.profiler import REGISTRY
    except ImportError:
        return []
    ring = getattr(REGISTRY, "calls", {}).get(kernel)
    calls = list(ring) if ring else []
    i = len(calls) - 1
    while i > 0 and calls[i - 1]["launch"] == calls[i]["launch"] - 1:
        i -= 1
    return calls[max(i, 0):]


def traced_kernel(trace, name: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds ``name`` in the
    whole profile, each launched while it ran: a kernel whose launch (its
    correlation id) is not among the profile's host events was enqueued
    before the profile began and is left out."""
    launched = {e.get("args", {}).get("correlation") for e in trace.events
                if e.get("cat") == "cuda_runtime"}
    n, us = 0, 0.0
    for e in trace.device(("kernel",)):
        if name in e.get("name", "") and e.get("args", {}).get("correlation") in launched:
            n += 1
            us += float(e.get("dur", 0.0))
    return n, us / 1e6


def _host(t, cache: dict) -> np.ndarray:
    key = id(t)
    if key not in cache:
        cache[key] = t.cpu().numpy().astype(np.int64)
    return cache[key]


def stream_f_least(calls) -> float:
    """Least seconds of kernel F's streaming calls: per slot and head 6 q k d
    operations (q the chunk's rows inside the utterance, k the rows of the
    last R chunks inside it: the pairs the mask keeps) at the bf16 peak,
    against q, the seen K and V rows and the C output rows (every row of a
    slot's chunk is written) in bf16 and the band once a call."""
    from benchmark.roofline import least as bound

    total, cache = 0.0, {}
    for c in calls:
        chunk, L = _host(c["chunk"], cache), _host(c["enc_len"], cache)
        C, R, H, d = c["chunk_rows"], c["ring"], c["heads"], c["d_head"]
        lo = C * chunk
        q = np.clip(L - lo, 0, C)
        k = np.where(q > 0, np.minimum(L, lo + C) - C * np.maximum(0, chunk - (R - 1)), 0)
        ops = 6.0 * float((q * k).sum()) * d * H
        nbytes = 2.0 * H * d * (float(q.sum()) + 2.0 * float(k.sum()) + C * len(chunk)
                                + c["band_rows"])
        total += bound(ops, nbytes, "bf16")
    return total


def stream_g_least(calls) -> float:
    """Least seconds of kernel G's causal calls: the slots' rows in and out,
    their cache rows in and out (bf16), the taps (bf16), bias and LayerNorm
    (f32) once; 2 K operations an element at the f32 peak, far below the
    bytes."""
    from benchmark.roofline import least as bound

    total = 0.0
    for c in calls:
        N, C, K1, D, K = c["slots"], c["chunk_rows"], c["cache_rows"], c["channels"], c["taps"]
        nbytes = 2.0 * D * (2 * N * C + 2 * N * K1 + K) + 4.0 * 3 * D
        total += bound(2.0 * K * N * C * D, nbytes, "f32")
    return total
