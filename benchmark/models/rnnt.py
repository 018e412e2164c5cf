"""The MLPerf Inference RNN-T (benchmark/configs/rnnt_mlperf_*.json): what
of the harness depends on this architecture, reached as ``cell.model``
(benchmark/models/__init__.py gives the interface).

Weights: random float32 weights drawn on the device from the
configuration's weight seed, as a plain dict, the form the reference
(benchmark/reference/rnnt.py) takes:
  {"pre": [(w_ih (IC, 4H), w_hh (H, 4H), b (4H,)), ...], "post": [...],
   "embed": (V - 1, P), "pred": [(w_ih, w_hh, b), ...],
   "joint": {"w1_trans" (H, J), "w1_pred" (P, J), "b1" (J,), "w2" (J, V), "b2" (V,)}}
LSTM gates in the order i, f, g, o, one folded bias.  The distributions are
PyTorch's LSTM and Linear defaults: U(+-1/sqrt(H)) for LSTM weights (the bias
a sum of two such draws, b_ih + b_hh), N(0, 1) for the embedding,
U(+-1/sqrt(fan_in)) for the joint.

The program's objects: float RNNTWeights cast to the configuration's
precision, or, for an int8 encoder, the program's own calibration over the
configuration's calibration audio and its quantization; RNNTParams; the
FeaturizerConfig.  Work and least times count the encoder's LSTM products,
the prediction net's step and the joint; the recorder wraps kernels A, C
and E.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import emission as emission_models
from benchmark import traffic
from benchmark.models import from_file
from benchmark.roofline import ITEM, PEAK_OPS

REPO = Path(__file__).resolve().parents[2]  # the checkout this module is in


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


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


def apply_emission(weights: dict, emission: dict, config: dict) -> dict:
    """The cell's emission model (benchmark/emission.py) on the float32
    weights; the blank is the last label."""
    return emission_models.apply(weights, emission, config["num_labels"] - 1)


# --------------------------------------------------------------------------
# the program's objects
# --------------------------------------------------------------------------


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


def program(config: dict, weights: dict, device, max_symbols_per_step: int):
    """(served weights, RNNTParams, FeaturizerConfig): for an int8 encoder
    the calibration runs the program's features over the configuration's
    calibration audio."""
    params = program_params(config, max_symbols_per_step)
    featurizer = program_featurizer(config)
    calib = None
    if config["precision"]["encoder"] == "int8":
        from rnnt_inference_tpu_torch.ops.features import log_mel_features

        pcm, lens = traffic.calibration_audio(config, device)
        wav = (pcm.float() / 32768.0).reshape(len(lens), -1)
        with torch.no_grad():
            calib = log_mel_features(wav, torch.as_tensor(lens, device=device), featurizer)
    return program_weights(weights, config, calib), params, featurizer


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------


def reference(config: dict, weights: dict, device, lower: bool = False):
    """The plain RNNT of the file the configuration's "reference" names (in
    this module's checkout), on the same weights and, for an integer
    encoder, the configuration's calibration audio."""
    path = REPO / config["reference"]
    ref = from_file(path, f"benchmark.reference.{path.stem}")
    calib = []
    if "calibration_audio" in config:
        pcm, lens = traffic.calibration_audio(config, device)
        calib = [torch.from_numpy(w) for w in traffic.host_waveforms(pcm, lens)]
    return ref.RNNT(weights, config, calib, device, lower=lower)


# --------------------------------------------------------------------------
# work and least times
# --------------------------------------------------------------------------


def work(config: dict, params, featurizer, lens, tokens, reps: int) -> Dict[str, float]:
    """Feature frames, stacked frames and symbols of ``reps`` reps of the
    utterances of ``lens`` samples served as ``tokens``."""
    frames = np.array([featurizer.out_frames(int(s)) for s in lens], np.float64)
    post = np.ceil(frames / params.stack_time_factor)
    syms = np.array([len(t) for t in tokens], np.float64)
    return dict(frames=frames.sum() * reps, post_frames=post.sum() * reps,
                symbols=syms.sum() * reps)


def decode_iteration_ops(c: dict) -> float:
    """One decode iteration of one lane: the prediction net's step (every
    layer's x W_ih and h W_hh) and the joint (g W1p, z W2)."""
    P, J, V = c["pred_hidden_size"], c["joint_hidden_size"], c["num_labels"]
    return 2.0 * (c["pred_num_layers"] * 2 * P * 4 * P + P * J + J * V)


def decode_weight_bytes(c: dict, prec: str) -> float:
    P, J, V = c["pred_hidden_size"], c["joint_hidden_size"], c["num_labels"]
    return ITEM[prec] * (c["pred_num_layers"] * 2 * P * 4 * P + (V - 1) * P + P * J + J * V)


def decode_costs(config: dict) -> dict:
    """Kernel B's costs: a lane-iteration's operations, the weights read a
    launch, the joint's hoisted projection of a frame read in f32."""
    prec = config["precision"]["joint"]
    return dict(iteration_ops=decode_iteration_ops(config),
                weight_bytes=decode_weight_bytes(config, prec),
                frame_bytes=config["joint_hidden_size"] * 4, precision=prec)


def encoder_ops(c: dict, frames: float, post_frames: float) -> float:
    """The encoder's products over ``frames`` feature frames (the pre layers)
    and ``post_frames`` stacked frames (the post layers)."""
    H = c["trans_hidden_size"]
    pre_in = [c["trans_input_size"]] + [H] * (c["pre_num_layers"] - 1)
    post_in = [H * c["stack_time_factor"]] + [H] * (c["post_num_layers"] - 1)
    return 2.0 * 4 * H * (frames * sum(ic + H for ic in pre_in)
                          + post_frames * sum(ic + H for ic in post_in))


def model_least(c: dict, frames: float, post_frames: float, symbols: float) -> float:
    """The least time of the model's products (encoder, prediction net,
    joint) for utterances of ``frames`` feature frames, ``post_frames``
    stacked frames and ``symbols`` emitted, each at its precision's peak."""
    prec = c["precision"]
    enc = encoder_ops(c, frames, post_frames) / PEAK_OPS[prec["encoder"]]
    fproj = 2.0 * post_frames * c["trans_hidden_size"] * c["joint_hidden_size"]
    dec = ((post_frames + symbols) * decode_iteration_ops(c) + fproj) / PEAK_OPS[prec["joint"]]
    return enc + dec


def least(config: dict, work: Dict[str, float]) -> float:
    return model_least(config, work["frames"], work["post_frames"], work["symbols"])


# --------------------------------------------------------------------------
# the kernels' calls
# --------------------------------------------------------------------------


@contextlib.contextmanager
def recording():
    """Shapes of the calls into kernels A, C and E while the block runs:
    {"kernel_a": [(T, N, IC, H, f32 out)], "kernel_c": [(T, N, H, dtype)],
    "kernel_e": [(M, K, N, bias, out dtype)]}; an E call is recorded when it
    launched."""
    from rnnt_inference_tpu_torch.ops import lstm_cuda, lstm_scan_cuda, projection_cuda

    calls: Dict[str, list] = {"kernel_a": [], "kernel_c": [], "kernel_e": []}
    a, c = lstm_cuda.quant_lstm_layer_cuda, lstm_scan_cuda.lstm_recurrence_cuda
    e = projection_cuda.project_cuda

    def rec_a(layer, x_i8, h_i8, cell, emit_f32, *args, **kw):
        T, N, IC = x_i8.shape
        calls["kernel_a"].append((T, N, IC, h_i8.shape[1], bool(emit_f32)))
        return a(layer, x_i8, h_i8, cell, emit_f32, *args, **kw)

    def rec_c(layer, xw, h, cell, *args, **kw):
        T, N, G = xw.shape
        calls["kernel_c"].append((T, N, G // 4, "bf16" if xw.dtype == torch.bfloat16 else "f32"))
        return c(layer, xw, h, cell, *args, **kw)

    def rec_e(x, w, b=None):
        launched = rec_e.launches
        out = e(x, w, b)
        if rec_e.launches > launched:
            K, N = w.shape
            calls["kernel_e"].append((x.numel() // K, K, N, b is not None,
                                      "bf16" if out.dtype == torch.bfloat16 else "f32"))
        return out

    # each wrapper counts its launches on the module's name for it, which is
    # the recorder while it stands in: carry the counts over and back
    rec_a.launches, rec_c.launches, rec_e.launches = a.launches, c.launches, e.launches
    lstm_cuda.quant_lstm_layer_cuda, lstm_scan_cuda.lstm_recurrence_cuda = rec_a, rec_c
    projection_cuda.project_cuda = rec_e
    try:
        yield calls
    finally:
        lstm_cuda.quant_lstm_layer_cuda, lstm_scan_cuda.lstm_recurrence_cuda = a, c
        projection_cuda.project_cuda = e
        a.launches, c.launches, e.launches = rec_a.launches, rec_c.launches, rec_e.launches


# --------------------------------------------------------------------------
# emission calibration
# --------------------------------------------------------------------------


def emission_probe(config: dict, weights: dict, wav: torch.Tensor, lens: np.ndarray, device):
    """The program's encoder (models/rnnt.py transcription) run once over
    ``wav`` on the program form of ``weights``; returns ``symbols(w, cap)``:
    (symbols, stacked frames) of each utterance under the program's greedy
    decode (models/decoder.py greedy_decode_chunk, kernel B on a card) with
    w's prediction net and joint, cast to the served dtype."""
    from rnnt_inference_tpu_torch.models import rnnt as model
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode_chunk, init_decode_state
    from rnnt_inference_tpu_torch.models.weights import JointWeights, LSTMLayerWeights
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    n = len(lens)
    featurizer = program_featurizer(config)
    with torch.no_grad():
        feats, flens = log_mel_features(wav, torch.as_tensor(lens, device=device), featurizer)
        base, params, _ = program(config, weights, device, 1)
        enc_dtype = base.pre_rnn[0].w_ih.dtype
        f, _ = model.transcription(base, feats, flens, model.init_encoder_state(
            n, params, enc_dtype, device), params)
    f_lens = -(-flens // params.stack_time_factor)
    frames = f_lens.cpu().numpy().astype(np.float64)
    cast = lambda t: t.to(base.embed.dtype)

    def symbols(w: dict, cap: int):
        served = dataclasses.replace(
            base, embed=cast(w["embed"]),
            pred_rnn=[LSTMLayerWeights(*map(cast, l)) for l in w["pred"]],
            joint=JointWeights(**{k: cast(v) for k, v in w["joint"].items()}))
        p = dataclasses.replace(params, max_symbols_per_step=cap)
        with torch.no_grad():
            st = greedy_decode_chunk(served, init_decode_state(
                n, p, enc_dtype, base.pred_rnn[0].w_ih.dtype, device), f, f_lens, p)
        return (st.res_idx + 1).cpu().numpy().astype(np.float64), frames

    return symbols
