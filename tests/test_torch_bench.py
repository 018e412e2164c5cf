"""The port's bench (rnnt_inference_tpu_torch/bench.py) against the JAX
package's (bench.py at the repository root), on the CPU at the golden
bundle's small width: the delta bisection, the blank and burst emission
models replayed from fixed values, the blank calibration's landing band,
the one-line payload, every knob value other than the defaults, and the
error line without a card.

Tolerance: the biased weights bit-equal (both form each change in f32 and
round once to the weight type, and build the burst map with the same
numpy calls); evaluated deltas equal.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu_torch import bench
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.models.decoder import greedy_decode
from rnnt_inference_tpu_torch.models.weights import numpy_leaves, weights_from_numpy_leaves

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jbench():
    """The JAX bench module.  Its import points JAX's persistent compilation
    cache into the checkout; the previous settings are put back at once."""
    prev = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def quant_models():
    """The bench's int8 model at small width, both packages on the same
    values: f32 weights (seed 0), calibrated on 8 random feature rows,
    quantized (prediction net and joint in bf16)."""
    w32 = jinit_weights(jax.random.PRNGKey(0), JP, dtype=jnp.float32)
    x = np.random.RandomState(1).randn(16, 8, 240).astype(np.float32)
    wq = jquantize_weights(
        w32, jcalibrate(w32, [(jnp.asarray(x), jnp.full((8,), 16, jnp.int32))], JP), JP)
    port = weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(wq)[0]],
                                     "rnnt_quant_weights", TP, "cpu")
    return wq, port


def _assert_leaves_equal(jw, tw):
    for a, b in zip(jax.tree.flatten(jw)[0], numpy_leaves(tw), strict=True):
        np.testing.assert_array_equal(b, np.asarray(a).view(b.dtype))


@pytest.mark.parametrize("fn,target", [
    (lambda d: 2.0 if d < 0.37 else 0.5, 0.8),
    (lambda d: float(np.floor(8 - d) / 4), 0.8),
    (lambda d: 3.0 / (1.0 + np.exp(d - 100.0)), 1.2),
    (lambda d: 0.1, 0.8),
], ids=["one_cliff", "staircase", "wide_bracket", "never_reached"])
def test_bisect_delta_matches_jax(jbench, fn, target):
    """The same deltas evaluated in the same order, and the same result."""
    logs = []
    for mod in (jbench, bench):
        seen = []

        def rate(d, seen=seen):
            seen.append(d)
            return fn(d)

        logs.append((mod._bisect_delta(rate, target, iters=12), seen))
    assert logs[0] == logs[1]


@pytest.mark.parametrize("fixed", ["2:0.8125", "-1.5"])
def test_blank_bias_fixed_matches_jax(jbench, quant_models, fixed):
    """bias_joint_toward_blank replayed from amp:delta (or delta alone):
    every leaf of the biased model bit-equal to the JAX bench's."""
    wq, tq = quant_models
    want = jbench.bias_joint_toward_blank(wq, JP, JFeaturizerConfig(), fixed_delta=fixed)
    got, stats = bench.bias_joint_toward_blank(tq, TP, FeaturizerConfig(), fixed_delta=fixed)
    _assert_leaves_equal(want, got)
    assert stats["fixed"] and stats["delta"] == float(fixed.rpartition(":")[2])


@pytest.mark.parametrize("fixed", ["4:1.25:0.5", "4:-0.375:3"])
def test_burst_bias_fixed_matches_jax(jbench, quant_models, fixed):
    """bias_joint_burst replayed from amp:delta:kappa: the pass-through
    prediction net and the suppression map (numpy pinv of the same values)
    give every leaf bit-equal to the JAX bench's."""
    wq, tq = quant_models
    want = jbench.bias_joint_burst(wq, JP, JFeaturizerConfig(), fixed=fixed)
    got, stats = bench.bias_joint_burst(tq, TP, FeaturizerConfig(), fixed=fixed)
    _assert_leaves_equal(want, got)
    assert float(got.pred_rnn[0].w_hh.float().abs().max()) == 0.0
    assert stats["kappa"] == float(fixed.split(":")[2])


def test_blank_calibration_lands_in_band(quant_models):
    """The measured calibration (bisection on the decode of eight 4 s
    windows, the twins on the CPU) lands within JAX's 2x band of 0.8
    symbols per frame (bench.py:217), and the returned weights decode the
    calibration windows at the logged rate."""
    _, tq = quant_models
    params = RNNTParams(**dict(DIMS, max_res_len=512, max_symbols_per_step=1))
    w, stats = bench.bias_joint_toward_blank(tq, params, FeaturizerConfig())
    assert 0.4 <= stats["sym_per_frame"] <= 1.6, stats
    feats, flens, frames = bench._calibration_features(params, FeaturizerConfig(), 123, "cpu")
    _, rlens = greedy_decode(w, feats, flens, params)
    assert round(float(rlens.sum()) / float(frames.sum()), 3) == stats["sym_per_frame"]


def test_bench_payload_is_one_json_line(monkeypatch, capsys):
    """A whole bench run on the twins at small width (six utterances on two
    lanes, packed, int8, cap 1, a replayed blank bias, at least 0.1 s of
    timed reps): exactly one JSON line on stdout with a positive value and
    its protocol; the decode-iteration line in the log."""
    for k, v in dict(BENCH_N="6", BENCH_BATCH="2", BENCH_MIN_S="0.1",
                     BENCH_BLANK_DELTA="1:0.25").items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"], params=TP) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["metric"] == "offline_audio_seconds_per_second" and payload["value"] > 0
    proto = payload["protocol"]
    assert proto["packed"] and proto["dtype"] == "quant" and proto["max_symbols_per_step"] == 1
    assert proto["reps"] == len(proto["rep_wall_seconds"]) >= 1
    # the loop sums the walls before they are rounded to ms for the payload
    assert sum(proto["rep_wall_seconds"]) >= 0.1 - 0.0005 * proto["reps"]
    assert proto["calibration"]["delta"] == 0.25
    assert set(proto["phase_ms"]) == {"features", "encoder", "decode"}
    assert proto["decode_iterations_model"]["iterations"] > 0
    assert proto["launched_decode_iterations"] == 0  # the twins launch no kernel
    assert "decode iterations (model of the bucketed batch_plan):" in err
    assert "decode iterations (timed rep):" in err and "error" not in payload


KNOB_CASES = {
    # the bucketed device-resident run instead of the packed one
    "unpacked": dict(BENCH_PACKED="0"),
    "bf16": dict(BENCH_DTYPE="bf16"),
    "f32": dict(BENCH_DTYPE="f32", BENCH_PACKED="0"),
    "uniform": dict(BENCH_EMISSION="uniform"),
    "chunks_res_len_buckets": dict(BENCH_PACK_CHUNK="8", BENCH_PACK_DECODE_CHUNK="32",
                                   BENCH_RES_LEN="64", BENCH_SECONDS="2,4,8,15"),
    # the burst model calibrated to other targets at cap 30
    "burst_targets": dict(BENCH_EMISSION="burst", BENCH_SYM_CAP="30", BENCH_BURST_RATE="0.6",
                          BENCH_BURST_FACTOR="1.2"),
    "burst_replay": dict(BENCH_EMISSION="burst", BENCH_SYM_CAP="30",
                         BENCH_BURST_DELTA="4:0.5:1"),
}


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_bench_knob_values_run(monkeypatch, capsys, case):
    """Each knob value other than the defaults drives a whole bench run on
    the twins at small width (six utterances on two lanes, at least 0.05 s
    of timed reps): one JSON line with a positive value, and a protocol
    that records the value the knob set.  The burst calibration to other
    targets runs on the first 24 feature frames of its eight windows (the
    whole 4 s windows take minutes at cap 30 on the CPU; the card test
    runs them whole)."""
    knobs = dict(BENCH_N="6", BENCH_BATCH="2", BENCH_MIN_S="0.05", BENCH_BLANK_DELTA="1:0.25",
                 **KNOB_CASES[case])
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    if case == "burst_targets":  # the measured calibration, on the windows' first 24 frames
        whole = bench._calibration_features

        def first_frames(params, cfg, seed, device, frames=24):
            feats, flens, _ = whole(params, cfg, seed, device)
            flens = torch.clamp(flens, max=frames)
            return feats[:frames], flens, -(-flens.numpy().astype(np.int64)
                                             // params.stack_time_factor)

        monkeypatch.setattr(bench, "_calibration_features", first_frames)
    assert bench.main(["--device", "cpu"], params=TP) == 0
    out, _ = capsys.readouterr()
    (line,) = out.splitlines()
    payload = json.loads(line)
    proto = payload["protocol"]
    assert payload["value"] > 0 and "error" not in payload
    assert proto["packed"] == (knobs.get("BENCH_PACKED", "1") == "1")
    assert proto["dtype"] == knobs.get("BENCH_DTYPE", "quant")
    assert proto["emission"] == knobs.get("BENCH_EMISSION", "blank")
    assert proto["max_symbols_per_step"] == int(knobs.get("BENCH_SYM_CAP", "1"))
    assert proto["max_res_len"] == int(knobs.get("BENCH_RES_LEN", "512"))
    assert proto["pack_chunk"] == int(knobs.get("BENCH_PACK_CHUNK", "16"))
    assert proto["pack_decode_chunk"] == int(knobs.get("BENCH_PACK_DECODE_CHUNK", "128"))
    assert ("pack_chunks" in proto) == proto["packed"]
    assert proto["decode_iterations_model"]["iterations"] > 0
    calib = proto["calibration"]
    if case == "burst_targets":
        assert calib["target"] == 0.6 and calib["target_burst"] == 1.2
        assert 0.3 <= calib["sym_per_frame"] <= 1.2, calib
    elif case == "burst_replay":
        assert calib["fixed"] and (calib["amp"], calib["delta"], calib["kappa"]) == (4, 0.5, 1)
    elif case == "uniform":
        assert set(calib) == {"seconds"}
    else:
        assert calib["fixed"] and calib["delta"] == 0.25


def test_bench_without_card_reports_error():
    """With no CUDA device: exit code 1 and one JSON line carrying "error"
    and value 0 (no earlier result is re-emitted)."""
    r = subprocess.run([sys.executable, "-m", "rnnt_inference_tpu_torch.bench"], cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                       text=True, timeout=120)
    lines = r.stdout.splitlines()
    assert r.returncode == 1 and len(lines) == 1, (r.stdout, r.stderr[-2000:])
    payload = json.loads(lines[0])
    assert payload["value"] == 0 and "CUDA" in payload["error"] and "stale" not in payload
