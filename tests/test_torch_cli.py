"""The port's CLI (rnnt_inference_tpu_torch.main) against the JAX package's
(rnnt_inference_tpu.main): the staged flow calibrate -> quantize -> Offline
run, at full model dims on a tiny synthetic store, both packages reading the
same JAX-written weights npz (or the same zenodo-layout rnnt.pt), and the
--manifest and --native_loadgen options.  The port runs with --device cpu
(the plain twins of its kernels).

Tolerances: calibration amaxes within 1e-5 relative (f32 encoder, matmul
summation order); f32 and quant accuracy logs byte-equal; bf16 hypotheses
equal and the bf16 encoder output within 2**-8 (one bf16 step below 1).

Random full-width weights leave the joint's logits within a few hundredths
of each other, so at some steps the top two differ by less than what one
bf16 rounding of the prediction net or joint moves them, and a rounding that
falls the other way in one package's summation order moves a token (about
half of the 3-utterance stores of seeds 1-12 show one in bf16 or quant
mode; f32 shows none).  The store of seed 2 has no such step; the
comparisons stay exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.data.dataset import SampleStore as JSampleStore
from rnnt_inference_tpu.main import main as jmain
from rnnt_inference_tpu.models import checkpoint as jckpt
from rnnt_inference_tpu.models import rnnt as jrnnt
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.main import main as tmain
from rnnt_inference_tpu_torch.models import checkpoint as tckpt
from rnnt_inference_tpu_torch.models import rnnt as trnnt

torch.set_num_threads(1)  # tier-1 runs several pytest workers


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A tiny store (JAX-written), JAX f32 weights at full dims, and each
    package's calibration + quantization of them."""
    d = tmp_path_factory.mktemp("cli")
    store = JSampleStore.synthetic(n=3, seed=2, min_seconds=0.3, max_seconds=0.6,
                                   mean_seconds=0.4)
    store.transcripts = ["hello world"] * 3
    paths = {k: str(d / f"{k}.npz") for k in (
        "store", "weights", "jcalib", "tcalib", "jquant", "tquant")}
    store.save(paths["store"])
    jckpt.save_weights(paths["weights"], jinit_weights(jax.random.PRNGKey(0), JParams()))
    common = ["--model", paths["weights"], "--run_mode", "f32", "--calibration",
              "--calib_file", paths["store"], "--save_quant", "--batch_size", "4"]
    jmain(common + ["--calib_out", paths["jcalib"], "--quant_out", paths["jquant"]])
    tmain(common + ["--calib_out", paths["tcalib"], "--quant_out", paths["tquant"],
                    "--device", "cpu"])
    return d, paths


def _run(main, paths, out_dir, extra):
    """One Offline run through a CLI; returns (accuracy log text, summary)."""
    main(extra + ["--scenario", "Offline", "--sample_file", paths["store"],
                  "--batch_size", "4", "--output_dir", out_dir])
    with open(os.path.join(out_dir, "accuracy_log.json")) as f:
        log = f.read()
    with open(os.path.join(out_dir, "summary.json")) as f:
        return log, json.load(f)


def test_calibration_matches_jax(staged):
    _, paths = staged
    j = jckpt.load_calib(paths["jcalib"])
    t = tckpt.load_calib(paths["tcalib"], device="cpu")
    for a, b in ((j.pre_amax, t.pre_amax), (j.post_amax, t.post_amax)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)


def test_quant_npz_loads_across_packages(staged):
    """Each package loads the other's quantized model: the int8 weights are
    equal where the amaxes agree, and every leaf has the same dtype and
    shape."""
    _, paths = staged
    jq = jckpt.load_quant_weights(paths["jquant"], JParams())
    tq_from_j = tckpt.load_quant_weights(paths["jquant"], RNNTParams(), device="cpu")
    jq_from_t = jckpt.load_quant_weights(paths["tquant"], JParams())
    tq = tckpt.load_quant_weights(paths["tquant"], RNNTParams(), device="cpu")
    jl, jlt = jax.tree.flatten(jq)[0], jax.tree.flatten(jq_from_t)[0]
    from rnnt_inference_tpu_torch.models.weights import numpy_leaves

    for a, b in zip(jl, numpy_leaves(tq_from_j)):
        np.testing.assert_array_equal(np.asarray(a).view(b.dtype), b)
    for a, b in zip(numpy_leaves(tq), jlt):
        np.testing.assert_array_equal(a, np.asarray(b).view(a.dtype))
    for a, b in zip(jl, jlt):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("mode", ["f32", "bf16", "quant"])
def test_benchmark_run_matches_jax(staged, mode):
    """The staged flow's last stage, --benchmark (device-resident samples,
    int16 staging; the accuracy log is written too) in each run mode, the
    quant run on the JAX-quantized model: f32 and quant accuracy logs
    byte-equal, bf16 hypotheses equal.  (--accuracy runs are compared at
    small width in tests/test_torch_runtime.py.)"""
    d, paths = staged
    extra = (["--quant_in", paths["jquant"]] if mode == "quant"
             else ["--model", paths["weights"], "--run_mode", mode])
    extra += ["--benchmark"]
    jlog, jsum = _run(jmain, paths, str(d / f"j_{mode}"), extra)
    tlog, tsum = _run(tmain, paths, str(d / f"t_{mode}"), extra + ["--device", "cpu"])
    if mode != "bf16":
        assert tlog == jlog
    hyp = lambda log: [e["data"] for e in sorted(json.loads(log), key=lambda e: e["qsl_idx"])]
    assert hyp(tlog) == hyp(jlog)
    assert tsum["samples"] == jsum["samples"] == 3 and tsum["batches"] == jsum["batches"]


def test_bf16_encoder_matches_jax(staged):
    """The bf16 encoder (kernel C's twin) on the same features: within 2**-8."""
    _, paths = staged
    jw = jckpt.load_weights(paths["weights"], JParams()).astype(jnp.bfloat16)
    tw = tckpt.load_weights(paths["weights"], RNNTParams(), device="cpu").to(dtype=torch.bfloat16)
    rng = np.random.RandomState(3)
    x = rng.randn(12, 2, 240).astype(np.float32)
    lens = np.array([12, 9], np.int32)
    jf, _ = jrnnt.transcription(jw, jnp.asarray(x), jnp.asarray(lens),
                                jrnnt.init_encoder_state(2, JParams(), jnp.bfloat16))
    tf, _ = trnnt.transcription(tw, torch.from_numpy(x), torch.from_numpy(lens),
                                trnnt.init_encoder_state(2, RNNTParams(), torch.bfloat16, "cpu"))
    np.testing.assert_allclose(tf.float().numpy(), np.asarray(jf.astype(jnp.float32)),
                               atol=2 ** -8)


def test_store_written_by_port_loads_in_jax(tmp_path):
    store = SampleStore.synthetic(n=3, seed=4, min_seconds=0.3, max_seconds=0.6)
    store.transcripts = ["a b", "c", ""]
    p = str(tmp_path / "s.npz")
    store.save(p)
    back = JSampleStore.load(p)
    assert back.kind == store.kind and back.transcripts == store.transcripts
    assert back.names == store.names
    for a, b in zip(back.samples, store.samples):
        np.testing.assert_array_equal(a, b)


def test_fake_quant_run_matches_jax(staged):
    """--run_mode fake_quant --calib_in on the same weights, calibration and
    store (--accuracy: every utterance once): the accuracy log byte-equal
    to the JAX CLI's; without --calib_in both refuse."""
    d, paths = staged
    extra = ["--model", paths["weights"], "--run_mode", "fake_quant", "--calib_in",
             paths["jcalib"], "--accuracy"]
    jlog, _ = _run(jmain, paths, str(d / "j_fake_quant"), extra)
    tlog, tsum = _run(tmain, paths, str(d / "t_fake_quant"), extra + ["--device", "cpu"])
    assert tlog == jlog and len(json.loads(tlog)) == 3 and tsum["samples"] == 3
    for main in (jmain, tmain):
        with pytest.raises(SystemExit, match="requires --calib_in"):
            main(["--model", paths["weights"], "--run_mode", "fake_quant", "--accuracy",
                  "--sample_file", paths["store"], "--output_dir", str(d / "no_calib")]
                 + (["--device", "cpu"] if main is tmain else []))


def test_profiler_dir_writes_a_cpu_trace(staged, tmp_path):
    """--profiler_dir on the CPU: a chrome trace of the benchmark stage with
    the host's operators and one timed-rep span, from which the idle share
    of a category can be read (on the card, of its kernels)."""
    from rnnt_inference_tpu_torch.utils import profiler

    _, paths = staged
    trace_dir = tmp_path / "trace"
    _run(tmain, paths, str(tmp_path / "out"),
         ["--model", paths["weights"], "--run_mode", "f32", "--benchmark",
          "--profiler_dir", str(trace_dir), "--device", "cpu"])
    events = profiler.load_trace(str(trace_dir / profiler.TRACE_FILE))
    assert any(e.get("cat") == "cpu_op" for e in events)
    spans = profiler.device_idle_share(events, cats=("cpu_op",))
    assert len(spans) == 1 and spans[0]["window_us"] > 0
    assert 0.0 <= spans[0]["idle_share"] < 1.0


@pytest.mark.parametrize("scenario", ["packed", "server"])
def test_packed_and_server_runs_match_jax(staged, scenario):
    """The CLI's sequence-packed Offline run (--packed --benchmark) and its
    Server scenario (--accuracy: every query once, issued as fast as the
    slots take them) on the JAX-quantized model: accuracy logs byte-equal
    to the JAX CLI's."""
    d, paths = staged
    extra = ["--quant_in", paths["jquant"], "--sample_file", paths["store"], "--batch_size", "4"]
    extra += (["--packed", "--benchmark", "--scenario", "Offline"] if scenario == "packed"
              else ["--accuracy", "--scenario", "Server", "--server_slots", "4"])
    logs = []
    for main, tag, dev in ((jmain, "j", []), (tmain, "t", ["--device", "cpu"])):
        out = str(d / f"{tag}_{scenario}")
        main(extra + ["--output_dir", out] + dev)
        with open(os.path.join(out, "accuracy_log.json")) as f:
            logs.append(f.read())
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
    assert logs[1] == logs[0]
    assert len(json.loads(logs[1])) == 3
    if scenario == "packed":
        assert summary["pack_chunks"] > 0 and 0 < summary["packing_efficiency"] <= 1
    else:
        assert summary["completed"] == 3 and summary["latency_ms_p50"] is not None


def test_pt_checkpoint_run_matches_jax(staged):
    """--model rnnt.pt (f32 --benchmark; the accuracy log is written too) on
    a zenodo-layout checkpoint of the staged weights: the accuracy log
    byte-equal to the JAX CLI's on the same file."""
    from rnnt_inference_tpu_torch.models.weights import torch_state_dict_from_weights

    d, paths = staged
    pt = str(d / "rnnt.pt")
    w = tckpt.load_weights(paths["weights"], RNNTParams(), device="cpu")
    torch.save({"state_dict": torch_state_dict_from_weights(w)}, pt)
    extra = ["--model", pt, "--run_mode", "f32", "--benchmark"]
    jlog, _ = _run(jmain, paths, str(d / "j_pt"), extra)
    tlog, tsum = _run(tmain, paths, str(d / "t_pt"), extra + ["--device", "cpu"])
    assert tlog == jlog and len(json.loads(tlog)) == 3 and tsum["samples"] == 3


def test_manifest_wer_matches_jax(staged):
    """--manifest replaces the store's transcripts (utterances up to 15 s,
    normalized): the WER of a packed --accuracy run (scripts/run.sh stage
    5) equals the JAX CLI's, and moves from the store's own transcripts'
    (the first manifest transcript is the first hypothesis, upper-cased, so
    it scores no error)."""
    from rnnt_inference_tpu_torch.runtime.harness import hex_to_tokens
    from rnnt_inference_tpu_torch.utils.labels import seq_to_sen

    d, paths = staged
    base = ["--quant_in", paths["jquant"], "--accuracy", "--packed"]
    own_log, own = _run(tmain, paths, str(d / "t_no_manifest"), base + ["--device", "cpu"])
    first = next(e for e in json.loads(own_log) if e["qsl_idx"] == 0)
    hyp0 = seq_to_sen(hex_to_tokens(first["data"]))
    assert hyp0.strip()
    manifest = d / "m.json"
    manifest.write_text(json.dumps([
        {"audio_filepath": f"u{i}.wav", "duration": 0.5, "transcript": t}
        for i, t in enumerate([hyp0.upper(), "the 3rd of may", "it's DR. SMITH"])]))
    extra = base + ["--manifest", str(manifest)]
    _, jsum = _run(jmain, paths, str(d / "j_manifest"), extra)
    _, tsum = _run(tmain, paths, str(d / "t_manifest"), extra + ["--device", "cpu"])
    assert tsum["wer_percent"] == jsum["wer_percent"] != own["wer_percent"]


NATIVE_SUMMARY_KEYS = ["scenario", "samples", "completed", "issued", "performance_sample_count",
                       "queries", "cycles", "timing", "result_validity"]


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_native_offline_summary_matches_jax(staged, packed):
    """--native_loadgen --benchmark Offline under tests/test_main.py's conf
    (performance_sample_count 3, min_query_count 7, min_duration 0, qps 10)
    on the JAX-quantized model: the summary's query accounting equals the
    JAX CLI's (timings aside), bucketed and --packed."""
    d, paths = staged
    conf = d / "native_offline.conf"
    conf.write_text("rnnt.*.performance_sample_count_override = 3\n"
                    "rnnt.Offline.min_query_count = 7\n"
                    "rnnt.Offline.min_duration = 0\n"
                    "rnnt.Offline.target_qps = 10\n")
    extra = ["--quant_in", paths["jquant"], "--benchmark", "--native_loadgen", "--user_conf",
             str(conf), "--sample_file", paths["store"], "--batch_size", "4"]
    extra += ["--packed"] if packed else []
    keys = NATIVE_SUMMARY_KEYS + (["packed", "pack_chunks", "chunk_frames",
                                   "packing_efficiency"] if packed else [])
    summaries = []
    for main, tag, dev in ((jmain, "j", []), (tmain, "t", ["--device", "cpu"])):
        out = str(d / f"{tag}_native_{packed}")
        main(extra + ["--output_dir", out] + dev)
        with open(os.path.join(out, "summary.json")) as f:
            summaries.append(json.load(f))
    assert {k: summaries[1][k] for k in keys} == {k: summaries[0][k] for k in keys}
    assert summaries[1]["completed"] == 7 and summaries[1]["timing"] == "native"


@pytest.mark.parametrize("scenario", ["Server", "SingleStream"])
def test_native_latency_scenarios_run(staged, scenario):
    """--native_loadgen --benchmark in Server (Poisson at 50 QPS) and
    SingleStream (issue after complete), min_query_count 4 over the
    3-utterance store: a valid summary with every issued query completed
    and the live latency percentiles."""
    d, paths = staged
    conf = d / f"native_{scenario}.conf"
    conf.write_text(f"rnnt.{scenario}.min_query_count = 4\n"
                    f"rnnt.{scenario}.min_duration = 0\n"
                    f"rnnt.{scenario}.target_qps = 50\n"
                    f"rnnt.{scenario}.target_latency = 60000\n")
    out = str(d / f"t_native_{scenario}")
    ret = tmain(["--quant_in", paths["jquant"], "--benchmark", "--native_loadgen", "--scenario",
                 scenario, "--user_conf", str(conf), "--sample_file", paths["store"],
                 "--server_slots", "4", "--output_dir", out, "--device", "cpu"])
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["scenario"] == scenario and summary["result_validity"] == "VALID"
    assert summary["completed"] >= 4
    assert 0 < summary["latency_ms_p50"] <= summary["latency_ms_p90"] <= summary["latency_ms_p99"]
    if scenario == "Server":
        report, results = ret
        assert report["issued"] == report["completed"] == len(results)
        assert report["launches"]["quant_lstm_layer"] == 0  # the CPU runs the twins
    else:
        assert ret.extra["completed"] == ret.extra["issued"] == 4 and len(ret.hypotheses) == 3
