"""The port's native mini-loadgen (runtime/native.py and its own copy of the
C++ source) and the runs it times, against the JAX package's, on the CPU
at the golden bundle's small width (H=64, P=32, J=32).

Every case of tests/test_native.py runs here against the port's
NativeLoadGen and runners; a failed g++ build raises; and the native
Offline (bucketed and packed), Server and SingleStream runs give the JAX
runs' tokens and query accounting on the same numpy weights and store.

Tolerance: tokens equal; completed, issued, queries, cycles and
performance_sample_count equal.  Timings are not compared.
"""

import re
import time

import jax
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.data.dataset import SampleStore as JSampleStore
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.runtime import harness as jharness
from rnnt_inference_tpu.runtime import scheduler as jscheduler
from rnnt_inference_tpu.runtime.server import ServerRunner as JServerRunner
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.ops import cuda_build
from rnnt_inference_tpu_torch.runtime import harness as tharness
from rnnt_inference_tpu_torch.runtime import native
from rnnt_inference_tpu_torch.runtime import scheduler as tscheduler
from rnnt_inference_tpu_torch.runtime.native import NativeLoadGen
from rnnt_inference_tpu_torch.runtime.server import ServerRunner
from rnnt_inference_tpu_torch.utils.labels import seq_to_sen

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
CFG = FeaturizerConfig()


def _stores(n, seed, min_seconds, max_seconds, mean_seconds):
    kw = dict(n=n, seed=seed, min_seconds=min_seconds, max_seconds=max_seconds,
              mean_seconds=mean_seconds)
    return JSampleStore.synthetic(**kw), SampleStore.synthetic(**kw)


@pytest.fixture(scope="module")
def weights():
    """JAX f32 weights at small width and the port's copy."""
    jw = jinit_weights(jax.random.PRNGKey(2), JP)
    tw = weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(jw)[0]],
                                   "rnnt_weights", TP, "cpu")
    return jw, tw


def _server_runner(tw, **kw):
    return ServerRunner(tw, TP, CFG, slots=4, split_len=4, max_frames=64, insert_batch=2,
                        device="cpu", **kw)


# -- the cases of tests/test_native.py, on the port -------------------------


def test_offline_mode_issues_everything_immediately():
    lg = NativeLoadGen(100, target_qps=0.0, mode="Offline")
    got = []
    while len(got) < 100:
        got.extend(lg.poll(max_n=64, timeout_us=100000))
    assert sorted(got) == list(range(100))
    for i in got:
        lg.complete(i)
    assert lg.report()["completed"] == 100
    lg.close()


def test_server_mode_poisson_timing():
    qps, n = 500.0, 200
    lg = NativeLoadGen(n, target_qps=qps, mode="Server", seed=1)
    t0 = time.time()
    got = []
    while len(got) < n and time.time() - t0 < 10:
        ids = lg.poll(max_n=16, timeout_us=10000)
        for i in ids:
            lg.complete(i)
        got.extend(ids)
    wall = time.time() - t0
    assert len(got) == n
    assert 0.2 < wall < 5.0  # ~200 samples at 500 qps: a ~0.4 s schedule
    rep = lg.report()
    assert rep["completed"] == n
    assert rep["latency_ms_p99"] >= rep["latency_ms_p50"] >= 0
    assert abs(rep["qps"] - n / rep["wall_seconds"]) < 5.0  # rounded fields
    lg.close()


def test_server_e2e_with_native_loadgen(weights):
    """The Server slot pipeline driven by the native issue thread: every
    query completes with the Offline decode's tokens."""
    _, tw = weights
    _, store = _stores(5, 7, 0.3, 1.0, 0.6)
    offline = tharness.run_offline(tw, store, TP, CFG, batch_size=4, warmup=False, device="cpu")
    report, results = tscheduler.run_server_native(_server_runner(tw), store, target_qps=200.0,
                                                   max_wall_s=60.0)
    assert report["completed"] == 5
    for i in range(5):
        assert seq_to_sen(results[i], len(results[i])) == offline.hypotheses[i]


def test_server_native_qos_deferred_with_response_size_completes(weights):
    """QoS-deferred queries with a response_size above the remaining
    finishers: the run completes (the deferred queries are admitted once
    the stream is exhausted, without waiting for an idle pipeline) and
    every query gets a response."""
    _, tw = weights
    _, store = _stores(5, 7, 0.3, 1.0, 0.6)
    report, results = tscheduler.run_server_native(_server_runner(tw), store, target_qps=200.0,
                                                   max_wall_s=30.0, qos_len=8000,
                                                   response_size=9)
    assert report["completed"] == 5
    assert sorted(results) == list(range(5))


def test_single_stream_mode_issue_after_complete():
    """The next query is issued only after the previous completes."""
    n = 10
    lg = NativeLoadGen(n, target_qps=0.0, mode="SingleStream")
    got = []
    t0 = time.time()
    while len(got) < n and time.time() - t0 < 10:
        ids = lg.poll(max_n=8, timeout_us=100000)
        assert len(ids) <= 1  # never more than one query outstanding
        for q in ids:
            time.sleep(0.002)
            lg.complete(q)
        got.extend(ids)
    assert got == list(range(n))
    rep = lg.report()
    assert rep["completed"] == n
    assert rep["latency_ms_p50"] >= 2.0  # the sleep is the floor
    lg.close()


def test_min_query_count_loops_sample_set():
    lg = NativeLoadGen(4, target_qps=0.0, mode="Offline", min_query_count=10)
    got = []
    while len(got) < 10:
        got.extend(lg.poll(max_n=16, timeout_us=100000))
    assert sorted(got) == list(range(10))
    assert [lg.sample_of(q) for q in sorted(got)] == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]
    for q in got:
        lg.complete(q)
    assert lg.drained
    lg.close()


def test_server_min_duration_keeps_issuing():
    lg = NativeLoadGen(2, target_qps=200.0, mode="Server", min_query_count=1,
                       min_duration_s=0.2)
    got = []
    t0 = time.time()
    while not lg.done_issuing and time.time() - t0 < 5:
        got.extend(lg.poll(max_n=16, timeout_us=20000))
    got.extend(lg.poll(max_n=64, timeout_us=20000))
    assert len(got) >= 10  # ~200 qps for >= 0.2 s: ~40 queries
    for q in got:
        lg.complete(q)
    lg.close()


def test_server_latency_charged_from_scheduled_arrival():
    """A stalled consumer's latency grows by the stall, though the queue
    backpressures the issuer: latency counts from the scheduled arrival."""
    n = 50
    lg = NativeLoadGen(n, target_qps=5000.0, mode="Server", seed=3)
    time.sleep(0.3)  # the whole ~10 ms schedule piles up
    got = []
    t0 = time.time()
    while len(got) < n and time.time() - t0 < 5:
        got.extend(lg.poll(max_n=64, timeout_us=50000))
    for q in got:
        lg.complete(q)
    assert lg.report()["latency_ms_p50"] > 200.0
    lg.close()


def test_single_stream_e2e_native(weights):
    """SingleStream through the runner, paced by the native loadgen:
    min_query_count 5 loops the 3-sample set, with the Offline tokens."""
    _, tw = weights
    _, store = _stores(3, 8, 0.3, 0.8, 0.5)
    offline = tharness.run_offline(tw, store, TP, CFG, batch_size=2, warmup=False, device="cpu")
    report = tharness.run_single_stream_native(tw, store, TP, CFG, min_query_count=5,
                                               warmup=False, device="cpu")
    s = report.summary()
    assert s["completed"] == 5
    assert s["latency_ms_p90"] >= s["latency_ms_p50"] > 0
    assert report.hypotheses == offline.hypotheses


def test_report_deferred_excluded_from_percentiles():
    """QoS-deferred completions stay out of the live percentiles and the
    wall, and are reported apart."""
    n = 20
    lg = NativeLoadGen(n, target_qps=10000.0, mode="Server", seed=3)
    got = []
    while len(got) < n:
        got.extend(lg.poll(max_n=64, timeout_us=100000))
    deferred_q = got[-1]
    lg.mark_deferred(deferred_q)
    for q in got[:-1]:
        lg.complete(q)
    time.sleep(0.5)
    lg.complete(deferred_q)
    rep = lg.report()
    assert rep["completed"] == n
    assert rep["completed_live"] == n - 1
    assert rep["deferred_completed"] == 1
    assert rep["deferred_ms_max"] >= 500.0
    assert rep["latency_ms_max"] < 500.0
    assert rep["latency_ms_p99"] < 500.0
    assert rep["wall_seconds"] < 0.5
    lg.close()


def test_offline_native_rules_e2e(weights):
    """performance_sample_count restricts the QSL, queries cycle over it,
    min_query_count is kept, and the first cycle's tokens are the plain
    Offline run's."""
    _, tw = weights
    _, store = _stores(5, 7, 0.3, 1.0, 0.6)
    report = tharness.run_offline_native(
        tw, store, TP, CFG, batch_size=4, target_qps=10.0, min_query_count=7,
        min_duration_s=0.0, performance_sample_count=3, warmup=False, device="cpu")
    assert report.extra["performance_sample_count"] == 3
    assert report.extra["queries"] == 7
    assert report.extra["completed"] == 7  # 3 + 3 + 1 over 3 cycles
    assert report.extra["cycles"] == 3
    assert report.extra["timing"] == "native"
    assert report.wall_seconds > 0
    offline = tharness.run_offline(tw, store.select(np.arange(3)), TP, CFG, batch_size=4,
                                   warmup=False, device="cpu")
    assert report.hypotheses == offline.hypotheses


def test_offline_native_duration_rule_sizes_queries(weights):
    """Offline query count = max(min_query_count, target_qps *
    min_duration): qps 100 x 0.05 s = 5 beats min_query_count 2."""
    _, tw = weights
    _, store = _stores(3, 7, 0.3, 0.8, 0.5)
    report = tharness.run_offline_native(
        tw, store, TP, CFG, batch_size=4, target_qps=100.0, min_query_count=2,
        min_duration_s=0.05, warmup=False, device="cpu")
    assert report.extra["queries"] == 5
    assert report.extra["completed"] == 5


# -- the port's own build ---------------------------------------------------


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, from
    build_lib and from NativeLoadGen alike; nothing falls back."""
    broken = tmp_path / "rnnt_loadgen.cpp"
    broken.write_text(native.SRC.read_text().replace("int lg_poll(", "int lg_poll(((", 1))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ exit \d+.*error"):
        native.build_lib(broken, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed for rnnt_loadgen"):
        NativeLoadGen(4, 0.0, mode="Offline")


def test_loadgen_source_is_the_repository_copy():
    """The port's C++ source is the repository's csrc/rnnt_loadgen.cpp
    apart from comments: the same semantics, built apart."""
    strip = lambda s: [l for l in (re.sub(r"//.*", "", x).rstrip() for x in s.splitlines()) if l]
    repo = cuda_build.CSRC.parents[1] / "csrc" / "rnnt_loadgen.cpp"
    assert strip(native.SRC.read_text()) == strip(repo.read_text())
    assert native.build_lib().parent == cuda_build.BUILD_DIR


# -- parity with the JAX package's native runs ------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_offline_native_matches_jax(weights, packed):
    """run_offline_native on the same weights and store (psc 3,
    min_query_count 7): the JAX run's hypotheses and query accounting."""
    jw, tw = weights
    js, ts = _stores(5, 7, 0.3, 1.0, 0.6)
    kw = dict(batch_size=4, target_qps=10.0, min_query_count=7, min_duration_s=0.0,
              performance_sample_count=3, warmup=False, packed=packed)
    j = jharness.run_offline_native(jw, js, JP, JFeaturizerConfig(), **kw)
    t = tharness.run_offline_native(tw, ts, TP, CFG, device="cpu", **kw)
    assert t.hypotheses == j.hypotheses and any(t.hypotheses)
    keys = ["completed", "issued", "queries", "cycles", "performance_sample_count", "timing"]
    keys += ["packed", "pack_chunks", "chunk_frames"] if packed else []
    assert {k: t.extra[k] for k in keys} == {k: j.extra[k] for k in keys}
    assert t.samples == j.samples == 7


def test_server_native_matches_jax(weights):
    """run_server_native with a QoS-deferred sample and response_size 3:
    the JAX run's tokens per query id and counts."""
    jw, tw = weights
    js, ts = _stores(6, 4, 0.3, 1.2, 0.6)
    qos_len = 8000  # 0.5 s
    assert 0 < sum(s.shape[0] > qos_len for s in ts.samples) < len(ts)
    kw = dict(target_qps=200.0, max_wall_s=60.0, qos_len=qos_len, response_size=3,
              min_query_count=8)
    runner_kw = dict(slots=4, split_len=4, max_frames=64, insert_batch=2)
    jrep, jres = jscheduler.run_server_native(
        JServerRunner(jw, JP, JFeaturizerConfig(), **runner_kw), js, **kw)
    trep, tres = tscheduler.run_server_native(
        ServerRunner(tw, TP, CFG, device="cpu", **runner_kw), ts, **kw)
    assert sorted(tres) == sorted(jres) == list(range(8))
    for q in range(8):
        np.testing.assert_array_equal(tres[q], jres[q])
    for k in ("completed", "issued", "deferred_completed"):
        assert trep[k] == jrep[k], k
    assert trep["deferred_completed"] > 0 and trep["completed_live"] > 0


def test_single_stream_native_matches_jax(weights):
    jw, tw = weights
    js, ts = _stores(3, 8, 0.3, 0.8, 0.5)
    j = jharness.run_single_stream_native(jw, js, JP, JFeaturizerConfig(), min_query_count=5,
                                          warmup=False)
    t = tharness.run_single_stream_native(tw, ts, TP, CFG, min_query_count=5, warmup=False,
                                          device="cpu")
    assert t.hypotheses == j.hypotheses and any(t.hypotheses)
    assert t.summary()["completed"] == j.summary()["completed"] == 5
    assert t.samples == j.samples


@pytest.mark.parametrize("max_samples", [None, 2])
def test_single_stream_max_samples_and_warmup_match_jax(weights, max_samples):
    """run_single_stream's max_samples and warmup: the first max_samples
    samples, the JAX run's hypotheses."""
    jw, tw = weights
    js, ts = _stores(3, 8, 0.3, 0.8, 0.5)
    j = jharness.run_single_stream(jw, js, JP, JFeaturizerConfig(), max_samples=max_samples,
                                   warmup=False)
    t = tharness.run_single_stream(tw, ts, TP, CFG, max_samples=max_samples, warmup=False,
                                   device="cpu")
    assert t.samples == j.samples == (max_samples or 3)
    assert t.hypotheses == j.hypotheses


def test_unissued_query_ids_raise():
    """complete and mark_deferred refuse an id that was not polled (the C
    side would index past its arrays)."""
    lg = NativeLoadGen(2, target_qps=0.0, mode="Offline")
    got = []
    while len(got) < 2:
        got.extend(lg.poll(max_n=4, timeout_us=100000))
    for bad in (-1, 2, 10 ** 9):
        with pytest.raises(ValueError, match="was not polled"):
            lg.complete(bad)
        with pytest.raises(ValueError, match="was not polled"):
            lg.mark_deferred(bad)
    for q in got:
        lg.complete(q)
    assert lg.drained
    lg.close()
