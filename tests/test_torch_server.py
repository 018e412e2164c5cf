"""The port's Server scenario (runtime/server.py, runtime/scheduler.py)
against the JAX package's, on the CPU at the golden bundle's small width:
slot streaming equals the Offline decode and the JAX run_server (issuing
as fast as the pipeline accepts), slot recycling, response_size groups,
min_query_count loops, QoS deferral and the Poisson schedule.

Tolerance: tokens equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.data.dataset import SampleStore as JSampleStore
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.runtime import scheduler as jscheduler
from rnnt_inference_tpu.runtime.server import ServerRunner as JServerRunner
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.runtime import config as tconfig
from rnnt_inference_tpu_torch.runtime import harness as tharness
from rnnt_inference_tpu_torch.runtime import scheduler as tscheduler
from rnnt_inference_tpu_torch.runtime.server import ServerRunner
from rnnt_inference_tpu_torch.utils.labels import seq_to_sen

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)


def _port(w, kind):
    return weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(w)[0]], kind, TP,
                                     "cpu")


def _stores(n, seed, min_seconds, max_seconds, mean_seconds):
    kw = dict(n=n, seed=seed, min_seconds=min_seconds, max_seconds=max_seconds,
              mean_seconds=mean_seconds)
    return JSampleStore.synthetic(**kw), SampleStore.synthetic(**kw)


@pytest.fixture(scope="module")
def models():
    """JAX f32 weights and their int8 quantization, with the port's copies."""
    jw = jinit_weights(jax.random.PRNGKey(5), JP, dtype=jnp.float32)
    xc = jax.random.normal(jax.random.PRNGKey(6), (32, 4, JP.trans_input_size))
    jq = jquantize_weights(jw, jcalibrate(jw, [(xc, jnp.full((4,), 32, jnp.int32))], JP), JP)
    return {"f32": (jw, _port(jw, "rnnt_weights")),
            "quant": (jq, _port(jq, "rnnt_quant_weights"))}


def _serve(runner, store, **kw):
    return tscheduler.run_server(runner, store, target_qps=1000.0, realtime=False,
                                 max_wall_s=120.0, **kw)


@pytest.mark.parametrize("mode", ["f32", "quant"])
def test_server_matches_offline_and_jax(models, mode):
    """Slots of 4 frames each step: the tokens of the Offline decode of each
    utterance (test_server_matches_offline_tokens and _quant) and of the
    JAX run_server on the same weights and store."""
    jw, tw = models[mode]
    js, ts = _stores(7, 3, 0.3, 1.2, 0.7)
    kw = dict(slots=4, split_len=4, max_frames=64, insert_batch=2)
    jm, jres = jscheduler.run_server(JServerRunner(jw, JP, JFeaturizerConfig(), **kw), js,
                                     target_qps=1000.0, realtime=False, max_wall_s=120.0)
    tm, tres = _serve(ServerRunner(tw, TP, FeaturizerConfig(), device="cpu", **kw), ts)
    assert tm.completed == jm.completed == len(ts)
    offline = tharness.run_offline(tw, ts, TP, batch_size=4, device="cpu")
    for q in range(len(ts)):
        np.testing.assert_array_equal(tres[q], jres[q])
        assert seq_to_sen(tres[q], len(tres[q])) == offline.hypotheses[q]
    assert sum(len(t) for t in tres.values()) > 0


def test_server_slot_recycling(models):
    """Six samples through two slots: every slot comes back free, and the
    tokens equal the JAX server's."""
    jw, tw = models["f32"]
    js, ts = _stores(6, 4, 0.3, 0.8, 0.5)
    kw = dict(slots=2, split_len=4, max_frames=32, insert_batch=2)
    runner = ServerRunner(tw, TP, FeaturizerConfig(), device="cpu", **kw)
    tm, tres = _serve(runner, ts)
    _, jres = jscheduler.run_server(JServerRunner(jw, JP, JFeaturizerConfig(), **kw), js,
                                    target_qps=1000.0, realtime=False, max_wall_s=120.0)
    assert tm.completed == 6 and len(runner.free_slots) == 2 and not runner.slot_sample
    for q in range(6):
        np.testing.assert_array_equal(tres[q], jres[q])


def test_server_response_size_groups(models):
    """response_size 3: every extraction but the tail drain's carries at
    least 3 finished slots, and the tokens still equal the Offline decode's."""
    _, tw = models["f32"]
    _, ts = _stores(8, 5, 0.3, 0.8, 0.5)
    runner = ServerRunner(tw, TP, FeaturizerConfig(), slots=8, split_len=4, max_frames=64,
                          insert_batch=4, device="cpu")
    sizes = []
    real = runner.extract
    runner.extract = lambda slots: (sizes.append(len(slots)), real(slots))[1]
    tm, tres = _serve(runner, ts, response_size=3)
    offline = tharness.run_offline(tw, ts, TP, batch_size=4, device="cpu")
    assert tm.completed == len(ts)
    for q in range(len(ts)):
        assert seq_to_sen(tres[q], len(tres[q])) == offline.hypotheses[q]
    assert sizes and any(s >= 3 for s in sizes)
    assert all(s >= 3 for s in sizes[:-2])


def test_server_min_query_count_loops(models):
    """min_query_count 7 over 3 samples: query q decodes sample q % 3."""
    _, tw = models["f32"]
    _, ts = _stores(3, 6, 0.3, 0.6, 0.4)
    runner = ServerRunner(tw, TP, FeaturizerConfig(), slots=4, split_len=4, max_frames=48,
                          insert_batch=2, device="cpu")
    tm, tres = _serve(runner, ts, min_query_count=7)
    assert tm.completed == 7
    for q in range(7):
        np.testing.assert_array_equal(tres[q], tres[q % 3])


def test_qos_deferred_excluded_from_percentiles(models):
    """Samples over qos_len are parked until the stream drains, served all
    the same, and kept out of the live percentiles."""
    _, tw = models["f32"]
    _, ts = _stores(6, 4, 0.3, 1.2, 0.6)
    qos_len = 8000  # 0.5 s
    n_long = sum(1 for s in ts.samples if s.shape[0] > qos_len)
    assert 0 < n_long < len(ts)
    runner = ServerRunner(tw, TP, FeaturizerConfig(), slots=4, split_len=4, max_frames=64,
                          insert_batch=2, device="cpu")
    tm, tres = _serve(runner, ts, qos_len=qos_len)
    assert tm.completed == len(ts) == len(tres)
    assert len(tm.deferred_latencies_ms) == n_long
    assert len(tm.latencies_ms) == len(ts) - n_long
    s = tm.summary()
    assert s["deferred_completed"] == n_long
    assert s["latency_ms_p99"] == round(float(np.percentile(list(tm.latencies_ms.values()), 99)),
                                        1)


def test_server_summaries_match_jax():
    """ServerMetrics.summary on the same latencies, the all-deferred case
    included (None, not NaN, and INVALID by validate_report): the JAX
    package's summary."""
    lat = {q: float(v) for q, v in enumerate(np.random.RandomState(0).exponential(400.0, 40))}
    for live, deferred in ((lat, {}), (lat, {50: 2500.0, 51: 900.0}), ({}, {0: 1500.0})):
        j, t = jscheduler.ServerMetrics(), tscheduler.ServerMetrics()
        for m in (j, t):
            m.latencies_ms, m.deferred_latencies_ms = dict(live), dict(deferred)
            m.completed, m.issued, m.wall_seconds = len(live) + len(deferred), 42, 3.0
        assert t.summary() == j.summary()
    json.dumps(t.summary(), allow_nan=False)
    out = tconfig.validate_report(
        tconfig.TestSettings(scenario="Server", min_query_count=1, min_duration_ms=0.0),
        t.summary())
    assert out["result_validity"] == "INVALID"


@pytest.mark.parametrize("n,qps,seed", [(1000, 100.0, 0), (7, 3.5, 4)])
def test_poisson_schedule_matches_jax(n, qps, seed):
    np.testing.assert_array_equal(tscheduler.poisson_schedule(n, qps, seed),
                                  jscheduler.poisson_schedule(n, qps, seed))


def test_server_realtime_run_completes(models):
    """A real-time run (Poisson arrivals at 40 QPS): every query completes,
    with the Offline decode's tokens, and the summary has the live
    percentiles."""
    _, tw = models["f32"]
    _, ts = _stores(4, 7, 0.3, 0.6, 0.4)
    runner = ServerRunner(tw, TP, FeaturizerConfig(), slots=4, split_len=4, max_frames=48,
                          insert_batch=2, device="cpu")
    runner.warmup()
    tm, tres = tscheduler.run_server(runner, ts, target_qps=40.0, realtime=True,
                                     max_wall_s=60.0)
    offline = tharness.run_offline(tw, ts, TP, batch_size=4, device="cpu")
    assert tm.completed == len(ts)
    assert [seq_to_sen(tres[q], len(tres[q])) for q in range(len(ts))] == offline.hypotheses
    s = tm.summary()
    assert s["latency_ms_p50"] is not None and s["completed_live"] == len(ts)
