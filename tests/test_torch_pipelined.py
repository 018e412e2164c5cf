"""The port's pipelined Server dispatch against the JAX package's, on the CPU
at the golden bundle's small widths (H=64, P=32, J=32): the symbol loop
with no host read (models/decoder.py ``steps_per_check=None``) against the
checked one, the sync-free ``server_insert``, ``run_server``'s
``inflight_window`` and ``sample_order``, ``run_server_native``'s
``pipeline_depth``, ``run_offline_native``'s ``max_inflight_cycles`` and
``wav_buckets_s``, the per-query stamps ``run_server_native`` records, and
the runtime's signatures against JAX's.

Tolerance: none.  The decode state is bit-equal between the two loops,
and tokens are equal per query id.
"""

import dataclasses
import inspect

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
from rnnt_inference_tpu.runtime import harness as jharness
from rnnt_inference_tpu.runtime import scheduler as jscheduler
from rnnt_inference_tpu.runtime import server as jserver
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models import decoder
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.runtime import harness as tharness
from rnnt_inference_tpu_torch.runtime import scheduler as tscheduler
from rnnt_inference_tpu_torch.runtime import server as tserver
from rnnt_inference_tpu_torch.utils.profiler import QUERY_STAMPS, REGISTRY

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
CFG = FeaturizerConfig()
RUNNER = dict(slots=4, split_len=4, max_frames=64, insert_batch=2)
RUNNER_STEPS = 4  # ServerRunner's steps_per_dispatch
QOS_LEN = 8000  # 0.5 s: the longer utterances are QoS-deferred


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
    jw = jinit_weights(jax.random.PRNGKey(11), JP, dtype=jnp.float32)
    xc = jax.random.normal(jax.random.PRNGKey(12), (32, 4, JP.trans_input_size))
    jq = jquantize_weights(jw, jcalibrate(jw, [(xc, jnp.full((4,), 32, jnp.int32))], JP), JP)
    return {"f32": (jw, _port(jw, "rnnt_weights")),
            "quant": (jq, _port(jq, "rnnt_quant_weights"))}


@pytest.fixture(scope="module")
def runners(models):
    """One JAX and one port ServerRunner on the int8 model, reused by every
    run (a finished run leaves every slot free)."""
    jq, tq = models["quant"]
    return (jserver.ServerRunner(jq, JP, JFeaturizerConfig(), **RUNNER),
            tserver.ServerRunner(tq, TP, CFG, device="cpu", **RUNNER))


# -- the symbol loop with no host read --------------------------------------


def _state_tensors(s):
    return dict(res=s.res, res_idx=s.res_idx, pre_g=s.pre_g, hg=s.hg, cg=s.cg)


@pytest.mark.parametrize("cap", [1, 30])
@pytest.mark.parametrize("lens", ["mixed", "empty"])
def test_sync_free_symbol_loop_matches_checked_loop(models, monkeypatch, cap, lens):
    """Two chunks of T2 = 6 encoded frames through greedy_decode_chunk on
    the plain twin, the second from the first's state: one launch of
    max_iters iterations with no host read against the checked loop (a
    read every 64 and every 1 iteration), and against the same launch
    running all max_iters iterations past the point where every lane has
    finished (the twin, as the kernel, leaves there).  Lanes of 0-6 frames
    finish at different iterations; "empty" gives every lane f_lens 0.
    res, res_idx, pre_g, hg and cg bit-equal."""
    from rnnt_inference_tpu_torch.ops import decode_cuda

    _, tw = models["f32"]
    params = dataclasses.replace(TP, max_symbols_per_step=cap)
    T2, N = 6, 7
    g = torch.Generator().manual_seed(cap)
    f = [torch.randn((T2, N, TP.trans_hidden_size), generator=g) * 2 for _ in range(2)]
    f_lens = (torch.zeros(N, dtype=torch.int32) if lens == "empty"
              else torch.tensor([0, 1, 2, 3, 4, 5, 6], dtype=torch.int32))

    def every_iteration(fproj, lanes, hg, cg, res, dw, params, steps, impl=None, **packed):
        for _ in range(steps):
            decode_cuda.decode_step_reference(fproj, lanes, hg, cg, res, dw, params, **packed)

    out = {}
    for check in (None, decoder.DEFAULT_STEPS_PER_CHECK, 1, "all"):
        with monkeypatch.context() as m:
            if check == "all":
                m.setattr(decode_cuda, "decode_step", every_iteration)
            state = decoder.init_decode_state(N, TP, device="cpu")
            for fk in f:
                state = decoder.greedy_decode_chunk(tw, state, fk, f_lens, params,
                                                    steps_per_check=None if check == "all"
                                                    else check)
        out[check] = _state_tensors(state)
    for check in (decoder.DEFAULT_STEPS_PER_CHECK, 1, "all"):
        for k, v in out[None].items():
            assert torch.equal(v, out[check][k]), (check, k)
    if lens == "mixed":
        assert int((out[None]["res_idx"] >= 0).sum()) > 1  # several lanes emitted
    else:
        assert bool((out[None]["res_idx"] == -1).all())


def test_server_step_launches_kernel_b_once_per_chunk(models, monkeypatch):
    """A Server dispatch runs one kernel-B call of max_iters iterations per
    streaming step and reads nothing back inside it."""
    from rnnt_inference_tpu_torch.ops import decode_cuda

    _, tq = models["quant"]
    calls = []
    real = decode_cuda.decode_step
    monkeypatch.setattr(decode_cuda, "decode_step",
                        lambda *a, **kw: (calls.append(a[7]), real(*a, **kw))[1])
    runner = tserver.ServerRunner(tq, TP, CFG, device="cpu", **RUNNER)
    _, store = _stores(2, 3, 0.3, 0.5, 0.4)
    runner.insert_samples(list(store.samples), [0, 1])
    mask = runner.step_async()
    max_iters = RUNNER["split_len"] // 2 * (TP.max_symbols_per_step + 1) + 1
    assert calls == [max_iters] * runner.steps_per_dispatch
    assert mask.cpu().dtype == torch.bool and mask.cpu().shape == (RUNNER["slots"],)


# -- the sync-free insert ---------------------------------------------------


def test_server_insert_matches_jax(models):
    """server_insert with a column of feat_lens 0 and a column whose slot id
    is past the last slot (both dropped, as JAX's scatter mode="drop"), over
    a state whose slots hold earlier samples: F, F_lens, offsets, active
    and the decode state equal the JAX insert's."""
    slots, T_max, C = 5, 12, TP.trans_input_size
    rng = np.random.RandomState(4)
    base = rng.randn(T_max, slots, C).astype(np.float32)
    feats = rng.randn(8, 4, C).astype(np.float32)
    lens = np.array([5, 0, 8, 3], np.int32)
    ids = np.array([3, 1, 0, slots], np.int32)
    js = jserver.init_server_state(slots, T_max, JP, JFeaturizerConfig())
    js = dataclasses.replace(js, F=jnp.asarray(base), F_lens=jnp.full((slots,), 7, jnp.int32),
                             offsets=jnp.full((slots,), 4, jnp.int32),
                             active=jnp.ones((slots,), bool))
    js = jserver.server_insert(js, jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(ids), JP)
    ts = tserver.init_server_state(slots, T_max, TP, CFG, device="cpu")
    ts.F.copy_(torch.from_numpy(base))
    ts.F_lens.fill_(7)
    ts.offsets.fill_(4)
    ts.active.fill_(True)
    ts = tserver.server_insert(ts, torch.from_numpy(feats), torch.from_numpy(lens),
                               torch.from_numpy(ids), TP)
    for name in ("F", "F_lens", "offsets", "active"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("res", "res_idx", "pre_g", "hg", "cg"):
        np.testing.assert_array_equal(getattr(ts.decode, name).numpy(),
                                      np.asarray(getattr(js.decode, name)), err_msg=name)


# -- run_server: inflight_window and sample_order ----------------------------


@pytest.mark.parametrize("case", ["w1", "w4", "w4_order"])
def test_run_server_inflight_window_matches_jax(runners, case):
    """run_server(realtime=False) with inflight_window 1 or 4, and with a
    permuted sample_order, against the JAX run_server with the same
    arguments, min_query_count 9 over 6 samples, QoS deferral on: tokens
    equal per query id, to JAX's and to the window-1 run's; query q decodes
    sample order[q % 6]."""
    jrunner, trunner = runners
    js, ts = _stores(6, 9, 0.3, 1.2, 0.6)
    order = np.array([4, 0, 5, 2, 1, 3]) if case.endswith("order") else None
    kw = dict(target_qps=1000.0, sample_order=order, realtime=False, max_wall_s=120.0,
              min_query_count=9, qos_len=QOS_LEN, inflight_window=4 if "w4" in case else 1)
    jm, jres = jscheduler.run_server(jrunner, js, **kw)
    tm, tres = tscheduler.run_server(trunner, ts, **kw)
    _, base = tscheduler.run_server(trunner, ts, **dict(kw, inflight_window=1, sample_order=None))
    assert sorted(tres) == sorted(jres) == list(range(9))
    assert tm.completed == tm.issued == jm.completed == 9
    assert tm.deferred_latencies_ms and len(trunner.free_slots) == RUNNER["slots"]
    perm = order if order is not None else np.arange(6)
    for q in range(9):
        np.testing.assert_array_equal(tres[q], jres[q])
        np.testing.assert_array_equal(tres[q], base[int(perm[q % 6])])
    assert sum(len(t) for t in tres.values()) > 0


# -- run_server_native: pipeline_depth ---------------------------------------


@pytest.mark.parametrize("response_size", [1, 9])
@pytest.mark.parametrize("depth", [1, 16])
def test_run_server_native_pipeline_depth_matches_jax(runners, depth, response_size):
    """run_server_native at pipeline_depth 1 and 16, response_size 1 and 9,
    QoS deferral on, min_query_count 8 over 6 samples: the JAX run's tokens
    per query id, completed = issued, and the deferred queries complete."""
    jrunner, trunner = runners
    js, ts = _stores(6, 4, 0.3, 1.2, 0.6)
    assert 0 < sum(s.shape[0] > QOS_LEN for s in ts.samples) < len(ts)
    kw = dict(target_qps=200.0, max_wall_s=60.0, qos_len=QOS_LEN, response_size=response_size,
              min_query_count=8, pipeline_depth=depth)
    jrep, jres = jscheduler.run_server_native(jrunner, js, **kw)
    trep, tres = tscheduler.run_server_native(trunner, ts, **kw)
    assert sorted(tres) == sorted(jres) == list(range(8))
    for q in range(8):
        np.testing.assert_array_equal(tres[q], jres[q])
    assert trep["completed"] == trep["issued"] == jrep["completed"] == 8
    assert trep["deferred_completed"] == jrep["deferred_completed"] > 0
    assert len(trunner.free_slots) == RUNNER["slots"]


@pytest.mark.parametrize("depth", [1, 16])
def test_run_server_native_records_each_querys_stages(runners, depth):
    """run_server_native at pipeline_depth 1 and 16 (response_size 3, QoS
    deferral on, a warm-up sample (id -1) already in a slot) leaves the
    call's QueryRecord in REGISTRY.server: every completed query holds its
    five stamps in order, the warm-up sample none, its four stages sum to
    completed - polled, and its finish_enqueued is the end of a
    rnnt.server.dispatch span that began after its insert.  Each dispatch
    of steps_per_dispatch steps times an encode and a decode per step."""
    _, trunner = runners
    _, ts = _stores(6, 4, 0.3, 1.2, 0.6)
    trunner.insert_samples([ts.samples[0][:4000]], [-1])
    counts = lambda: {n: REGISTRY.stats(f"rnnt.server.{n}").count
                      for n in ("poll", "insert", "dispatch", "read_mask", "extract", "encode",
                                "decode")}
    before = counts()
    rep, res = tscheduler.run_server_native(
        trunner, ts, target_qps=200.0, max_wall_s=60.0, qos_len=QOS_LEN, response_size=3,
        min_query_count=8, pipeline_depth=depth)
    added = {n: c - before[n] for n, c in counts().items()}
    rec = REGISTRY.server
    assert rep["completed"] == 8 and sorted(res) == list(range(-1, 8))
    assert len(trunner.free_slots) == RUNNER["slots"]
    t = np.array([[rec.stamps[name][q] for name in QUERY_STAMPS] for q in range(8)])
    assert all(sorted(d) == list(range(8)) for d in rec.stamps.values())
    assert (rec.start_ns < t[:, 0]).all() and (np.diff(t, axis=1) >= 0).all(), t
    st = rec.stages()
    assert list(st["query"]) == list(range(8))
    np.testing.assert_array_equal(st["admit"] + st["in_slot"] + st["readback_wait"]
                                  + st["respond"], t[:, 4] - t[:, 0])
    dispatches = dict((end, start) for start, end in
                      REGISTRY.stats("rnnt.server.dispatch").intervals(rec.start_ns))
    assert len(dispatches) == added["dispatch"] > 0
    for inserted, enqueued in t[:, 1:3].tolist():
        assert enqueued in dispatches and dispatches[enqueued] > inserted
    # the loop may end with the last dispatch's mask unread
    assert 0 < added["read_mask"] <= added["dispatch"]
    assert added["encode"] == added["decode"] == RUNNER_STEPS * added["dispatch"]
    assert added["insert"] >= 4 and added["extract"] >= 3 and added["poll"] >= added["insert"]


# -- run_offline_native: max_inflight_cycles and wav_buckets_s ---------------


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_offline_native_inflight_and_buckets_match_jax(models, packed):
    """run_offline_native(max_inflight_cycles=1, wav_buckets_s=(1.0, 2.0)),
    psc 4 and min_query_count 10 (three cycles), utterances of 0.3-1.8 s
    (both buckets): the JAX run's hypotheses and query accounting, and the
    hypotheses of the default depth and ladder."""
    jw, tw = models["f32"]
    js, ts = _stores(5, 13, 0.3, 1.8, 1.0)
    assert min(ts.lengths) <= 16000 < max(ts.lengths)
    kw = dict(batch_size=4, target_qps=10.0, min_query_count=10, performance_sample_count=4,
              warmup=False, packed=packed, max_inflight_cycles=1, wav_buckets_s=(1.0, 2.0))
    j = jharness.run_offline_native(jw, js, JP, JFeaturizerConfig(), **kw)
    t = tharness.run_offline_native(tw, ts, TP, CFG, device="cpu", **kw)
    d = tharness.run_offline_native(tw, ts, TP, CFG, device="cpu",
                                    **dict(kw, max_inflight_cycles=4, wav_buckets_s=None))
    assert t.hypotheses == j.hypotheses == d.hypotheses and any(t.hypotheses)
    keys = ["completed", "issued", "queries", "cycles", "performance_sample_count", "timing"]
    assert {k: t.extra[k] for k in keys} == {k: j.extra[k] for k in keys}
    assert t.samples == j.samples == 10 and t.extra["cycles"] == 3


# -- the runtime's signatures -----------------------------------------------

# every parameter the port has and JAX has not, with the reason it stays
PORT_ONLY = {
    "device": "the port chooses its card, or the CPU twins; JAX takes the default backend",
    "impl": "impl='reference' runs the plain twins on the card; JAX has no hand kernel to bypass",
}


# every config field the port has and JAX's has not, with the value that
# reproduces what the JAX package hard-codes (the Conformer's featurizer sets
# other values)
PORT_ONLY_FIELDS = {"log_guard": 1e-20, "dither_at_inference": True}


def _defaults(fn):
    def norm(v):
        if not dataclasses.is_dataclass(v):
            return v
        d = dataclasses.asdict(v)
        for k, jax_value in PORT_ONLY_FIELDS.items():
            if k in d:
                assert d.pop(k) == jax_value, k
        return d

    return {name: norm(p.default) for name, p in inspect.signature(fn).parameters.items()}


@pytest.mark.parametrize("name", ["run_server", "run_server_native", "run_offline_native",
                                  "ServerRunner"])
def test_runtime_signatures_match_jax(name):
    """run_server, run_server_native, run_offline_native and ServerRunner
    take JAX's parameters, in JAX's order and with JAX's defaults (configs
    compared field by field; the port's extra fields, PORT_ONLY_FIELDS, at
    the values JAX hard-codes); the port's extra parameters are the
    PORT_ONLY ones, each with its reason.  ServerRunner has every public
    method of JAX's, with its parameters."""
    mod_j, mod_t = ((jserver, tserver) if name == "ServerRunner"
                    else (jharness, tharness) if name == "run_offline_native"
                    else (jscheduler, tscheduler))
    fj, ft = getattr(mod_j, name), getattr(mod_t, name)
    dj, dt = _defaults(fj), _defaults(ft)
    extra = [k for k in dt if k not in dj]
    assert set(extra) <= set(PORT_ONLY), extra
    assert [k for k in dt if k in dj] == list(dj)
    assert {k: dt[k] for k in dj} == dj
    if name == "ServerRunner":
        public = [m for m, v in vars(fj).items() if callable(v) and not m.startswith("_")]
        assert "step_async" in public
        for m in public:
            assert (list(inspect.signature(getattr(fj, m)).parameters)
                    == list(inspect.signature(getattr(ft, m)).parameters)), m
