"""The port's data parallelism (parallel/mesh.py, the runners' ``mesh=``,
the slot-sharded Server, tools/dryrun_multichip.py) against the unsharded
port and the JAX package's mesh runners, on the CPU at the golden
bundle's small width.  The port's mesh lists the CPU twice (two shards on
one device); the JAX side runs on a dp=2 mesh of tests/conftest.py's
virtual CPU devices.

Tolerance: tokens, ``res_idx`` and hypotheses equal.
"""

import dataclasses

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
from rnnt_inference_tpu.parallel import mesh as jmesh
from rnnt_inference_tpu.runtime.offline import OfflineRunner as JOfflineRunner
from rnnt_inference_tpu.runtime.packing import PackedOfflineRunner as JPackedRunner
from rnnt_inference_tpu.runtime.qsl import QuerySampleLibrary as JQSL
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.parallel import mesh as tmesh
from rnnt_inference_tpu_torch.runtime import harness as tharness
from rnnt_inference_tpu_torch.runtime import server as tserver
from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner, lockstep
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
CPU2 = ["cpu", "cpu"]


def _port(w, kind):
    return weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(w)[0]], kind, TP,
                                     "cpu")


def _models(seed, quant):
    """(JAX weights, the port's copy): f32, or int8 from a seeded calibration."""
    jw = jinit_weights(jax.random.PRNGKey(seed), JP)
    if not quant:
        return jw, _port(jw, "rnnt_weights")
    xc = jax.random.normal(jax.random.PRNGKey(seed + 1), (16, 4, 240))
    jq = jquantize_weights(jw, jcalibrate(jw, [(xc, jnp.full((4,), 16, jnp.int32))], JP), JP)
    return jq, _port(jq, "rnnt_quant_weights")


def _stores(n, seed, max_seconds=1.5):
    kw = dict(n=n, seed=seed, min_seconds=0.3, max_seconds=max_seconds, mean_seconds=0.7)
    return JSampleStore.synthetic(**kw), SampleStore.synthetic(**kw)


def _tokens_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"sample {i}")


def test_make_mesh_shapes_match_jax():
    """(data, model) shape and axis names as JAX's make_mesh; n_devices
    cuts the list; a device may repeat; model_parallel = 2 gives JAX's
    (n / 2, 2) shape with the data shards' devices in column 0."""
    for n in (1, 2, 4):
        m = tmesh.make_mesh(devices=["cpu"] * 8, n_devices=n)
        j = jmesh.make_mesh(n_devices=n)
        assert m.shape == dict(j.shape) == {"data": n, "model": 1}
        assert m.axis_names == tuple(j.axis_names)
        assert m.devices.shape == j.devices.shape
        assert m.data_devices == [torch.device("cpu")] * n
    m = tmesh.make_mesh(devices=["cpu"] * 4, model_parallel=2)
    j = jmesh.make_mesh(4, model_parallel=2)
    assert m.shape == dict(j.shape) == {"data": 2, "model": 2}
    assert m.devices.shape == j.devices.shape
    assert m.data_devices == [torch.device("cpu")] * 2


@pytest.mark.parametrize("quant", [False, True])
def test_weight_shardings_replicate_per_device(quant):
    """Shards on one device share the one replica (the caller's own object,
    so its kernel-operand registry too); tensor_parallel=True on a 1 x 2
    mesh gives each model rank its slice (two objects, whose LSTM weights
    hold half the units)."""
    from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
    from rnnt_inference_tpu_torch.models.weights import init_weights

    tw = init_weights(TP, torch.Generator().manual_seed(3), device="cpu")
    if quant:
        x = torch.randn((8, 2, 240), generator=torch.Generator().manual_seed(4))
        tw = quantize_weights(tw, calibrate(tw, [(x, torch.full((2,), 8))], TP), TP)
    mesh = tmesh.make_mesh(devices=CPU2)
    reps = tmesh.weight_shardings(mesh, tw)
    assert len(reps) == 2 and reps[0] is tw and reps[1] is tw
    tp = tmesh.weight_shardings(tmesh.make_mesh(devices=CPU2, model_parallel=2), tw,
                                tensor_parallel=True)
    assert len(tp) == 1 and len(tp[0]) == 2 and tp[0][0] is not tp[0][1]
    assert all(2 * r.pre_rnn[0].w_hh.shape[1] == tw.pre_rnn[0].w_hh.shape[1] for r in tp[0])


def test_shard_and_join_follow_the_lane_axis():
    """batch_sharding cuts axis 1 of {T, N, C}, lens_sharding axis 0, into
    contiguous slices (uneven: the first shards one longer), and join
    restores them; replicated gives each shard the tensor."""
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    x = torch.arange(2 * 7 * 3).reshape(2, 7, 3)
    parts = tmesh.batch_sharding(mesh, x)
    assert [p.shape[1] for p in parts] == [3, 2, 2]
    assert torch.equal(tmesh.join(parts, 1, "cpu"), x)
    v = torch.arange(7)
    assert [p.tolist() for p in tmesh.lens_sharding(mesh, v)] == [[0, 1, 2], [3, 4], [5, 6]]
    assert all(r is v for r in tmesh.replicated(mesh, v))


def test_server_state_sharding_roundtrip():
    """server_state_sharding cuts every leaf on its slot axis (axis 0 of
    vectors and matrices, axis 1 of stacked and time-major tensors) and
    join_server_state restores the state exactly."""
    st = tserver.init_server_state(6, 8, TP, device="cpu")
    g = torch.Generator().manual_seed(0)
    st.F.copy_(torch.randn(st.F.shape, generator=g))
    st.F_lens.copy_(torch.arange(6, dtype=torch.int32))
    st.decode.hg.copy_(torch.randn(st.decode.hg.shape, generator=g))
    st.decode.res_idx.copy_(torch.arange(6, dtype=torch.int32) - 1)
    shards = tmesh.server_state_sharding(tmesh.make_mesh(devices=CPU2), st)
    assert shards[0].F.shape == (8, 3, 240) and shards[1].decode.res.shape == (3, 128)
    assert shards[1].decode.enc.pre_h.shape == (2, 3, 64)
    assert torch.equal(shards[1].F_lens, torch.tensor([3, 4, 5], dtype=torch.int32))
    back = tmesh.join_server_state(shards, "cpu")
    for a, b in zip(jax.tree.leaves(dataclasses.asdict(back)),
                    jax.tree.leaves(dataclasses.asdict(st))):
        assert torch.equal(a, b)


def test_lockstep_enqueues_every_shard_before_any_read():
    """lockstep advances each shard's step generator to its next yield in
    turn: in every round all shards reach their yield (enqueue their
    launch) before any of them resumes past it (reads its mask); shards
    that finish early drop out."""
    log = []

    def shard(s, rounds):
        for r in range(rounds):
            log.append(("launch", s, r))
            yield
            log.append(("read", s, r))
        return s * 10

    out = lockstep([shard(0, 3), shard(1, 1), shard(2, 2)], [torch.device("cpu")] * 3)
    assert out == [0, 10, 20]
    for r in range(3):
        launches = [i for i, e in enumerate(log) if e[0] == "launch" and e[2] == r]
        reads = [i for i, e in enumerate(log) if e[0] == "read" and e[2] == r]
        assert max(launches) < min(reads)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_bucketed_runner_mesh_matches_unsharded_and_jax(quant):
    """OfflineRunner(mesh=["cpu", "cpu"]) over host batches and over a
    device-resident QSL: tokens equal the unsharded port run and the JAX
    OfflineRunner on a dp=2 mesh; launches are counted per shard."""
    jw, tw = _models(5, quant)
    js, ts = _stores(7, seed=21)
    mesh = tmesh.make_mesh(devices=CPU2)
    qsl = QuerySampleLibrary(ts, FeaturizerConfig())
    want = OfflineRunner(tw, TP, batch_size=4, device="cpu").run(qsl).tokens
    runner = OfflineRunner(tw, TP, batch_size=4, mesh=mesh)
    got = runner.run(qsl)
    _tokens_equal(got.tokens, want)
    assert runner.device == torch.device("cpu") and len(got.shard_launches) == 2
    dqsl = qsl.load_to_device(4, device="cpu")
    _tokens_equal(runner.run_device(dqsl).tokens, want)

    jm = jmesh.make_mesh(n_devices=2)
    jr = JOfflineRunner(jw, JP, JFeaturizerConfig(), batch_size=4, mesh=jm)
    with jm:
        jres = jr.run(JQSL(js, JFeaturizerConfig()))
    _tokens_equal(got.tokens, jres.tokens)
    with pytest.raises(ValueError, match="not divisible"):
        OfflineRunner(tw, TP, batch_size=3, mesh=mesh)


def test_packed_runner_mesh_matches_unsharded_and_jax():
    """PackedOfflineRunner(mesh=["cpu", "cpu"]) with int8 weights: tokens
    equal the unsharded port run and the JAX packed runner on a dp=2 mesh
    (tests/test_packing.py::test_packed_mesh_tokens_exact's case)."""
    jw, tw = _models(3, quant=True)
    js, ts = _stores(12, seed=11)
    pk = dict(n_lanes=4, chunk_frames=8, batch_size=4, decode_chunk=16)
    buckets = (1.0, 2.0)
    r1 = PackedOfflineRunner(tw, TP, FeaturizerConfig(), device="cpu", **pk)
    r1.stage(QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=buckets))
    want = r1.run_device()
    rm = PackedOfflineRunner(tw, TP, FeaturizerConfig(), mesh=tmesh.make_mesh(devices=CPU2), **pk)
    rm.stage(QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=buckets))
    got = rm.run_device()
    _tokens_equal(got.tokens, want.tokens)
    assert got.launches == want.launches  # the twins launch nothing
    assert len(got.shard_launches) == 2

    jm = jmesh.make_mesh(n_devices=2)
    jr = JPackedRunner(jw, JP, JFeaturizerConfig(), mesh=jm, **pk)
    with jm:
        jr.stage(JQSL(js, JFeaturizerConfig(), wav_buckets_s=buckets))
        jres = jr.run_device()
    _tokens_equal(got.tokens, jres.tokens)
    with pytest.raises(ValueError, match="not divisible"):
        PackedOfflineRunner(tw, TP, FeaturizerConfig(), n_lanes=3,
                            mesh=tmesh.make_mesh(devices=CPU2))


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_run_offline_native_mesh(packed):
    """run_offline_native(mesh=...): the native-clock serve loop with lanes
    sharded completes the same first-cycle hypotheses as the unsharded run
    and reports each shard's launches."""
    _, tw = _models(4, quant=True)
    _, ts = _stores(6, seed=13, max_seconds=1.0)
    kw = dict(batch_size=2, target_qps=10.0, min_query_count=6, min_duration_s=0.0,
              warmup=False, packed=packed, chunk_frames=8, decode_chunk=16)
    ref = tharness.run_offline_native(tw, ts, TP, FeaturizerConfig(), device="cpu", **kw)
    got = tharness.run_offline_native(tw, ts, TP, FeaturizerConfig(),
                                      mesh=tmesh.make_mesh(devices=CPU2), **kw)
    assert got.extra["timing"] == "native" and got.hypotheses == ref.hypotheses
    assert len(got.extra["shard_launches"]) == 2


def test_server_dp_matches_single_slot_set():
    """Server-dp: insert into 4 slots, shard the state over two devices,
    fused streaming steps per shard in lockstep: res, res_idx and the finish
    mask equal the single slot set's run (dryrun_multichip's case)."""
    _, tw = _models(2, quant=True)
    slots, split, max_frames = 4, 4, 16
    feats = torch.randn((max_frames, slots, 240), generator=torch.Generator().manual_seed(5))
    flens = torch.tensor([3 + (7 * i) % (max_frames - 2) for i in range(slots)],
                         dtype=torch.int32)
    k = -(-max_frames // split)

    def inserted():
        st = tserver.init_server_state(slots, max_frames, TP, device="cpu")
        return tserver.server_insert(st, feats, flens, torch.arange(slots), TP)

    with torch.inference_mode():
        s1, f1 = tserver.server_multi_step(tw, inserted(), split, k, TP)
        per_shard = [{}, {}]
        mesh = tmesh.make_mesh(devices=CPU2)
        sm, fm = tserver.server_multi_step_dp(mesh, tmesh.weight_shardings(mesh, tw), inserted(),
                                              split, k, TP, shard_launches=per_shard)
    assert bool(f1.all())
    assert torch.equal(sm.decode.res, s1.decode.res)
    assert torch.equal(sm.decode.res_idx, s1.decode.res_idx)
    assert torch.equal(fm, f1) and torch.equal(sm.offsets, s1.offsets)
    assert int((s1.decode.res_idx + 1).sum()) > 0


def test_dryrun_multichip_on_two_cpu_devices():
    """tools/dryrun_multichip.py's phases on ["cpu", "cpu"]: the decode at
    the MLPerf widths on 1 x 2 (tensor parallelism) and each data-parallel
    phase equal their single-device runs, and quant-tp (int8, 1 x 2) holds
    its result, tokens and res_idx equal."""
    from rnnt_inference_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    lines = []
    out = dryrun_multichip(2, devices=CPU2, log=lines.append)
    assert set(out) == {"mesh", "tp_mesh", "dp_decode", "offline", "quant_dp", "quant_tp",
                        "packed_dp", "server_dp"}
    assert out["quant_tp"] == {"dp": 1, "tp": 2, "res": [2, 64]}
    assert out["dp_decode"]["tokens"] in ("equal", "near-ties")
    assert out["offline"]["samples"] == 4 and len(lines) == 6


@pytest.mark.parametrize("runner", ["packed", "bucketed"])
def test_mesh_scaling_tool_on_the_cpu(runner):
    """tools/mesh_scaling.py at a tiny size on meshes of one and two CPU
    devices: tokens equal across meshes, a report for every mesh."""
    from rnnt_inference_tpu_torch.tools import mesh_scaling

    out = mesh_scaling.measure([1, 2], runner, device="cpu", hidden=64, n=6, lanes=2, reps=1,
                               max_seconds=1.0)
    assert sorted(out["meshes"]) == ["1", "2"] and out["runner"] == runner
    assert all(m["tokens_equal_first_mesh"] for m in out["meshes"].values())
    assert len(out["meshes"]["2"]["shard_launches"]) == 2


def test_mesh_scaling_tool_tp_on_the_cpu():
    """tools/mesh_scaling.py --tp's measure_tp at a tiny size on the CPU
    (1 x 2 and 2 x 2 over CPU copies): res and res_idx equal the one-device
    decode's, a report for every mesh."""
    from rnnt_inference_tpu_torch.tools import mesh_scaling

    out = mesh_scaling.measure_tp(["1x2", "2x2"], device="cpu", hidden=64, n=4,
                                  max_seconds=1.0, reps=1)
    assert sorted(out["meshes"]) == ["1x1", "1x2", "2x2"] and out["tokens"] > 0
    assert all(m["tokens_equal_one_card"] for m in out["meshes"].values())
