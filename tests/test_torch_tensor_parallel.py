"""The port's tensor parallelism (parallel/mesh.py make_mesh(model_parallel=k),
split_units, weight_shardings(..., tensor_parallel=True); parallel/tensor.py
greedy_decode_tp; the plain rank steps of kernels A, B and C) on the CPU
at the golden bundle's widths (H = 64, P = 32, J = 32), against the port's
one-device decode and against the JAX package's greedy_decode on a dp x
tp = 2 mesh of tests/conftest.py's virtual CPU devices, built as
tests/test_parallel.py builds it.  The port's meshes list the CPU several
times (["cpu"] * 2 is 1 x 2, ["cpu"] * 4 is 2 x 2).

Tolerances:
  - split_units / join_units: exact round trip.
  - Plain rank steps against the full layer: int8 (kernel A's twin on a
    unit slice) bit-equal at k = 2: its sums are exact integers (at k = 4,
    c and f32 y within 1e-7: torch's vectorized sigmoid and tanh on the
    CPU round some elements of a narrower slice one ulp apart); float
    (kernel C's twin, kernel B's twin) within 1e-6: a product of a column
    slice may sum in another order than the full product's.
  - TP decode against the port's one-device decode: tokens and res_idx
    equal, the int8 encoder output f bit-equal, split_len = 2 equal to the
    unsplit decode, every rank's lane state, tokens and h equal.
  - TP decode against JAX's TP greedy_decode: tokens and lengths equal;
    where a token parts, the port's decode parts from its own one-device
    twin only at near-ties (tools/decode_divergence.compare_tp_run_launches)
    and the edit rate is <= 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JPS

from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.models.decoder import greedy_decode as jgreedy_decode
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.parallel import mesh as jmesh
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import rnnt as tmodel
from rnnt_inference_tpu_torch.models.decoder import greedy_decode
from rnnt_inference_tpu_torch.models.quant import FakeQuantRNNTWeights, fake_quantize_weights
from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
from rnnt_inference_tpu_torch.models.weights import init_weights, weights_from_numpy_leaves
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.ops import lstm as tl
from rnnt_inference_tpu_torch.ops import lstm_int8 as ti8
from rnnt_inference_tpu_torch.parallel import mesh as tmesh
from rnnt_inference_tpu_torch.parallel import tensor
from rnnt_inference_tpu_torch.tools.decode_divergence import compare_tp_run_launches

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
MESHES = {"1x2": ["cpu"] * 2, "2x2": ["cpu"] * 4}


def _port(w, kind):
    return weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(w)[0]], kind, TP,
                                     "cpu")


def _models(seed, quant):
    """(JAX weights, the port's copy): f32, or int8 calibrated on seeded input."""
    jw = jinit_weights(jax.random.PRNGKey(seed), JP)
    if not quant:
        return jw, _port(jw, "rnnt_weights")
    xc = jax.random.normal(jax.random.PRNGKey(seed + 1), (12, 8, 240))
    jq = jquantize_weights(jw, jcalibrate(jw, [(xc, jnp.full((8,), 12, jnp.int32))], JP), JP)
    return jq, _port(jq, "rnnt_quant_weights")


def _inputs(seed, T=12, N=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, N, 240).astype(np.float32)
    lens = rng.randint(1, T + 1, N).astype(np.int32)
    lens[0] = T
    return x, lens


def _tp(mesh_name):
    return tmesh.make_mesh(devices=MESHES[mesh_name], model_parallel=2)


def test_make_mesh_model_parallel_matches_jax():
    """make_mesh(model_parallel=2) has JAX's shape, axis names and
    data-major device order (device i at (i // 2, i % 2)); model_devices
    names a data shard's ranks and data_devices keeps column 0; n not
    divisible by k raises."""
    devs = [torch.device("cuda", i) for i in range(4)]  # distinct names; no card is touched
    m = tmesh.make_mesh(devices=devs, model_parallel=2)
    j = jmesh.make_mesh(4, model_parallel=2)
    assert m.shape == dict(j.shape) == {"data": 2, "model": 2}
    assert m.axis_names == tuple(j.axis_names)
    assert [[d.index for d in row] for row in m.devices] == \
        [[d.id for d in row] for row in j.devices]
    assert m.data_devices == [devs[0], devs[2]] and m.model_devices(1) == devs[2:]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(devices=devs[:3], model_parallel=2)


@pytest.mark.parametrize("lib", ["numpy", "torch"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_split_join_units_round_trip(lib, k):
    """split_units cuts (..., 4H) gate columns into k slices of whole units
    (all four gates of units r H/k .. (r+1) H/k - 1, gate-major), and
    join_units gives back the original exactly; split_columns and
    join_columns likewise for contiguous columns."""
    rng = np.random.RandomState(k)
    for shape in ((8, 4 * 16), (4 * 16,), (2, 8, 4 * 16)):
        w = rng.randn(*shape).astype(np.float32)
        w = w if lib == "numpy" else torch.from_numpy(w)
        parts = tmesh.split_units(w, k)
        assert len(parts) == k and all(p.shape[-1] == shape[-1] // k for p in parts)
        for r, p in enumerate(parts):
            for g in range(4):
                lo = g * 16 + r * (16 // k)
                np.testing.assert_array_equal(np.asarray(p[..., g * (16 // k):(g + 1) * (16 // k)]),
                                              np.asarray(w[..., lo:lo + 16 // k]))
        back = tmesh.join_units(parts)
        assert type(back) is type(w)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(tmesh.join_columns(tmesh.split_columns(w, k))),
                                      np.asarray(w))
    with pytest.raises(ValueError):
        tmesh.split_units(np.zeros((3, 4 * 6)), 4)


@pytest.mark.parametrize("kind", ["f32", "int8", "fake_quant"])
def test_weight_shardings_tensor_parallel_layout(kind):
    """weight_shardings(..., tensor_parallel=True) on 2 x 2: [shard][rank],
    shards whose rank r shares a device share one object; LSTM leaves by
    unit and the joint's first layer by column join back to the original;
    embedding, w2, b2 and int8 scales are the original tensors; fake-quant
    weights are replicated whole."""
    w = init_weights(TP, torch.Generator().manual_seed(3), device="cpu")
    if kind != "f32":
        x = torch.randn((8, 2, 240), generator=torch.Generator().manual_seed(4))
        cal = calibrate(w, [(x, torch.full((2,), 8))], TP)
        w = quantize_weights(w, cal, TP) if kind == "int8" else fake_quantize_weights(w, cal, TP)
    mesh = _tp("2x2")
    wr = tmesh.weight_shardings(mesh, w, tensor_parallel=True)
    assert len(wr) == 2 and all(len(row) == 2 for row in wr)
    assert wr[0][0] is wr[1][0] and wr[0][1] is wr[1][1]
    if kind == "fake_quant":
        assert all(x is w for row in wr for x in row)
        assert isinstance(wr[0][0], FakeQuantRNNTWeights)
        return
    ranks = wr[0]
    for name in ("pre_rnn", "post_rnn", "pred_rnn"):
        for l, layer in enumerate(getattr(w, name)):
            for f in ("w_ih", "w_hh", "b"):
                parts = [getattr(getattr(r, name)[l], f) for r in ranks]
                assert parts[0].shape[-1] * 2 == getattr(layer, f).shape[-1]
                assert torch.equal(tmesh.join_units(parts), getattr(layer, f))
            if kind == "int8" and name != "pred_rnn":
                for f in ("in_scale", "w_scale", "out_scale"):
                    assert all(getattr(getattr(r, name)[l], f) is getattr(layer, f)
                               for r in ranks)
    for f in ("w1_trans", "w1_pred", "b1"):
        assert torch.equal(tmesh.join_columns([getattr(r.joint, f) for r in ranks]),
                           getattr(w.joint, f))
    assert all(r.embed is w.embed and r.joint.w2 is w.joint.w2 and r.joint.b2 is w.joint.b2
               for r in ranks)
    assert tmesh.weight_shardings(_tp("1x2"), w, tensor_parallel=False) == [w]


@pytest.mark.parametrize("k", [2, 4])
def test_plain_rank_mode_a_equals_the_layer(k):
    """Kernel A's plain rank steps over k ranks (quant_lstm_layer_tp)
    against the one-device layer, int8 and f32 y.  k = 2: y, h and c
    bit-equal.  k = 4: h and int8 y equal, c and f32 y within 1e-7: on the
    CPU, torch's vectorized sigmoid and tanh round some elements of a
    16-wide gate slice one ulp apart from the same elements of the 64-wide
    one (the kernel computes each element with the same code on any slice)."""
    _, tw = _models(5, quant=True)
    ranks = [tmesh.rank_weights(tw, r, k) for r in range(k)]
    rng = np.random.RandomState(6)
    atol = 0.0 if k == 2 else 1e-7
    for l, emit_f32 in ((0, False), (2, True)):
        full = tw.post_rnn[l]
        IC, H = full.w_ih.shape[0], full.w_hh.shape[0]
        x = torch.from_numpy(rng.randint(-128, 128, (7, 5, IC)).astype(np.int8))
        h = torch.from_numpy(rng.randint(-128, 128, (5, H)).astype(np.int8))
        c = torch.from_numpy(rng.randn(5, H).astype(np.float32))
        want = ti8.quant_lstm_layer(full, x, h, c, emit_f32)
        y, hT, cT = ti8.quant_lstm_layer_tp(
            [r.post_rnn[l] for r in ranks], [x] * k, [h] * k, list(c.chunk(k, dim=1)), emit_f32)
        for r in range(k):
            assert torch.equal(hT[r], want[1])
            if emit_f32:
                torch.testing.assert_close(y[r], want[0], rtol=0, atol=atol)
            else:
                assert torch.equal(y[r], want[0])
        torch.testing.assert_close(torch.cat(cT, dim=1), want[2], rtol=0, atol=atol)


@pytest.mark.parametrize("k", [2, 4])
def test_plain_rank_mode_c_equals_the_layer(k):
    """Kernel C's plain rank steps over k ranks (lstm_layer_tp), f32: y, h
    and c within 1e-6 of the one-device layer."""
    _, tw = _models(7, quant=False)
    ranks = [tmesh.rank_weights(tw, r, k) for r in range(k)]
    rng = np.random.RandomState(8)
    full = tw.post_rnn[1]
    H = full.w_hh.shape[0]
    x = torch.from_numpy(rng.randn(9, 5, H).astype(np.float32))
    h = torch.from_numpy(rng.randn(5, H).astype(np.float32) * 0.5)
    c = torch.from_numpy(rng.randn(5, H).astype(np.float32) * 0.5)
    want = tl.lstm_layer(full, x, h, c)
    y, hT, cT = tl.lstm_layer_tp([r.post_rnn[1] for r in ranks], [x] * k, [h] * k,
                                 list(c.chunk(k, dim=1)))
    for r in range(k):
        torch.testing.assert_close(y[r], want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(hT[r], want[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat(cT, dim=1), want[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_plain_rank_mode_b_equals_the_step(k):
    """Kernel B's plain rank steps over k ranks (decode_step_tp_reference),
    8 iterations from random lane states: every rank's lanes, symbols and
    tokens equal the one-device twin's, hg (full width on every rank) and
    cg (joined) within 1e-6."""
    _, tw = _models(9, quant=False)
    dw = dc.decode_weights(tw)
    dws = [dc.decode_weights(tmesh.rank_weights(tw, r, k)) for r in range(k)]
    rng = np.random.RandomState(10)
    N, T2, L, P, J, R = 6, 5, 2, TP.pred_hidden_size, TP.joint_hidden_size, TP.max_res_len
    fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32))
    f_lens = rng.randint(1, T2 + 1, N)
    lanes = torch.from_numpy(np.stack([
        rng.randint(-1, 28, N), np.zeros(N), np.zeros(N), np.full(N, -1), np.zeros(N),
        f_lens, f_lens - 1, np.zeros(N)]).astype(np.int32))
    hg = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5)
    cg = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5)
    res = torch.full((N, R), -1, dtype=torch.int8)
    one = [lanes.clone(), hg.clone(), cg.clone(), res.clone()]
    ranks = ([lanes.clone() for _ in range(k)], [hg.clone() for _ in range(k)],
             [t.contiguous() for t in cg.chunk(k, dim=2)], [res.clone() for _ in range(k)])
    fp = [t.contiguous() for t in fproj.chunk(k, dim=2)]
    for _ in range(8):
        dc.decode_step_reference(fproj, *one, dw, TP)
    dc.decode_step_tp(fp, *ranks, dws, TP, steps=8)
    for r in range(k):
        assert torch.equal(ranks[0][r], one[0]) and torch.equal(ranks[3][r], one[3])
        torch.testing.assert_close(ranks[1][r], one[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat(ranks[2], dim=2), one[2], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown impl"):
        dc.decode_step_tp(fp, *ranks, dws, TP, impl="triton")


@pytest.mark.parametrize("op", ["quant_lstm_layer_tp", "lstm_layer_tp", "decode_step_tp"])
def test_tp_steps_refuse_the_card_unless_asked(op):
    """The rank steps have no kernel: on CUDA tensors (a stand-in that says
    it is one) impl=None raises before any work, so the card never runs the
    plain version unasked; an unknown impl raises as on the CPU."""
    from types import SimpleNamespace

    from rnnt_inference_tpu_torch.ops import lstm as tlstm
    from rnnt_inference_tpu_torch.ops import lstm_int8

    card = [SimpleNamespace(is_cuda=True)] * 2
    call = {"quant_lstm_layer_tp": lambda impl: lstm_int8.quant_lstm_layer_tp(
                [None] * 2, card, card, card, False, impl),
            "lstm_layer_tp": lambda impl: tlstm.lstm_layer_tp([None] * 2, card, card, card, impl),
            "decode_step_tp": lambda impl: dc.decode_step_tp(card, card, card, card, card,
                                                             [None] * 2, TP, 1, impl)}[op]
    with pytest.raises(ValueError, match=f"{op} has no CUDA kernel"):
        call(None)
    with pytest.raises(ValueError, match="unknown impl"):
        call("triton")


@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_tp_decode_equals_one_device(quant, mesh_name):
    """greedy_decode_tp on the mesh against the port's one-device
    greedy_decode: tokens and res_idx equal, unsplit and with split_len =
    2; every rank's lanes, tokens and hg equal; the int8 encoder's f
    bit-equal (f32 within 1e-6)."""
    _, tw = _models(11, quant)
    x, lens = (torch.from_numpy(a) for a in _inputs(12))
    mesh = _tp(mesh_name)
    wr = tmesh.weight_shardings(mesh, tw, tensor_parallel=True)
    want = greedy_decode(tw, x, lens, TP)
    assert int(want[1].sum()) > 0
    for split in (-1, 2):
        states = []
        got = tensor.greedy_decode_tp(mesh, wr, x, lens, TP, split_len=split, rank_states=states)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len(states) == mesh.shape["data"]
        for shard in states:
            for st in shard[1:]:
                assert torch.equal(st["lanes"], shard[0]["lanes"])
                for key in ("res", "res_idx", "hg"):
                    assert torch.equal(getattr(st["state"], key), getattr(shard[0]["state"], key))
    enc_dt = tw.pre_rnn[0].w_ih.dtype
    f1, _ = tmodel.transcription(tw, x, lens, tmodel.init_encoder_state(8, TP, enc_dt, "cpu"), TP)
    sts = tensor.init_tp_states(wr[0], 8, TP, mesh.model_devices(0))
    f, _ = tensor.transcription_tp(wr[0], [x, x], [lens, lens], [s.enc for s in sts], TP)
    for fr in f:
        if quant:
            assert torch.equal(fr, f1)
        else:
            torch.testing.assert_close(fr, f1, rtol=0, atol=1e-6)


def test_tp_decode_fake_quant_runs_rank_zero():
    """Fake-quant weights are replicated whole: the TP decode is rank 0's
    one-device decode, equal to greedy_decode."""
    w = init_weights(TP, torch.Generator().manual_seed(13), device="cpu")
    x, lens = (torch.from_numpy(a) for a in _inputs(14, N=4))
    fq = fake_quantize_weights(w, calibrate(w, [(x, lens)], TP), TP)
    mesh = _tp("1x2")
    got = tensor.greedy_decode_tp(mesh, tmesh.weight_shardings(mesh, fq, tensor_parallel=True),
                                  x, lens, TP)
    want = greedy_decode(fq, x, lens, TP)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _edits(a, b) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_tp_decode_matches_jax_tp(quant):
    """The port's TP decode on 2 x 2 against JAX's greedy_decode on
    make_mesh(4, model_parallel=2) (tests/test_parallel.py's build): tokens
    and lengths equal, or parting only where the port's decode parts from
    its one-device twin at near-ties, at an edit rate <= 1e-3."""
    jw, tw = _models(15 if quant else 2, quant)
    x, lens = _inputs(16)
    jm = jmesh.make_mesh(4, model_parallel=2)
    w_sh = jax.device_put(jw, jmesh.weight_shardings(jm, jw, tensor_parallel=True))
    step = jax.jit(
        lambda w, x, l: jgreedy_decode(w, x, l, params=JP),
        out_shardings=(NamedSharding(jm, JPS("data", None)), NamedSharding(jm, JPS("data"))),
    )
    with jm:
        jres, jlens = step(w_sh, jax.device_put(jnp.asarray(x), jmesh.batch_sharding(jm)),
                           jax.device_put(jnp.asarray(lens), jmesh.lens_sharding(jm)))
    jres, jlens = np.asarray(jres), np.asarray(jlens)
    mesh = _tp("2x2")
    wr = tmesh.weight_shardings(mesh, tw, tensor_parallel=True)
    run = lambda: tensor.greedy_decode_tp(mesh, wr, torch.from_numpy(x), torch.from_numpy(lens),
                                          TP)
    res, rlens = (t.numpy() for t in run())
    assert int(jlens.sum()) > 0
    if np.array_equal(res, jres) and np.array_equal(rlens, jlens):
        return
    got = [res[i, :rlens[i]].tolist() for i in range(len(rlens))]
    want = [jres[i, :jlens[i]].tolist() for i in range(len(jlens))]
    edits = sum(_edits(a, b) for a, b in zip(got, want))
    assert edits / max(sum(len(t) for t in want), 1) <= 1e-3
    _, summary = compare_tp_run_launches(run)
    assert summary["faults"] == 0, summary
