"""The port's sequence-packed Offline runner against the JAX package's, on
the CPU at the golden bundle's small width: the pack plan, kernel B's twin
in packed mode, PackedOfflineRunner on the cases of tests/test_packing.py,
the golden ``packed`` mode, the harness and the lane guard.

Tolerance: tokens equal (and plans, markers and cursors equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.data.dataset import SampleStore as JSampleStore
from rnnt_inference_tpu.models import decoder as jdec
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.runtime import harness as jharness
from rnnt_inference_tpu.runtime.packing import PackedOfflineRunner as JPackedRunner
from rnnt_inference_tpu.runtime.packing import make_pack_plan as jmake_pack_plan
from rnnt_inference_tpu.runtime.qsl import QuerySampleLibrary as JQSL
from rnnt_inference_tpu.utils.golden import load_golden
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models import decoder as tdec
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.runtime import harness as tharness
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner, make_pack_plan
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)


def _params(**kw):
    return dataclasses.replace(JP, **kw), dataclasses.replace(TP, **kw)


def _port(w, kind, tp):
    return weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(w)[0]], kind, tp,
                                     "cpu")


def _quant(jw, jp, seed, T=16):
    xc = jax.random.normal(jax.random.PRNGKey(seed), (T, 4, jp.trans_input_size))
    return jquantize_weights(jw, jcalibrate(jw, [(xc, jnp.full((4,), T, jnp.int32))], jp), jp)


def _stores(n, seed, max_seconds=2.5, min_seconds=0.3, mean_seconds=1.0):
    kw = dict(n=n, seed=seed, min_seconds=min_seconds, max_seconds=max_seconds,
              mean_seconds=mean_seconds)
    return JSampleStore.synthetic(**kw), SampleStore.synthetic(**kw)


def _both_runs(jw, tw, jp, tp, stores, buckets, **kw):
    """The JAX and the port's PackedOfflineRunner on the same store: (JAX
    result, port result, JAX runner, port runner)."""
    js, ts = stores
    jr = JPackedRunner(jw, jp, JFeaturizerConfig(), **kw)
    jr.stage(JQSL(js, JFeaturizerConfig(), wav_buckets_s=buckets))
    tr = PackedOfflineRunner(tw, tp, FeaturizerConfig(), device="cpu", **kw)
    tr.stage(QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=buckets))
    return jr.run_device(), tr.run_device(), jr, tr


def _assert_tokens_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"sample {i}")


@pytest.mark.parametrize("n_lanes,chunk_frames", [(3, 16), (2, 8), (5, 32), (7, 4), (1, 16)])
def test_pack_plan_matches_jax(n_lanes, chunk_frames):
    """Same entries (the longest-first heap bin-pack, ties included),
    chunk_lens, resets and efficiency on random lengths."""
    lens = np.random.RandomState(n_lanes * 31 + chunk_frames).randint(0, 90, 23)
    lens[:3] = [64, 64, 1]
    want = jmake_pack_plan(lens, n_lanes, chunk_frames)
    got = make_pack_plan(lens, n_lanes, chunk_frames)
    assert got.entries == want.entries
    assert got.n_chunks == want.n_chunks
    np.testing.assert_array_equal(got.chunk_lens, want.chunk_lens)
    np.testing.assert_array_equal(got.resets, want.resets)
    assert got.packing_efficiency == want.packing_efficiency


@pytest.fixture(scope="module")
def f32_weights():
    jw = jinit_weights(jax.random.PRNGKey(0), JP)
    return jw, _port(jw, "rnnt_weights", TP)


@pytest.mark.parametrize("n_lanes,chunk_frames", [(3, 16), (2, 8), (5, 32)])
def test_packed_runner_matches_jax(f32_weights, n_lanes, chunk_frames):
    """tests/test_packing.py::test_packed_tokens_exact's cases: the port's
    runner gives the JAX runner's tokens, plan and result width."""
    jw, tw = f32_weights
    jres, tres, jr, tr = _both_runs(jw, tw, JP, TP, _stores(9, 1), (1.0, 2.0, 3.0),
                                    n_lanes=n_lanes, chunk_frames=chunk_frames, batch_size=4)
    _assert_tokens_equal(tres.tokens, jres.tokens)
    assert tr.plan.entries == jr.plan.entries
    assert tr._params_pack.max_res_len == jr._params_pack.max_res_len
    assert tr._utt_budget == jr._utt_budget
    assert tres.batches == jres.batches
    assert set(tres.phase_seconds) == {"features", "encoder", "decode"}


@pytest.mark.parametrize("decode_chunk", [2, 3, 8])
def test_packed_decode_pieces_match_jax(decode_chunk):
    """test_packed_decode_chunking_exact's cases: decode pieces so short that
    utterances start exactly at a piece's first frame (reset between
    pieces)."""
    jw = jinit_weights(jax.random.PRNGKey(3), JP)
    jres, tres, _, _ = _both_runs(jw, _port(jw, "rnnt_weights", TP), JP, TP, _stores(9, 2),
                                  (1.0, 2.0, 3.0), n_lanes=3, chunk_frames=16, batch_size=4,
                                  decode_chunk=decode_chunk)
    _assert_tokens_equal(tres.tokens, jres.tokens)


def test_packed_runner_quant_matches_jax():
    """test_packed_tokens_exact_quant: the int8 encoder."""
    jw = _quant(jinit_weights(jax.random.PRNGKey(0), JP), JP, 1)
    jres, tres, _, _ = _both_runs(jw, _port(jw, "rnnt_quant_weights", TP), JP, TP,
                                  _stores(6, 2), (1.0, 2.0, 3.0), n_lanes=2, chunk_frames=16,
                                  batch_size=4)
    _assert_tokens_equal(tres.tokens, jres.tokens)


@pytest.mark.parametrize("case", ["capacity_cap3", "budget_truncation", "gate_off_cap1"])
def test_packed_budget_matches_jax(case):
    """The result capacity at cap 3 (test_packed_res_capacity_never_truncates),
    budget truncation at max_res_len 8 and cap 3 (the gate binds: some
    utterance keeps exactly 8 tokens), and the gate off at cap 1
    (utt_budget 0 in both packages)."""
    kw, seed, store, buckets, lanes = {
        "capacity_cap3": (dict(max_symbols_per_step=3), 5, _stores(4, 4, 1.0), (1.0,), 2),
        "budget_truncation": (dict(max_res_len=8, max_symbols_per_step=3), 5, _stores(6, 4, 1.0),
                              (1.0,), 2),
        "gate_off_cap1": (dict(max_symbols_per_step=1), 8, _stores(6, 12, 1.0), (1.0,), 8),
    }[case]
    jp, tp = _params(**kw)
    jw = jinit_weights(jax.random.PRNGKey(seed), jp)
    jres, tres, jr, tr = _both_runs(jw, _port(jw, "rnnt_weights", tp), jp, tp, store, buckets,
                                    n_lanes=min(lanes, len(store[0])),
                                    chunk_frames=8, batch_size=lanes)
    _assert_tokens_equal(tres.tokens, jres.tokens)
    assert tr._utt_budget == jr._utt_budget
    assert tr._params_pack.max_res_len == jr._params_pack.max_res_len
    if case == "budget_truncation":
        assert tr._utt_budget == 8 and any(len(t) == 8 for t in tres.tokens)
    if case == "gate_off_cap1":
        assert tr._utt_budget == 0 and sum(len(t) for t in tres.tokens) > 0


def test_golden_packed_mode(monkeypatch):
    """tests/golden/golden.npz's packed mode, token for token: the golden
    quantized weights, 3 lanes, 16-frame chunks, batch 4, buckets 1 s and
    2 s (rnnt_inference_tpu/utils/golden.py).

    The runner's featurizer is the JAX package's for the token-for-token
    check (fed the same int16 batches, its features carried over as
    numpy).  Preemphasis is bit-equal between the two featurizers
    (tests/test_torch_ops.py); their f32 DFT products are not: XLA:CPU
    sums a dot in an order that depends on its row count, so JAX's own
    features of an utterance move with the batch it is featurized in, by
    as much as they differ from the port's
    (test_jax_featurizer_depends_on_batch_rows).  That moves an int8
    rounding of the encoder input and one of the eight golden utterances
    at a near-tie (the next test; ROADMAP.md section 3, "Not a fault").
    Everything after the features (packing, chunked int8 encoder, packed
    decode, harvest) is the port's.  With the port's own featurizer at
    least seven of the eight are equal."""
    from rnnt_inference_tpu.ops.features import log_mel_features as jlog_mel
    from rnnt_inference_tpu.utils import golden as jgolden
    from rnnt_inference_tpu_torch.runtime import packing

    jp = jgolden._small_params()
    tp = RNNTParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    w32 = jinit_weights(jax.random.PRNGKey(jgolden.SEED_WEIGHTS), jp, dtype=jnp.float32)
    wq = _port(_quant(w32, jp, jgolden.SEED_WEIGHTS + 1), "rnnt_quant_weights", tp)
    store = SampleStore.synthetic(n=jgolden.N_SAMPLES, seed=jgolden.SEED_STORE, min_seconds=0.4,
                                  max_seconds=2.0, mean_seconds=1.0)
    want = load_golden(os.path.join(REPO, "tests", "golden", "golden.npz"))["packed"]

    def tokens():
        runner = PackedOfflineRunner(wq, tp, FeaturizerConfig(), n_lanes=3, chunk_frames=16,
                                     batch_size=4, device="cpu")
        runner.stage(QuerySampleLibrary(store, FeaturizerConfig(), wav_buckets_s=(1.0, 2.0)))
        return runner.run_device().tokens

    own = tokens()
    assert len(own) == len(want)
    assert sum(np.array_equal(g, w) for g, w in zip(own, want)) >= len(want) - 1

    def jax_features(wav, lens, cfg):
        feats, flens = jlog_mel(jnp.asarray(wav.numpy()), jnp.asarray(lens.numpy()),
                                JFeaturizerConfig())
        return torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(flens))

    monkeypatch.setattr(packing, "log_mel_features", jax_features)
    got = tokens()
    _assert_tokens_equal(got, want)
    assert sum(len(t) for t in got) > 0


def test_golden_packed_port_featurizer_flip_is_a_near_tie(monkeypatch):
    """Why the port's own featurizer does not give every golden packed
    utterance: each utterance it misses is decoded alone (the packed
    decode gives a standalone decode's tokens) on its rows of the staged
    batch's features from either featurizer, one iteration per step with
    the twin's logits recorded.  The port's features reproduce the port's
    packed tokens and the JAX package's reproduce golden; the features
    differ by at most 1e-4 (tests/test_torch_ops.py's tolerance for the
    featurizer: with preemphasis bit-equal, the f32 DFT sums differ in
    order, and XLA:CPU's order moves with the batch's row count,
    test_jax_featurizer_depends_on_batch_rows); the two decodes agree up
    to one iteration, where the prediction state is the same (it depends
    on the tokens only) and the symbols part by a logit gap no larger
    than the shift the features' difference makes in the logits there,
    and at most 1e-3."""
    from rnnt_inference_tpu.ops.features import log_mel_features as jlog_mel
    from rnnt_inference_tpu.utils import golden as jgolden
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode
    from rnnt_inference_tpu_torch.ops import decode_cuda as dc
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    jp = jgolden._small_params()
    tp = RNNTParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    w32 = jinit_weights(jax.random.PRNGKey(jgolden.SEED_WEIGHTS), jp, dtype=jnp.float32)
    wq = _port(_quant(w32, jp, jgolden.SEED_WEIGHTS + 1), "rnnt_quant_weights", tp)
    store = SampleStore.synthetic(n=jgolden.N_SAMPLES, seed=jgolden.SEED_STORE, min_seconds=0.4,
                                  max_seconds=2.0, mean_seconds=1.0)
    want = load_golden(os.path.join(REPO, "tests", "golden", "golden.npz"))["packed"]
    qsl = QuerySampleLibrary(store, FeaturizerConfig(), wav_buckets_s=(1.0, 2.0))
    runner = PackedOfflineRunner(wq, tp, FeaturizerConfig(), n_lanes=3, chunk_frames=16,
                                 batch_size=4, device="cpu")
    runner.stage(qsl)
    own = runner.run_device().tokens
    missed = [i for i, (g, w) in enumerate(zip(own, want)) if not np.array_equal(g, w)]
    assert len(missed) <= 1

    log = []

    def recording(fproj, lanes, hg, cg, res, dw, params, steps, impl=None, **kw):
        for _ in range(steps):
            log.append(dc.decode_logits_reference(fproj, lanes, hg, cg, dw, params)[0][0].clone())
            dc.decode_step_reference(fproj, lanes, hg, cg, res, dw, params, **kw)

    monkeypatch.setattr(dc, "decode_step", recording)
    for wav, lens, rows in qsl.load_to_device(4, device="cpu").batches():
        x = wav.float() * (1.0 / 32768.0)
        tf = log_mel_features(x, lens)[0]
        jf = torch.from_numpy(np.array(jlog_mel(jnp.asarray(x.numpy()),
                                                jnp.asarray(lens.numpy()), JFeaturizerConfig())[0]))
        for r in [r for r, i in enumerate(rows) if i in missed]:
            u, F = int(rows[r]), FeaturizerConfig().out_frames(int(lens[r]))
            assert float((tf[:F, r] - jf[:F, r]).abs().max()) <= 1e-4
            runs = []
            for feats, tokens in ((tf, own[u]), (jf, want[u])):
                log.clear()
                with torch.no_grad():
                    res, n = greedy_decode(wq, feats[:F, r : r + 1], torch.tensor([F]), tp,
                                           steps_per_check=1)
                np.testing.assert_array_equal(res[0, : int(n[0])].numpy(), tokens)
                runs.append(torch.stack(log))
            port, jax_ = runs
            sym_p, sym_j = port.argmax(-1), jax_.argmax(-1)
            k = int(torch.nonzero(sym_p[: len(sym_j)] != sym_j[: len(sym_p)])[0])
            gap = float(jax_[k, sym_j[k]] - jax_[k, sym_p[k]])
            shift = float((port[k] - jax_[k]).abs().max())
            print(f"utterance {u}: parts at iteration {k}, symbols {int(sym_p[k])} (port "
                  f"features) / {int(sym_j[k])} (JAX), gap {gap:.3g}, logit shift {shift:.3g}")
            assert 0 <= gap <= shift and gap <= 1e-3


def test_jax_featurizer_depends_on_batch_rows():
    """The summation order of XLA:CPU's f32 GEMMs changes with the number of
    rows in the dot, so no fixed order in the port could reproduce JAX's
    features bit for bit.  (a) Rows 0-6 of a (M, 320) x (320, 257)
    jnp.dot computed with M = 7 and with M = 600 agree bit for bit in under
    half of their entries; torch's rows do not depend on M.  (b) JAX's own
    log_mel_features of the golden store's utterances, featurized alone and
    inside the packed runner's 4-row batches, differ by more than 1e-5 on
    some utterance: as much as the port's features differ from JAX's, all
    within tests/test_torch_ops.py's 1e-4."""
    from rnnt_inference_tpu.ops.features import log_mel_features as jlog_mel
    from rnnt_inference_tpu.utils import golden as jgolden
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    rng = np.random.RandomState(0)
    a = rng.randn(600, 320).astype(np.float32)
    b = rng.randn(320, 257).astype(np.float32)
    dot = jax.jit(jnp.dot)
    j7, j600 = np.asarray(dot(a[:7], b)), np.asarray(dot(a, b))[:7]
    assert (j7 == j600).mean() < 0.5 and np.abs(j7 - j600).max() > 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(ta[:7] @ tb, (ta @ tb)[:7])

    store = SampleStore.synthetic(n=jgolden.N_SAMPLES, seed=jgolden.SEED_STORE, min_seconds=0.4,
                                  max_seconds=2.0, mean_seconds=1.0)
    qsl = QuerySampleLibrary(store, FeaturizerConfig(), wav_buckets_s=(1.0, 2.0))
    feat = jax.jit(jlog_mel, static_argnames="cfg")
    jax_moves, port_vs_jax = [], []
    for wav, lens, rows in qsl.load_to_device(4, device="cpu").batches():
        x, L = (wav.float() * (1.0 / 32768.0)).numpy(), lens.numpy()
        batched = np.asarray(feat(jnp.asarray(x), jnp.asarray(L), JFeaturizerConfig())[0])
        port = log_mel_features(torch.from_numpy(x), torch.from_numpy(L))[0].numpy()
        for r in [r for r, i in enumerate(rows) if i >= 0]:
            n, F = int(L[r]), FeaturizerConfig().out_frames(int(L[r]))
            alone = np.asarray(feat(jnp.asarray(x[r : r + 1, :n]), jnp.asarray(L[r : r + 1]),
                                    JFeaturizerConfig())[0])[:F, 0]
            jax_moves.append(float(np.abs(alone - batched[:F, r]).max()))
            port_vs_jax.append(float(np.abs(port[:F, r] - batched[:F, r]).max()))
    print(f"JAX alone vs batched: max {max(jax_moves):.3g}; port vs JAX: "
          f"{min(port_vs_jax):.3g} to {max(port_vs_jax):.3g}")
    assert len(jax_moves) == jgolden.N_SAMPLES
    assert 1e-5 < max(jax_moves) <= 1e-4 and max(port_vs_jax) <= 1e-4


def _packed_chunk_inputs(rng, N, T2, H, R):
    """One packed decode chunk: f, f_lens, utterance starts on about half
    the frames, lanes mid-timeline (res_idx, res_base) and in any pre_g."""
    f = rng.randn(T2, N, H).astype(np.float32)
    f_lens = rng.randint(1, T2 + 1, N).astype(np.int32)
    starts = rng.rand(T2, N) < 0.5
    starts[0] = True
    res_idx = rng.choice([-1, 3, 9, R - 2], N).astype(np.int32)
    rb = np.maximum(res_idx - rng.randint(0, 6, N), -1).astype(np.int32)
    pre_g = rng.randint(-1, 28, N).astype(np.int32)
    return f, f_lens, starts, res_idx, rb, pre_g


@pytest.mark.parametrize("budget", [0, 4])
def test_packed_twin_matches_jax_xla_body(budget):
    """Kernel B's twin in packed mode (through greedy_decode_chunk_packed's
    host loop) against the JAX XLA body with starts at the full prediction
    and joint widths (P=320, J=512, f32): one chunk whose lanes enter
    utterances, bind the budget (4 tokens) or run without it (0), and
    finish.  Tokens, markers, cursors and pre_g equal; hg and cg within
    1e-5 (f32 sums in two libraries' orders)."""
    full = dict(DIMS, pred_hidden_size=320, joint_hidden_size=512, max_res_len=48)
    jp, tp = JParams(**full), RNNTParams(**full)
    jw = jinit_weights(jax.random.PRNGKey(11), jp)
    tw = _port(jw, "rnnt_weights", tp)
    N, T2, H, R, L = 12, 5, 64, full["max_res_len"], 2
    rng = np.random.RandomState(5)
    f, f_lens, starts, res_idx, rb, pre_g = _packed_chunk_inputs(rng, N, T2, H, R)
    hg = (rng.randn(L, N, 320) * 0.5).astype(np.float32)
    cg = (rng.randn(L, N, 320) * 0.5).astype(np.float32)
    res = np.full((N, R), -1, np.int8)

    jst = jdec.init_decode_state(N, jp)
    jst = dataclasses.replace(jst, res=jnp.asarray(res), res_idx=jnp.asarray(res_idx),
                              pre_g=jnp.asarray(pre_g), hg=jnp.asarray(hg), cg=jnp.asarray(cg))
    jout, jrb = jdec._greedy_decode_chunk_xla(
        jw, jst, jnp.asarray(f), jnp.asarray(f_lens), jp, starts=jnp.asarray(starts),
        res_base=jnp.asarray(rb), utt_budget=budget)

    t = torch.from_numpy
    tst = tdec.init_decode_state(N, tp, device="cpu")
    tst = dataclasses.replace(tst, res=t(res.copy()), res_idx=t(res_idx.copy()),
                              pre_g=t(pre_g.copy()), hg=t(hg.copy()), cg=t(cg.copy()))
    with torch.no_grad():
        tout, trb = tdec.greedy_decode_chunk_packed(tw, tst, t(f), t(f_lens), tp, t(starts),
                                                    t(rb), budget, steps_per_check=7)
    np.testing.assert_array_equal(tout.res.numpy(), np.asarray(jout.res))
    np.testing.assert_array_equal(tout.res_idx.numpy(), np.asarray(jout.res_idx))
    np.testing.assert_array_equal(tout.pre_g.numpy(), np.asarray(jout.pre_g))
    np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))
    np.testing.assert_allclose(tout.hg.numpy(), np.asarray(jout.hg), atol=1e-5)
    np.testing.assert_allclose(tout.cg.numpy(), np.asarray(jout.cg), atol=1e-5)
    # the case covers what it says: markers written, and with a budget some
    # utterance held at it
    assert int((tout.res == tdec.PACK_BOUNDARY).sum()) >= 2
    if budget:
        seg_full = trb.numpy() + budget == tout.res_idx.numpy()
        assert seg_full.any()


def test_masked_reset_decode_matches_jax():
    """masked_reset_decode with keep_res True and False: the JAX results."""
    rng = np.random.RandomState(2)
    N = 5
    mask = np.array([1, 0, 1, 0, 0], bool)
    arrays = dict(res=rng.randint(-1, 28, (N, 16)).astype(np.int8),
                  res_idx=rng.randint(-1, 16, N).astype(np.int32),
                  pre_g=rng.randint(-1, 28, N).astype(np.int32),
                  hg=rng.randn(2, N, 32).astype(np.float32),
                  cg=rng.randn(2, N, 32).astype(np.float32))
    enc = {k: rng.randn(L, N, 64).astype(np.float32)
           for k, L in (("pre_h", 2), ("pre_c", 2), ("post_h", 3), ("post_c", 3))}
    from rnnt_inference_tpu.models import rnnt as jrnnt
    from rnnt_inference_tpu_torch.models import rnnt as trnnt

    jst = jdec.DecodeState(enc=jrnnt.EncoderState(**{k: jnp.asarray(v) for k, v in enc.items()}),
                           **{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = tdec.DecodeState(enc=trnnt.EncoderState(**{k: torch.from_numpy(v)
                                                     for k, v in enc.items()}),
                           **{k: torch.from_numpy(v) for k, v in arrays.items()})
    for keep in (True, False):
        j = jdec.masked_reset_decode(jst, jnp.asarray(mask), JP, keep_res=keep)
        g = tdec.masked_reset_decode(tst, torch.from_numpy(mask), TP, keep_res=keep)
        for k in arrays:
            np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(j, k)))
        for k in enc:
            np.testing.assert_array_equal(getattr(g.enc, k).numpy(), np.asarray(getattr(j.enc, k)))


def test_load_to_device_indices_match_jax():
    """DeviceQSL over a subset of the samples (load_to_device's indices, as
    the packed runner stages them): the JAX package's batches."""
    js, ts = _stores(9, 6)
    idx = [7, 2, 5, 0, 8]
    jd = JQSL(js, JFeaturizerConfig(), wav_buckets_s=(1.0, 2.0)).load_to_device(2, idx)
    td = QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=(1.0, 2.0)).load_to_device(
        2, idx, device="cpu")
    seen = []
    for (jw, jl, jr), (tw, tl, tr) in zip(jd.batches(), td.batches(), strict=True):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr, jr)
        seen += [int(i) for i in tr if i >= 0]
    assert sorted(seen) == sorted(idx)


def test_run_offline_packed_matches_jax(f32_weights, tmp_path):
    """run_offline(packed=True) in both packages (test_run_offline_packed_
    harness): equal hypotheses, byte-equal accuracy logs, and the report's
    packing_efficiency, pack_chunks and chunk_frames; the port's packed
    hypotheses equal its bucketed ones."""
    jw, tw = f32_weights
    js, ts = _stores(7, 3)
    kw = dict(batch_size=4, warmup=False, packed=True, chunk_frames=16)
    jrep = jharness.run_offline(jw, js, JP, JFeaturizerConfig(), output_dir=str(tmp_path / "j"),
                                **kw)
    trep = tharness.run_offline(tw, ts, TP, FeaturizerConfig(), output_dir=str(tmp_path / "t"),
                                device="cpu", **kw)
    assert trep.hypotheses == jrep.hypotheses
    logs = [open(tmp_path / d / "accuracy_log.json").read() for d in "jt"]
    assert logs[0] == logs[1]
    for k in ("packing_efficiency", "pack_chunks", "chunk_frames", "batches", "batch_size"):
        assert trep.extra[k] == jrep.extra[k], k
    assert trep.summary().keys() == jrep.summary().keys()
    bucketed = tharness.run_offline(tw, ts, TP, batch_size=4, device="cpu")
    assert trep.hypotheses == bucketed.hypotheses


def test_packed_lane_guard(f32_weights):
    """No lane idles: the runner refuses more lanes than utterances, the
    harness packs a store smaller than the batch into one lane per
    utterance (tokens equal the bucketed run's), and an empty store fails
    loudly."""
    _, tw = f32_weights
    _, ts = _stores(3, 8, 1.0)
    qsl = QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=(1.0,))
    with pytest.raises(ValueError, match="idle"):
        PackedOfflineRunner(tw, TP, n_lanes=4, chunk_frames=8, device="cpu").stage(qsl)
    rep = tharness.run_offline(tw, ts, TP, batch_size=16, packed=True, warmup=False,
                               chunk_frames=8, device="cpu")
    assert rep.hypotheses == tharness.run_offline(tw, ts, TP, batch_size=4,
                                                  device="cpu").hypotheses
    assert rep.extra["packing_efficiency"] > 0
    with pytest.raises(ValueError, match="at least one"):
        tharness.run_offline(tw, ts.select([]), TP, packed=True, device="cpu")
