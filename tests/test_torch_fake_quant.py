"""The port's fake_quant run mode and iLinear against the JAX package's, on
the CPU at the golden bundle's small width: the iLinear functions on the
cases of tests/test_quant.py, the fake-quantized weights, the fake_quant
LSTM stack and encoder, golden ``fake_quant`` token for token, and the
packed runner and the Server on fake_quant weights.

Tolerances: 1e-5 for f32 products (summation order); fake-quantized
weights and scales bit-equal; tokens equal.
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
from rnnt_inference_tpu.models import quant as jquant
from rnnt_inference_tpu.models import rnnt as jrnnt
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.ops import lstm as jlstm
from rnnt_inference_tpu.runtime import scheduler as jscheduler
from rnnt_inference_tpu.runtime.packing import PackedOfflineRunner as JPackedRunner
from rnnt_inference_tpu.runtime.qsl import QuerySampleLibrary as JQSL
from rnnt_inference_tpu.runtime.server import ServerRunner as JServerRunner
from rnnt_inference_tpu.utils import golden as jgolden
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models import quant as tquant
from rnnt_inference_tpu_torch.models import rnnt as trnnt
from rnnt_inference_tpu_torch.models.decoder import greedy_decode
from rnnt_inference_tpu_torch.models.weights import (
    LSTMLayerWeights,
    numpy_leaves,
    weights_from_numpy_leaves,
)
from rnnt_inference_tpu_torch.ops import lstm as tlstm
from rnnt_inference_tpu_torch.ops.features import log_mel_features
from rnnt_inference_tpu_torch.runtime import scheduler as tscheduler
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
from rnnt_inference_tpu_torch.runtime.server import ServerRunner

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
t = torch.from_numpy
j = jnp.asarray


def _np(a):
    return np.array(a, np.float32)


def _fake_quant_pair(seed, jp=JP, tp=TP):
    """JAX f32 weights of ``seed`` calibrated on 16 random frames, both
    packages' fake_quant models (the port's from the same f32 weights and
    amaxes), and the JAX f32 weights."""
    w32 = jinit_weights(jax.random.PRNGKey(seed), jp, dtype=jnp.float32)
    xc = jax.random.normal(jax.random.PRNGKey(seed + 1), (16, 4, jp.trans_input_size))
    calib = jquant.calibrate(w32, [(xc, jnp.full((4,), 16, jnp.int32))], jp)
    tw = weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(w32)[0]],
                                   "rnnt_weights", tp, "cpu")
    tcal = tquant.CalibState(pre_amax=t(_np(calib.pre_amax)), post_amax=t(_np(calib.post_amax)))
    return (jquant.fake_quantize_weights(w32, calib, jp),
            tquant.fake_quantize_weights(tw, tcal, tp), w32, tw)


def test_quant_linear_matches_jax():
    """tests/test_quant.py's iLinear case: within 1e-5 (both sum the int8
    products exactly; the dequantization is the same f32 arithmetic)."""
    rng = np.random.RandomState(0)
    w = rng.randn(24, 20).astype(np.float32)
    b = rng.randn(20).astype(np.float32)
    x = rng.randn(6, 24).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 1.1)
    jql = jquant.quantize_linear(j(w), j(b), j(amax))
    tql = tquant.quantize_linear(t(w), t(b), t(np.array(amax)))
    np.testing.assert_array_equal(tql.w_i8.numpy(), np.asarray(jql.w_i8))
    for name in ("in_scale", "w_scale", "o_scale"):
        np.testing.assert_array_equal(getattr(tql, name).numpy(), np.asarray(getattr(jql, name)))
    np.testing.assert_allclose(tquant.quant_linear_apply(tql, t(x)).numpy(),
                               _np(jquant.quant_linear_apply(jql, j(x))), rtol=1e-5, atol=1e-5)


def test_fake_quant_linear_matches_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    x = rng.randn(4, 16).astype(np.float32)
    amax = np.float32(2.5)
    want = jquant.fake_quant_linear_apply(j(w), j(b), j(amax), j(x))
    got = tquant.fake_quant_linear_apply(t(w), t(b), t(np.array(amax)), t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_joint_quant_fc1_matches_jax():
    """The joint with its transcription-side fc1 in int8, on the weights of
    tests/test_quant.py's case (seed 3): within 1e-5 of JAX's."""
    jw = jinit_weights(jax.random.PRNGKey(3), JP)
    tw = weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(jw)[0]],
                                   "rnnt_weights", TP, "cpu")
    rng = np.random.RandomState(2)
    f = rng.randn(4, JP.trans_hidden_size).astype(np.float32)
    g = rng.randn(4, JP.pred_hidden_size).astype(np.float32)
    amax = np.float32(np.abs(f).max())
    jql = jquant.quantize_joint_fc1_trans(jw, j(amax))
    tql = tquant.quantize_joint_fc1_trans(tw, t(np.array(amax)))
    np.testing.assert_array_equal(tql.w_i8.numpy(), np.asarray(jql.w_i8))
    want = jquant.joint_quant_fc1(jw, jql, j(f), j(g))
    got = tquant.joint_quant_fc1(tw, tql, t(f), t(g))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_fake_quantize_weights_match_jax():
    """Fake-quantized encoder weights (a division by the scale, as JAX) and
    the calibrated activation scales: bit-equal; the rest passes through."""
    jfq, tfq, _, _ = _fake_quant_pair(21)
    for a, b in zip(jax.tree.flatten(jfq)[0], numpy_leaves(tfq), strict=True):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_fake_quant_lstm_stack_matches_jax():
    """Two layers over a chunk from nonzero state: y, h, c within 1e-5."""
    rng = np.random.RandomState(4)
    T, N, IC, H = 9, 3, 24, 16
    layers, scales = [], np.array([127 / 2.5, 127 / 1.5], np.float32)
    for ic in (IC, H):
        k = 1.0 / np.sqrt(H)
        layers.append([rng.uniform(-k, k, s).astype(np.float32)
                       for s in ((ic, 4 * H), (H, 4 * H), (4 * H,))])
    x = rng.randn(T, N, IC).astype(np.float32)
    hs = (rng.randn(2, N, H) * 0.5).astype(np.float32)
    cs = (rng.randn(2, N, H) * 0.5).astype(np.float32)
    want = jlstm.fake_quant_lstm_stack([jlstm.LSTMLayerWeights(*map(j, l)) for l in layers],
                                       j(scales), j(x), j(hs), j(cs))
    got = tlstm.fake_quant_lstm_stack([LSTMLayerWeights(*map(t, l)) for l in layers],
                                      t(scales), t(x), t(hs), t(cs))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5)


def test_fake_quant_transcription_matches_jax():
    """The encoder on fake_quant weights (pre layers, stack_time, post
    layers) over features of two lengths: within 1e-5."""
    jfq, tfq, _, _ = _fake_quant_pair(21)
    rng = np.random.RandomState(5)
    x = rng.randn(14, 2, 240).astype(np.float32)
    lens = np.array([14, 9], np.int32)
    jf, _ = jrnnt.transcription(jfq, j(x), j(lens), jrnnt.init_encoder_state(2, JP))
    tf, _ = trnnt.transcription(tfq, t(x), t(lens), trnnt.init_encoder_state(2, TP, device="cpu"))
    np.testing.assert_allclose(tf.numpy(), _np(jf), atol=1e-5)


@pytest.mark.parametrize("featurizer", ["port", "jax"])
def test_golden_fake_quant_mode(featurizer):
    """tests/golden/golden.npz's fake_quant mode, token for token: the
    golden f32 weights and calibration (rnnt_inference_tpu/utils/golden.py)
    through the port's fake_quantize_weights and greedy decode, each
    utterance featurized alone, by the port's featurizer and by the JAX
    package's: all eight equal either way."""
    from rnnt_inference_tpu.ops.features import log_mel_features as jlog_mel

    jp = jgolden._small_params()
    tp = RNNTParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    _, wfq, _, _ = _fake_quant_pair(jgolden.SEED_WEIGHTS, jp, tp)
    store = SampleStore.synthetic(n=jgolden.N_SAMPLES, seed=jgolden.SEED_STORE, min_seconds=0.4,
                                  max_seconds=2.0, mean_seconds=1.0)
    want = jgolden.load_golden(os.path.join(REPO, "tests", "golden", "golden.npz"))["fake_quant"]
    jfeat = jax.jit(jlog_mel, static_argnames="cfg")
    got = []
    for s in store.samples:
        wav, lens = s[None], np.array([len(s)], np.int32)
        if featurizer == "port":
            feats, flens = log_mel_features(t(wav), t(lens))
        else:
            jf_, jl_ = jfeat(j(wav), j(lens), JFeaturizerConfig())
            feats, flens = t(np.array(jf_)), t(np.array(jl_))
        res, n = greedy_decode(wfq, feats, flens, tp)
        got.append(res[0, : int(n[0])].numpy().astype(np.int32))
    assert len(got) == len(want) == jgolden.N_SAMPLES
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) > 0


@pytest.mark.parametrize("runner", ["packed", "server"])
def test_fake_quant_runners_match_jax(runner):
    """The packed Offline runner and the Server take fake_quant weights, as
    the JAX package's do: tokens equal to the JAX runner's on the same
    store."""
    jfq, tfq, _, _ = _fake_quant_pair(7)
    kw = dict(n=5, seed=3, min_seconds=0.3, max_seconds=1.0, mean_seconds=0.6)
    js, ts = JSampleStore.synthetic(**kw), SampleStore.synthetic(**kw)
    if runner == "packed":
        jr = JPackedRunner(jfq, JP, JFeaturizerConfig(), n_lanes=2, chunk_frames=8, batch_size=4)
        jr.stage(JQSL(js, JFeaturizerConfig(), wav_buckets_s=(1.0,)))
        tr = PackedOfflineRunner(tfq, TP, FeaturizerConfig(), n_lanes=2, chunk_frames=8,
                                 batch_size=4, device="cpu")
        tr.stage(QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=(1.0,)))
        want, got = jr.run_device().tokens, tr.run_device().tokens
    else:
        skw = dict(slots=2, split_len=4, max_frames=64, insert_batch=2)
        _, jres = jscheduler.run_server(JServerRunner(jfq, JP, JFeaturizerConfig(), **skw), js,
                                        target_qps=1000.0, realtime=False, max_wall_s=120.0)
        _, tres = tscheduler.run_server(ServerRunner(tfq, TP, FeaturizerConfig(), device="cpu",
                                                     **skw), ts, target_qps=1000.0,
                                        realtime=False, max_wall_s=120.0)
        want, got = [jres[q] for q in range(5)], [tres[q] for q in range(5)]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert sum(len(g) for g in got) > 0
