"""The port's runtime against the JAX package's, on the CPU at the golden
bundle's small width: batch plan, DeviceQSL and run_device, the packed
readback, features stores, the harness (accuracy log, SingleStream), conf
parsing, WER, sample stores and checkpoints.

Tokens and accuracy logs must be equal; floats as stated per test.
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
from rnnt_inference_tpu.models import checkpoint as jckpt
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.ops.features import log_mel_features as jlog_mel
from rnnt_inference_tpu.runtime import config as jconfig
from rnnt_inference_tpu.runtime import harness as jharness
from rnnt_inference_tpu.runtime.offline import OfflineRunner as JOfflineRunner
from rnnt_inference_tpu.runtime.qsl import QuerySampleLibrary as JQSL
from rnnt_inference_tpu.runtime.qsl import batch_plan as jbatch_plan
from rnnt_inference_tpu.utils import wer as jwer
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models import checkpoint as tckpt
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.runtime import config as tconfig
from rnnt_inference_tpu_torch.runtime import harness as tharness
from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary, batch_plan
from rnnt_inference_tpu_torch.utils import labels as tlabels
from rnnt_inference_tpu_torch.utils import wer as twer

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
STORE = dict(min_seconds=0.3, max_seconds=1.5, mean_seconds=0.8)


def _stores(n, seed):
    return JSampleStore.synthetic(n=n, seed=seed, **STORE), SampleStore.synthetic(
        n=n, seed=seed, **STORE)


@pytest.fixture(scope="module")
def models():
    """JAX f32 weights (seed 4), their int8 quantization, and the port's
    copies of both."""
    jw = jinit_weights(jax.random.PRNGKey(4), JP)
    xc = np.random.RandomState(9).randn(12, 4, 240).astype(np.float32)
    jq = jquantize_weights(
        jw, jcalibrate(jw, [(jnp.asarray(xc), jnp.full((4,), 12, jnp.int32))], JP), JP)
    port = lambda w, kind: weights_from_numpy_leaves(
        [np.asarray(a) for a in jax.tree.flatten(w)[0]], kind, TP, "cpu")
    return {"f32": (jw, port(jw, "rnnt_weights")),
            "quant": (jq, port(jq, "rnnt_quant_weights"))}


@pytest.mark.parametrize("batch_size,buckets", [(3, (1.0, 1.5)), (8, (0.5, 1.0, 1.5)),
                                                 (96, (1.5,)), (128, (2.0,))])
def test_batch_plan_matches_jax(batch_size, buckets):
    """The same (bucket, rows, tile) plan, power-of-two tail cascade included."""
    js, ts = _stores(40, 5)
    want = jbatch_plan(JQSL(js, JFeaturizerConfig(), wav_buckets_s=buckets), batch_size)
    got = batch_plan(QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=buckets),
                     batch_size)
    assert got == [(S, list(rows), g) for S, rows, g in want]


def test_unpack_matches_jax():
    """The packed int8 readback, lengths > 255 included (high byte)."""
    N, cap = 4, 300
    res = np.random.RandomState(0).randint(-1, 29, size=(N, cap)).astype(np.int8)
    lens = np.array([0, 7, 255, 300], np.int32)
    packed = np.concatenate(
        [res, (lens & 0xFF).astype(np.int8)[:, None], (lens >> 8).astype(np.int8)[:, None]], 1)
    r, l = OfflineRunner._unpack(packed)
    jr, jl = JOfflineRunner._unpack(packed)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(l, lens)
    np.testing.assert_array_equal(l, jl)


def test_device_qsl_stages_int16_as_jax():
    """DeviceQSL on the CPU: the same batches, int16 samples (round half to
    even, clipped), lengths and row indices as the JAX package's."""
    js, ts = _stores(7, 5)
    js.samples[0][:4] = ts.samples[0][:4] = [1.0, -1.5, 0.5 / 32768, 1.5 / 32768]
    jd = JQSL(js, JFeaturizerConfig(), wav_buckets_s=(1.0, 1.5)).load_to_device(batch_size=3)
    td = QuerySampleLibrary(ts, FeaturizerConfig(), wav_buckets_s=(1.0, 1.5)).load_to_device(
        batch_size=3, device="cpu")
    seen = []
    for (jw, jl, jr), (tw, tl, tr) in zip(jd.batches(), td.batches(), strict=True):
        assert tw.dtype == torch.int16
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr, jr)
        seen += [int(i) for i in tr if i >= 0]
    assert sorted(seen) == list(range(7))


@pytest.mark.parametrize("mode", ["f32", "quant"])
def test_run_device_tokens_match_jax(models, mode):
    """run_device over the same DeviceQSL gives the JAX runner's tokens."""
    jw, tw = models[mode]
    js, ts = _stores(7, 6)
    jres = JOfflineRunner(jw, JP, JFeaturizerConfig(), batch_size=4).run_device(
        JQSL(js).load_to_device(4))
    runner = OfflineRunner(tw, TP, batch_size=4, device="cpu")
    tres = runner.run_device(QuerySampleLibrary(ts).load_to_device(4, device="cpu"))
    assert tres.batches == jres.batches
    assert set(tres.phase_seconds) == {"features", "encoder", "decode"}
    for g, w in zip(tres.tokens, jres.tokens, strict=True):
        np.testing.assert_array_equal(g, w)
    assert sum(len(t) for t in tres.tokens) > 0


def test_runner_counts_launches_of_its_timed_pass(models, monkeypatch):
    """OfflineResult.launches / RunReport.launches count the kernel launches
    of the timed loop only, not those of the warm-up or priming pass.  On
    the CPU nothing launches (all zero), so a stand-in for kernel B's
    wrapper counts each decode call as its launch."""
    from rnnt_inference_tpu_torch.models import decoder
    from rnnt_inference_tpu_torch.ops import decode_cuda

    _, tw = models["f32"]
    _, ts = _stores(5, 6)
    runner = OfflineRunner(tw, TP, batch_size=4, device="cpu")
    dqsl = QuerySampleLibrary(ts).load_to_device(4, device="cpu")
    assert runner.run_device(dqsl).launches == {
        "quant_lstm_layer": 0, "lstm_recurrence": 0, "decode_step": 0, "projection": 0,
        "attention": 0, "depthwise": 0, "attention_stream": 0, "depthwise_causal": 0}
    counter = decode_cuda.decode_step_cuda
    monkeypatch.setattr(counter, "launches", 0)
    real = decoder.dc.decode_step

    def counting(*args, **kwargs):
        counter.launches += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(decoder.dc, "decode_step", counting)
    one = runner.run_device(dqsl).launches
    assert one["decode_step"] == counter.launches > 0
    rep = tharness.run_offline(tw, ts, TP, batch_size=4, device_resident=True, device="cpu")
    assert rep.launches == one  # the timed pass alone
    assert counter.launches > 3 * one["decode_step"]  # + warm-up and priming


def test_features_store_run_matches_jax(models):
    """A kind="features" store (precomputed log-mels) through both runners."""
    jw, tw = models["f32"]
    js, _ = _stores(4, 9)
    fn = jax.jit(jlog_mel, static_argnames="cfg")
    feats = []
    for s in js.samples:
        f, fl = fn(jnp.asarray(s[None]), jnp.asarray([s.shape[0]], np.int32), JFeaturizerConfig())
        feats.append(np.asarray(f)[: int(fl[0]), 0, :])
    jres = JOfflineRunner(jw, JP, JFeaturizerConfig(), batch_size=2).run(
        JQSL(JSampleStore(kind="features", samples=feats, transcripts=[""] * 4)))
    tqsl = QuerySampleLibrary(SampleStore(kind="features", samples=feats, transcripts=[""] * 4))
    assert tqsl.feat_buckets == JQSL(js).feat_buckets
    runner = OfflineRunner(tw, TP, batch_size=2, device="cpu")
    runner.warmup(tqsl, waveform_mode=False)
    tres = runner.run(tqsl)
    for g, w in zip(tres.tokens, jres.tokens, strict=True):
        np.testing.assert_array_equal(g, w)


def test_accuracy_run_matches_jax(models, tmp_path):
    """run_offline(accuracy=True): byte-equal accuracy logs, equal WER and
    hypotheses; eval_accuracy_log scores the log as the JAX one does."""
    jw, tw = models["quant"]
    js, ts = _stores(5, 7)
    js.transcripts = ts.transcripts = ["a b c", "d e", "f", "g h", "i"]
    jrep = jharness.run_offline(jw, js, JP, JFeaturizerConfig(), batch_size=2, warmup=False,
                                accuracy=True, output_dir=str(tmp_path / "j"))
    trep = tharness.run_offline(tw, ts, TP, batch_size=2, accuracy=True,
                                output_dir=str(tmp_path / "t"), device="cpu")
    logs = [open(tmp_path / d / "accuracy_log.json").read() for d in "jt"]
    assert logs[0] == logs[1]
    assert trep.hypotheses == jrep.hypotheses and trep.wer == jrep.wer
    assert trep.summary().keys() == jrep.summary().keys()
    path = str(tmp_path / "t" / "accuracy_log.json")
    assert tharness.eval_accuracy_log(path, ts.transcripts) == jharness.eval_accuracy_log(
        path, js.transcripts)
    toks = np.array([1, 2, 3, 27, 0], np.int32)
    assert tharness.tokens_to_hex(toks) == jharness.tokens_to_hex(toks)
    np.testing.assert_array_equal(tharness.hex_to_tokens(tharness.tokens_to_hex(toks)), toks)


def test_single_stream_matches_jax(models):
    jw, tw = models["f32"]
    js, ts = _stores(3, 8)
    jrep = jharness.run_single_stream(jw, js, JP, JFeaturizerConfig(), warmup=False)
    trep = tharness.run_single_stream(tw, ts, TP, device="cpu")
    assert trep.hypotheses == jrep.hypotheses
    assert set(trep.summary()) == set(jrep.summary())


def test_packed_offline_not_ported(models):
    """The packed Offline runner is ported now: run_offline(packed=True)
    gives the JAX packed run's hypotheses; what it still does not serve is
    a features store (neither package packs precomputed features)."""
    jw, tw = models["f32"]
    js, ts = _stores(2, 1)
    jrep = jharness.run_offline(jw, js, JP, JFeaturizerConfig(), batch_size=4, warmup=False,
                                packed=True)
    trep = tharness.run_offline(tw, ts, TP, batch_size=4, packed=True, device="cpu")
    assert trep.hypotheses == jrep.hypotheses
    feats = SampleStore(kind="features", samples=[np.zeros((5, 240), np.float32)],
                        transcripts=[""])
    with pytest.raises(ValueError, match="waveform"):
        tharness.run_offline(tw, feats, TP, packed=True, device="cpu")


@pytest.mark.parametrize("path", ["host", "device_resident", "packed"])
def test_run_offline_min_duration_repeats_reps(models, monkeypatch, path):
    """min_duration_s: timed reps repeat until their walls sum to it (JAX
    harness.py:167-175), on the host-assembled, device-resident and packed
    paths; every rep gives the same tokens (a rep leaves no state behind);
    samples and audio count every rep.  The runner's walls are set to 1 s
    each, so 2.5 s takes exactly three reps."""
    _, tw = models["quant"]
    _, ts = _stores(5, 2)
    cls = PackedOfflineRunner if path == "packed" else OfflineRunner
    name = "run" if path == "host" else "run_device"
    real, reps = getattr(cls, name), []

    def one_second(self, *a, **k):
        r = real(self, *a, **k)
        reps.append(r.tokens)
        return dataclasses.replace(r, wall_seconds=1.0)

    monkeypatch.setattr(cls, name, one_second)
    kw = dict(batch_size=4, device="cpu", warmup=False, device_resident=path != "host",
              packed=path == "packed")
    rep = tharness.run_offline(tw, ts, TP, min_duration_s=2.5, **kw)
    assert rep.extra["reps"] == 3 and rep.extra["rep_wall_seconds"] == [1.0] * 3
    assert rep.samples == 3 * len(ts) and rep.wall_seconds == 3.0
    assert rep.audio_seconds_per_second == pytest.approx(ts.audio_seconds)
    assert len(reps) == 3 and sum(len(t) for t in reps[0]) > 0
    for later in reps[1:]:
        for a, b in zip(later, reps[0], strict=True):
            np.testing.assert_array_equal(a, b)
    assert tharness.run_offline(tw, ts, TP, **kw).hypotheses == rep.hypotheses


def test_run_offline_wav_buckets_match_jax(models, monkeypatch):
    """wav_buckets_s sets the QSL's bucket ladder as in JAX run_offline: the
    runner gets a QSL with the same wav_buckets, and the runs give the same
    batches and hypotheses."""
    jw, tw = models["f32"]
    js, ts = _stores(6, 7)
    seen = {}
    for pkg, cls in (("jax", JOfflineRunner), ("port", OfflineRunner)):
        def run(self, qsl, *a, real=cls.run, pkg=pkg, **k):
            seen[pkg] = qsl.wav_buckets
            return real(self, qsl, *a, **k)

        monkeypatch.setattr(cls, "run", run)
    buckets = (1.5, 0.5, 1.0)
    jrep = jharness.run_offline(jw, js, JP, JFeaturizerConfig(), batch_size=2, warmup=False,
                                wav_buckets_s=buckets)
    trep = tharness.run_offline(tw, ts, TP, batch_size=2, warmup=False, device="cpu",
                                wav_buckets_s=buckets)
    assert seen["port"] == seen["jax"] == (8000, 16000, 24000)
    assert trep.extra["batches"] == jrep.extra["batches"]
    assert trep.hypotheses == jrep.hypotheses


@pytest.mark.parametrize("scenario", ["Offline", "Server", "SingleStream"])
def test_conf_settings_match_jax(scenario, tmp_path):
    """The repo's mlperf.conf / user.conf, and a user.conf with a 0 value,
    read alike; validate_report gives the same verdict."""
    mlperf, user = (os.path.join(REPO, "configs", f) for f in ("mlperf.conf", "user.conf"))
    extra = tmp_path / "u.conf"
    extra.write_text("rnnt.*.min_duration = 0  # comment\n*.Offline.target_qps = 7\nbad line\n")
    for u in (user, str(extra)):
        want = jconfig.TestSettings.from_conf(mlperf, u, "rnnt", scenario)
        got = tconfig.TestSettings.from_conf(mlperf, u, "rnnt", scenario)
        assert vars(got) == vars(want)
        report = {"samples": 5, "wall_seconds": 2.0, "latency_ms_p90": 10.0,
                  "latency_ms_p99": 12.0}
        assert tconfig.validate_report(got, report) == jconfig.validate_report(want, report)


def test_labels_and_wer_match_jax():
    from rnnt_inference_tpu.utils import labels as jlabels

    seq = np.array([8, 5, 12, 12, 15, 0, 27, 1], np.int32)
    assert tlabels.seq_to_sen(seq, 7) == jlabels.seq_to_sen(seq, 7)
    assert tlabels.sen_to_seq("it's ok!") == jlabels.sen_to_seq("it's ok!")
    hyps, refs = ["a b c", "x y", ""], ["a c", "x y z", "q"]
    assert twer.word_error_rate(hyps, refs) == jwer.word_error_rate(hyps, refs)


def test_store_select_filter_and_load_jax_store(tmp_path):
    """A store written by the JAX package loads in the port; select and
    filter_by_list keep the JAX semantics (names matched by basename)."""
    js, _ = _stores(4, 12)
    js.names = ["a/1.wav", "b/2.wav", "c/3.wav", "d/4.wav"]
    js.transcripts = ["w", "x", "y", "z"]
    p = str(tmp_path / "s.npz")
    js.save(p)
    ts = SampleStore.load(p)
    assert (ts.kind, ts.names, ts.transcripts) == (js.kind, js.names, js.transcripts)
    lst = tmp_path / "calib.txt"
    lst.write_text("some-dir/2.wav\n4.wav\n")
    sub, jsub = ts.filter_by_list(str(lst)), js.filter_by_list(str(lst))
    assert (sub.names, sub.transcripts) == (jsub.names, jsub.transcripts) == (
        ["b/2.wav", "d/4.wav"], ["x", "z"])
    np.testing.assert_array_equal(sub.samples[1], js.samples[3])
    assert ts.select([2]).names == ["c/3.wav"]
    with pytest.raises(ValueError):
        SampleStore(kind="waveform", samples=[]).filter_by_list(str(lst))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoints_cross_packages(models, tmp_path, dtype):
    """Weights and calibration written by the port load in the JAX package
    (and back) with the same values, in f32 and bf16."""
    from rnnt_inference_tpu_torch.models.quant import CalibState
    from rnnt_inference_tpu_torch.models.weights import numpy_leaves

    _, tw = models["f32"]
    tw = tw.to(dtype=dtype)
    p = str(tmp_path / "w.npz")
    tckpt.save_weights(p, tw)
    jw = jckpt.load_weights(p, JP)
    for a, b in zip(jax.tree.flatten(jw)[0], numpy_leaves(tw), strict=True):
        np.testing.assert_array_equal(np.asarray(a).view(b.dtype), b)
    jp = str(tmp_path / "jw.npz")
    jckpt.save_weights(jp, jw)
    back = tckpt.load_weights(jp, TP, device="cpu")
    for a, b in zip(numpy_leaves(back), numpy_leaves(tw), strict=True):
        np.testing.assert_array_equal(a, b)

    calib = CalibState(pre_amax=torch.tensor([1.5, 2.0]), post_amax=torch.tensor([3.0, 4.0, 5.0]))
    cp = str(tmp_path / "c.npz")
    tckpt.save_calib(cp, calib)
    jc = jckpt.load_calib(cp)
    np.testing.assert_array_equal(np.asarray(jc.post_amax), [3.0, 4.0, 5.0])
    jckpt.save_calib(cp, jc)
    np.testing.assert_array_equal(tckpt.load_calib(cp, "cpu").pre_amax.numpy(), [1.5, 2.0])
    with pytest.raises(ValueError, match="rnnt_calib"):
        tckpt.load_weights(cp, TP, device="cpu")
