"""The port's LibriSpeech conversion chain against the JAX package's, on the
CPU: convert_librispeech on wav and FLAC corpora that the tests write
themselves (with a file list, speed perturbation and worker processes),
SampleStore.from_manifest, compute_features_store,
tools/convert_librispeech.py's directory scan and load_featurizer_config.

Tolerance: stores equal sample for sample; features as the featurizers
themselves differ (test_compute_features_store_matches_jax); configs
equal.
"""

import dataclasses
import importlib.util
import json
import os
import wave

import numpy as np
import pytest

from rnnt_inference_tpu.config import load_featurizer_config as jload_featurizer_config
from rnnt_inference_tpu.data import dataset as jdataset
from rnnt_inference_tpu.data.flac import encode_flac as jencode_flac
from rnnt_inference_tpu_torch.config import load_featurizer_config
from rnnt_inference_tpu_torch.data import dataset as tdataset
from rnnt_inference_tpu_torch.data.flac import encode_flac, load_flac
from rnnt_inference_tpu_torch.tools import convert_librispeech as tconvert

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, pcm):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four utterances of 0.5-1.25 s, each as .wav and as .flac (the
    port's encoder), with a manifest for each, in a LibriSpeech layout
    (speaker/chapter/, a .trans.txt)."""
    root = tmp_path_factory.mktemp("corpus")
    chap = root / "19" / "198"
    chap.mkdir(parents=True)
    rng = np.random.RandomState(1)
    entries, trans = [], []
    for i in range(4):
        dur = 0.5 + 0.25 * i
        x = (rng.randn(int(SR * dur)) * 0.1).astype(np.float32)
        pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int32)
        utt = f"19-198-{i:04d}"
        _write_wav(chap / f"{utt}.wav", pcm)
        (chap / f"{utt}.flac").write_bytes(encode_flac(pcm, SR))
        entries.append(dict(audio_filepath=f"19/198/{utt}.flac", duration=dur,
                            transcript=f"utterance number {i}"))
        trans.append(f"{utt} UTTERANCE NUMBER {i}")
    (chap / "19-198.trans.txt").write_text("\n".join(trans) + "\n")
    (root / "man_flac.json").write_text(json.dumps(entries))
    (root / "man_wav.json").write_text(json.dumps(
        [dict(e, audio_filepath=e["audio_filepath"].replace(".flac", ".wav")) for e in entries]))
    (root / "calib.txt").write_text("x/19-198-0001.flac\n19-198-0002-0.9.wav\n19-198-0003.wav\n")
    return root


def _assert_stores_equal(got, want):
    assert got.kind == want.kind and len(got) == len(want)
    assert got.names == want.names and got.transcripts == want.transcripts
    for a, b in zip(got.samples, want.samples):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_flac_encoder_writes_the_jax_bytes(corpus):
    for f in sorted((corpus / "19" / "198").glob("*.flac")):
        pcm = np.round(load_flac(str(f))[0] * 32768.0).astype(np.int32)
        assert f.read_bytes() == jencode_flac(pcm, SR)


@pytest.mark.parametrize("ext,file_list,speeds,workers", [
    ("wav", False, None, 0),
    ("flac", False, None, 0),
    ("flac", False, None, 2),
    ("wav", True, None, 0),
    ("wav", False, [0.9, 1.1], 0),
    ("wav", True, [0.9, 1.1], 0),
])
def test_convert_librispeech_matches_jax(corpus, tmp_path, ext, file_list, speeds, workers):
    """The port's store equals the JAX package's sample for sample; the
    npz it writes loads in the JAX package; FLAC samples equal wav ones."""
    kw = dict(file_list=str(corpus / "calib.txt") if file_list else None, speeds=speeds)
    out = tmp_path / "store.npz"
    got = tdataset.convert_librispeech(str(corpus), str(corpus / f"man_{ext}.json"), str(out),
                                       workers=workers, **kw)
    want = jdataset.convert_librispeech(str(corpus), str(corpus / f"man_{ext}.json"), "", **kw)
    _assert_stores_equal(got, want)
    _assert_stores_equal(jdataset.SampleStore.load(str(out)), want)
    if ext == "flac":
        wav = tdataset.convert_librispeech(str(corpus), str(corpus / "man_wav.json"), "")
        for a, b in zip(got.samples, wav.samples):
            np.testing.assert_array_equal(a, b)


def test_from_manifest_matches_jax(corpus):
    from rnnt_inference_tpu.data.manifest import Manifest as JManifest
    from rnnt_inference_tpu_torch.data.manifest import Manifest

    for ext in ("wav", "flac"):
        path = [str(corpus / f"man_{ext}.json")]
        got = tdataset.SampleStore.from_manifest(Manifest(path, data_dir=str(corpus)))
        want = jdataset.SampleStore.from_manifest(JManifest(path, data_dir=str(corpus)))
        _assert_stores_equal(got, want)


def test_compute_features_store_matches_jax(corpus):
    """Features of every utterance, batched over the wav buckets and trimmed
    to each utterance's frames.  The chain adds nothing to the featurizers'
    own difference: the port's store equals the port's log_mel_features of
    each utterance alone within 1e-6, the JAX store its own within 1e-5,
    and the two stores differ, element by element, by at most the two
    featurizers' difference on the utterance alone plus 1e-5.  That
    difference (f32 DFT products summed in another order) stays within
    test_log_mel_features_match_jax's 1e-4 except in one element of this
    corpus: 1.28e-4 in the lowest mel band of a white-noise utterance,
    where preemphasis leaves little power and the log magnifies the DFT's
    relative error (ROADMAP.md section 3)."""
    import jax
    import jax.numpy as jnp
    import torch

    from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
    from rnnt_inference_tpu.ops.features import log_mel_features as jlog_mel
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    store = tdataset.convert_librispeech(str(corpus), str(corpus / "man_wav.json"), "",
                                         speeds=[0.9])
    got = tdataset.compute_features_store(store, batch_size=4, device="cpu")
    jstore = jdataset.SampleStore(kind="waveform", samples=store.samples,
                                  transcripts=store.transcripts, names=store.names)
    want = jdataset.compute_features_store(jstore, batch_size=4)
    assert got.kind == want.kind == "features" and got.names == want.names
    assert got.transcripts == want.transcripts
    jfeat = jax.jit(jlog_mel, static_argnames="cfg")
    gaps = []
    for s, a, b in zip(store.samples, got.samples, want.samples):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        lens = np.array([len(s)], np.int32)
        alone = log_mel_features(torch.from_numpy(s[None]), torch.from_numpy(lens))[0][:, 0]
        jalone = np.asarray(jfeat(jnp.asarray(s[None]), jnp.asarray(lens),
                                  JFeaturizerConfig())[0])[:, 0]
        np.testing.assert_allclose(a, alone.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(b, jalone, atol=1e-5, rtol=0)
        assert np.all(np.abs(a - b) <= np.abs(alone.numpy() - jalone) + 1e-5)
        gaps.append(float(np.abs(a - b).max()))
    assert max(gaps) < 2e-4 and sorted(gaps)[-2] < 1e-4
    with pytest.raises(ValueError):
        tdataset.compute_features_store(got, device="cpu")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_script", os.path.join(REPO, "scripts", "convert_librispeech.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_tool_scans_a_librispeech_dir(corpus, tmp_path):
    """tools/convert_librispeech.py --input_dir --features --device cpu:
    the scanned manifest equals scripts/convert_librispeech.py's, and the
    waveform and features stores load and match the library calls."""
    want_man = tmp_path / "jax.manifest.json"
    _jax_script().build_manifest_from_dir(str(corpus), str(want_man))
    out = tmp_path / "dev.npz"
    assert tconvert.main(["--input_dir", str(corpus), "--output", str(out), "--features",
                          "--device", "cpu"]) == 0
    got_man = json.loads((tmp_path / "dev.manifest.json").read_text())
    assert got_man == json.loads(want_man.read_text()) and len(got_man) == 4
    store = tdataset.SampleStore.load(str(out))
    _assert_stores_equal(store, jdataset.convert_librispeech(str(corpus), str(want_man), ""))
    feats = tdataset.SampleStore.load(str(tmp_path / "dev-input.npz"))
    assert feats.kind == "features" and feats.names == store.names
    assert [f.shape[0] for f in feats.samples] == list(store.feature_lengths())


def test_load_featurizer_config_matches_jax(tmp_path):
    toml = tmp_path / "rnnt.toml"
    toml.write_text(
        "[input_eval]\nsample_rate = 16000\nwindow_size = 0.02\nwindow_stride = 0.01\n"
        'window = "hann"\nnormalize = "per_feature"\nn_fft = 512\nfeatures = 80\n'
        "dither = 0.00001\nframe_splicing = 3\n"
        "[input_other]\nsample_rate = 8000\nwindow_size = 0.025\nwindow_stride = 0.0125\n"
        'window = "hann"\nnormalize = "none"\nn_fft = 256\nfeatures = 64\ndither = 0.0\n'
        "max_duration = 10.0\n")
    for section in ("input_eval", "input_other"):
        got = load_featurizer_config(str(toml), section)
        want = jload_featurizer_config(str(toml), section)
        shared = [f.name for f in dataclasses.fields(want)]
        assert {k: v for k, v in dataclasses.asdict(got).items() if k in shared} == \
            {k: getattr(want, k) for k in shared}
        # the port's own fields hold what the JAX featurizer hard-codes
        assert set(dataclasses.asdict(got)) - set(shared) == {"log_guard", "dither_at_inference"}
        assert got.log_guard == 1e-20 and got.dither_at_inference is True
    assert load_featurizer_config(str(toml)).out_feat == 240
