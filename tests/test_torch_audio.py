"""The port's copy of data/audio.py against the JAX package's on the
inputs of tests/test_audio.py: segment ops, speed perturbation, wav
loading and resampling.

Tolerance: outputs equal (bit for bit).
"""

import wave

import numpy as np
import pytest

from rnnt_inference_tpu.data import audio as jaudio
from rnnt_inference_tpu_torch.data import audio as taudio

SR = 16000


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _trim_inputs():
    rng = np.random.RandomState(0)
    quiet = rng.randn(SR).astype(np.float32) * 1e-5
    loud = rng.randn(SR).astype(np.float32) * 0.5
    return {
        "quiet_loud_quiet": np.concatenate([quiet, loud, quiet]),
        "all_loud": np.random.RandomState(1).randn(8000).astype(np.float32) * 0.3,
        "empty": np.zeros(0, np.float32),
        "flat_silent": np.full(4096, 1e-6, np.float32),
    }


@pytest.mark.parametrize("case", sorted(_trim_inputs()))
@pytest.mark.parametrize("top_db", [60.0, 20.0])
def test_trim_silence_matches_jax(case, top_db):
    x = _trim_inputs()[case]
    _same(taudio.trim_silence(x, top_db=top_db), jaudio.trim_silence(x, top_db=top_db))


def test_pad_and_subsegment_match_jax():
    x = np.ones(10, np.float32)
    for sym in (False, True):
        _same(taudio.pad(x, 5, symmetric=sym), jaudio.pad(x, 5, symmetric=sym))
    y = np.arange(500, dtype=np.float32)
    for t0, t1 in [(1.0, 3.0), (-2.0, -1.0), (None, None), (0.25, None)]:
        _same(taudio.subsegment(y, 100, t0, t1), jaudio.subsegment(y, 100, t0, t1))
    for t0, t1 in [(0.5, 6.0), (0.8, 0.2)]:
        with pytest.raises(ValueError):
            taudio.subsegment(y[:100], 100, t0, t1)


def test_gain_and_rms_db_match_jax():
    x = np.random.RandomState(2).randn(16000).astype(np.float32) * 0.1
    for g in (-3.0, 0.0, 6.0):
        _same(taudio.gain_db(x, g), jaudio.gain_db(x, g))
    assert taudio.rms_db(x) == jaudio.rms_db(x)


@pytest.mark.parametrize("factor", [0.9, 1.0, 1.1, 0.95])
def test_speed_perturb_matches_jax(factor):
    x = np.random.RandomState(3).randn(12345).astype(np.float32) * 0.2
    _same(taudio.speed_perturb(x, factor), jaudio.speed_perturb(x, factor))


def _write_wav(path, raw: bytes, width: int, channels: int, sr: int):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


@pytest.mark.parametrize("width,channels,sr", [(2, 1, 16000), (1, 1, 16000), (4, 1, 16000),
                                               (2, 2, 16000), (2, 1, 8000), (2, 1, 22050)])
def test_load_wav_and_load_audio_match_jax(tmp_path, width, channels, sr):
    """load_wav of 8-, 16- and 32-bit PCM, mono and stereo, and load_audio's
    polyphase resampling to 16 kHz."""
    rng = np.random.RandomState(width * 10 + channels)
    n = 3001 * channels
    dt = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(dt))
    raw = rng.randint(info.min, int(info.max) + 1, size=n, dtype=np.int64).astype(dt).tobytes()
    p = tmp_path / "a.wav"
    _write_wav(p, raw, width, channels, sr)
    x, got_sr = taudio.load_wav(str(p))
    y, want_sr = jaudio.load_wav(str(p))
    assert got_sr == want_sr == sr
    _same(x, y)
    _same(taudio.load_audio(str(p)), jaudio.load_audio(str(p)))
