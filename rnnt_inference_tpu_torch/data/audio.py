"""Waveform loading and segment operations, numpy and scipy only (the
port's copy of rnnt_inference_tpu/data/audio.py).

WAV through the standard library's ``wave``; FLAC through the pure-Python
codec in data/flac.py (the reference decodes LibriSpeech's FLAC through
sox, datasets/process_librispeech.py:31-97).
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM wav file -> (float32 samples in [-1, 1], sample_rate).

    Mirrors the int->float scaling of the reference's AudioSegment
    (reference: datasets/parts/segment.py:29-60).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


# ---------------------------------------------------------------------------
# Segment ops (functional analog of the reference's AudioSegment,
# datasets/parts/segment.py:20-186: trim, pad, subsegment, gain)
# ---------------------------------------------------------------------------


def trim_silence(
    x: np.ndarray,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> np.ndarray:
    """Strip leading/trailing silence: frames whose RMS is more than top_db
    below the loudest frame are silent (the librosa.effects.trim contract the
    reference's AudioSegment(trim=True) uses, segment.py:36-38).
    """
    if x.size == 0:
        return x
    n_frames = 1 + max(len(x) - frame_length, 0) // hop_length
    power = np.empty(n_frames, np.float64)
    for i in range(n_frames):
        fr = x[i * hop_length : i * hop_length + frame_length]
        power[i] = np.mean(fr.astype(np.float64) ** 2) if fr.size else 0.0
    rms_db = 10.0 * np.log10(np.maximum(power, 1e-20))
    keep = np.flatnonzero(rms_db > rms_db.max() - top_db)
    if keep.size == 0:
        return x[:0]
    start = keep[0] * hop_length
    end = min(len(x), keep[-1] * hop_length + frame_length)
    return x[start:end]


def pad(x: np.ndarray, pad_size: int, symmetric: bool = False) -> np.ndarray:
    """Zero-pad the end (or both ends when symmetric), in samples
    (reference: segment.py pad)."""
    return np.pad(x, (pad_size if symmetric else 0, pad_size))


def subsegment(
    x: np.ndarray,
    sample_rate: int,
    start_time: float = None,
    end_time: float = None,
) -> np.ndarray:
    """Cut [start_time, end_time) seconds; negative times count from the end
    (reference: segment.py subsegment)."""
    duration = len(x) / float(sample_rate)
    start_time = 0.0 if start_time is None else start_time
    end_time = duration if end_time is None else end_time
    if start_time < 0.0:
        start_time = duration + start_time
    if end_time < 0.0:
        end_time = duration + end_time
    if not 0.0 <= start_time <= end_time <= duration:
        raise ValueError(
            f"invalid subsegment [{start_time}, {end_time}] for a "
            f"{duration:.3f}s segment"
        )
    return x[int(round(start_time * sample_rate)) : int(round(end_time * sample_rate))]


def gain_db(x: np.ndarray, gain: float) -> np.ndarray:
    """Apply gain in dB (reference: segment.py gain_db)."""
    return (x * 10.0 ** (gain / 20.0)).astype(x.dtype)


def rms_db(x: np.ndarray) -> float:
    """Segment loudness in dB (reference: segment.py rms_db)."""
    return float(10.0 * np.log10(np.mean(x.astype(np.float64) ** 2)))


def speed_perturb(x: np.ndarray, factor: float) -> np.ndarray:
    """Speed perturbation: play the segment back `factor`x faster, so the
    output has ~len(x)/factor samples at the same nominal sample rate
    (the sox Transformer().speed(factor) op the reference's converter uses
    for calibration augmentation, datasets/process_librispeech.py:51-68).

    Implemented as polyphase resampling with a rational approximation of
    1/factor (sox's speed is also a rational-rate resample under the hood);
    pitch shifts along with tempo, matching sox `speed` (not `tempo`).
    """
    from fractions import Fraction

    from scipy.signal import resample_poly

    if factor == 1.0:
        return x
    frac = Fraction(factor).limit_denominator(1000)
    # output/input ratio is 1/factor -> up=denominator, down=numerator
    return resample_poly(x, frac.denominator, frac.numerator).astype(np.float32)


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """Load audio, resampling if needed (polyphase via scipy)."""
    if path.endswith(".flac"):
        from rnnt_inference_tpu_torch.data.flac import load_flac

        x, sr = load_flac(path)
    else:
        x, sr = load_wav(path)
    if sr != target_sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g).astype(np.float32)
    return x
