"""Model and featurizer hyper-parameters.

A copy of ``rnnt_inference_tpu/config.py`` (RNNTParams, FeaturizerConfig,
load_featurizer_config):
the port keeps its own copy so that it imports nothing of the JAX package.
Dims mirror the MLPerf RNN-T checkpoint; featurizer params mirror
configs/rnnt.toml [input_eval].
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RNNTParams:
    """Transducer model dimensions (MLPerf RNN-T)."""

    # Transcription (encoder)
    trans_input_size: int = 240  # 80 mels x 3 frame splicing
    trans_hidden_size: int = 1024
    pre_num_layers: int = 2
    post_num_layers: int = 3
    stack_time_factor: int = 2
    # Prediction
    pred_hidden_size: int = 320
    pred_num_layers: int = 2
    # Joint
    joint_hidden_size: int = 512
    num_labels: int = 29
    # Alphabet: [SOS, SPACE, a~z, ', BLANK] -> [-1, 0, 1..26, 27, 28]
    SOS: int = -1
    BLANK: int = 28
    max_symbols_per_step: int = 30
    sample_rate: int = 16000
    # Capacity of the per-utterance token buffer; writes beyond it are
    # dropped (the reported length is clamped to it).
    max_res_len: int = 1024


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    """Log-mel frontend parameters (configs/rnnt.toml [input_eval])."""

    sample_rate: int = 16000
    window_size: float = 0.02  # seconds -> 320 samples
    window_stride: float = 0.01  # seconds -> 160 samples
    window: str = "hann"
    normalize: str = "per_feature"
    n_fft: int = 512
    preemph: float = 0.97
    n_mels: int = 80
    lowfreq: float = 0.0
    highfreq: Optional[float] = None  # defaults to sample_rate / 2
    log: bool = True
    dither: float = 1e-5
    frame_splicing: int = 3
    max_duration: float = 16.7
    # STFT boundary padding of n_fft//2 on both sides: "zeros" (the MLPerf
    # SUT's zero-padded preemphasis + stft(center=False)) or "reflect"
    # (stft(center=True) of the training featurizer).
    pad_mode: str = "zeros"

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.window_size)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride)

    @property
    def fmax(self) -> float:
        return self.highfreq if self.highfreq is not None else self.sample_rate / 2

    @property
    def out_feat(self) -> int:
        return self.n_mels * self.frame_splicing

    def num_frames(self, num_samples: int) -> int:
        """STFT frames for a waveform of this length (before splicing)."""
        return num_samples // self.hop_length + 1

    def out_frames(self, num_samples: int) -> int:
        """Frames after x frame_splicing downsampling."""
        return -(-self.num_frames(num_samples) // self.frame_splicing)


def load_featurizer_config(toml_path: str, section: str = "input_eval") -> FeaturizerConfig:
    """A FeaturizerConfig from an rnnt.toml-style file (reference:
    configs/rnnt.toml, models/pytorch_sut.py:25-35)."""
    import tomllib

    with open(toml_path, "rb") as f:
        sec = tomllib.load(f)[section]
    return FeaturizerConfig(
        sample_rate=sec["sample_rate"],
        window_size=sec["window_size"],
        window_stride=sec["window_stride"],
        window=sec["window"],
        normalize=sec["normalize"],
        n_fft=sec["n_fft"],
        n_mels=sec["features"],
        dither=sec["dither"],
        frame_splicing=sec.get("frame_splicing", 1),
        max_duration=sec.get("max_duration", 16.7),
    )
