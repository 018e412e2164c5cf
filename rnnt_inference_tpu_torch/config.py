"""Model and featurizer hyper-parameters.

A copy of ``rnnt_inference_tpu/config.py`` (RNNTParams, FeaturizerConfig,
load_featurizer_config):
the port keeps its own copy so that it imports nothing of the JAX package.
Dims mirror the MLPerf RNN-T checkpoint; featurizer params mirror
configs/rnnt.toml [input_eval].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
class ConformerParams:
    """Conformer-Transducer dimensions (NeMo stt_en_conformer_transducer_large:
    examples/asr/conf/conformer/conformer_transducer_bpe.yaml, Large).

    The encoder sees each utterance whole: striding subsampling by 4 (two
    3x3 stride-2 Conv2d of ``conv_channels``, then a Linear to d_model,
    times sqrt(d_model)), then ``num_blocks`` Conformer blocks (half FF,
    relative-position MHSA with per-layer biases u and v, the convolution
    module, half FF, LayerNorm).  The prediction net is an embedding and
    ``pred_num_layers`` LSTM layers; the joint is relu(f W1t + g W1p + b1)
    W2 + b2.  The decoder and runners read the fields they share with
    RNNTParams under the same names.

    The defaults are the full-context Large model.  NeMo's cache-aware
    streaming FastConformer (models/fastconformer.py) sets
    ``subsampling="dw_striding"`` with ``causal_downsampling`` (three
    causal 3x3 stride-2 stages, factor 8), ``att_context_size`` (left,
    right) encoder frames of the chunked-limited attention mask (a chunk of
    right + 1 frames sees its own and left / (right + 1) earlier chunks),
    ``conv_causal`` (the depthwise convolution reads kernel - 1 frames
    back and none ahead) and ``conv_norm="layer_norm"`` after it."""

    n_mels: int = 80
    d_model: int = 512
    num_blocks: int = 17
    n_heads: int = 8
    ff_expansion: int = 4
    conv_kernel_size: int = 31
    conv_channels: int = 512
    subsampling_factor: int = 4
    ln_eps: float = 1e-5
    bn_eps: float = 1e-5
    pred_hidden_size: int = 640
    pred_num_layers: int = 1
    joint_hidden_size: int = 640
    # 1,024 word pieces and blank; blank is the last label and, with a zero
    # embedding, the start symbol (SOS -1 embeds to zeros, as in RNNTParams)
    num_labels: int = 1025
    SOS: int = -1
    BLANK: int = 1024
    max_symbols_per_step: int = 10
    sample_rate: int = 16000
    max_res_len: int = 1024
    subsampling: str = "striding"  # or "dw_striding"
    causal_downsampling: bool = False
    att_context_size: Tuple[int, int] = (-1, -1)  # (-1, -1): full context
    conv_causal: bool = False
    conv_norm: str = "batch_norm"  # or "layer_norm"

    @property
    def streaming(self) -> bool:
        """Whether the attention is chunked-limited (a cache-aware streaming
        model)."""
        return self.att_context_size[0] >= 0

    @property
    def chunk_frames(self) -> int:
        """Encoder frames of a chunk of the chunked-limited mask."""
        return self.att_context_size[1] + 1

    @property
    def left_chunks(self) -> int:
        """Earlier chunks a chunk attends to."""
        return self.att_context_size[0] // self.chunk_frames

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_hidden(self) -> int:
        return self.d_model * self.ff_expansion

    @property
    def sub_stages(self) -> int:
        """Stride-2 convolutions of the subsampling."""
        return {2: 1, 4: 2, 8: 3}[self.subsampling_factor]

    def subsampled_len(self, n):
        """n frames through the stride-2 convolutions (ints, numpy arrays
        and tensors alike; 0 frames give 1 here, so ``encoded_len`` tests
        for them)."""
        f = causal_conv_out_len if self.causal_downsampling else conv_out_len
        for _ in range(self.sub_stages):
            n = f(n)
        return n

    @property
    def sub_freq(self) -> int:
        """Frequency bins after the stride-2 convolutions."""
        return self.subsampled_len(self.n_mels)

    def encoded_len(self, frames: int) -> int:
        """Encoder frames of an utterance of ``frames`` feature frames: each
        stride-2 convolution (kernel 3) takes L to floor((L - 1) / 2) + 1
        with padding 1 on both sides, to floor(L / 2) + 1 with the causal
        padding (2 before, 1 after)."""
        return self.subsampled_len(frames) if frames > 0 else 0


def conv_out_len(n):
    """A 3-wide, stride-2, padding-1 convolution's output length: (n - 1) //
    2 + 1 (for numpy arrays and tensors too)."""
    return (n - 1) // 2 + 1


def causal_conv_out_len(n):
    """A 3-wide, stride-2 convolution's output length with NeMo's causal
    padding (kernel - 1 = 2 before, stride - 1 = 1 after): n // 2 + 1 (for
    numpy arrays and tensors too)."""
    return n // 2 + 1


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
    # added to the mel energies before the log: MLPerf's 1e-20; NeMo's
    # Conformer featurizer adds 2^-24
    log_guard: float = 1e-20
    # whether dither^2 is added to the power spectrum at inference (MLPerf's
    # SUT adds it in place of the training-time noise; NeMo adds nothing)
    dither_at_inference: bool = True

    @property
    def dither_power(self) -> float:
        """What inference adds to every power-spectrum bin: dither^2, or 0."""
        return self.dither ** 2 if self.dither_at_inference and self.dither > 0 else 0.0

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
