"""Kernel D's module (ops/features.py log_mel_features_fused, fused_mel and
its plain twin; ops/features_cuda.py) against the JAX package's fused Pallas
featurizer (features_pallas.log_mel_features_pallas, interpret mode), and
the reflect-padding repair of frame_signal against jnp.pad, on the CPU.

Tolerances: normalized features within 5e-4 (the bound of
tests/test_features.py:233; f32 DFT/mel sums in another order); lengths
equal; raw log-mels within 1e-4; padding exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.ops import features as jf
from rnnt_inference_tpu.ops.features_pallas import log_mel_features_pallas
from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.ops import features as tf
from rnnt_inference_tpu_torch.ops import features_cuda

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def _inputs():
    """The inputs of tests/test_features.py:224-226."""
    rng = np.random.RandomState(0)
    wav = rng.randn(8, 24000).astype(np.float32) * 0.1
    lens = np.array([24000] * 4 + [17000, 9000, 5000, 24000], np.int32)
    return wav, lens


@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
def test_fused_twin_matches_jax_pallas(pad_mode):
    wav, lens = _inputs()
    want, want_lens = jax.jit(
        lambda x, l: log_mel_features_pallas(x, l, JFeaturizerConfig(pad_mode=pad_mode),
                                             interpret=True)
    )(jnp.asarray(wav), jnp.asarray(lens))
    got, got_lens = tf.log_mel_features_fused(
        torch.from_numpy(wav), torch.from_numpy(lens), FeaturizerConfig(pad_mode=pad_mode))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-4


def test_fused_twin_matches_plain_frontend():
    """The fused twin and log_mel_features compute the same function."""
    wav, lens = _inputs()
    a, la = tf.log_mel_features_fused(torch.from_numpy(wav), torch.from_numpy(lens))
    b, lb = tf.log_mel_features(torch.from_numpy(wav), torch.from_numpy(lens))
    assert torch.equal(la, lb)
    assert float((a - b).abs().max()) < 5e-4


def test_fused_mel_twin_frames():
    """fused_mel_reference reads frame t at x[t*hop : t*hop + 2*hop], zeros
    past the end: the raw log-mel of a frame against numpy."""
    cfg = FeaturizerConfig()
    x = np.random.RandomState(5).randn(2, 1000).astype(np.float32)
    got = tf.fused_mel(torch.from_numpy(x), 6, cfg).numpy()
    cos_m, sin_m, fb, _ = tf._frontend_constants(cfg)
    for t in (0, 3, 5):
        frame = np.zeros(320, np.float64)
        seg = x[1, t * 160 : t * 160 + 320]
        frame[: seg.shape[0]] = seg
        spec = (frame @ cos_m) ** 2 + (frame @ sin_m) ** 2 + cfg.dither ** 2
        np.testing.assert_allclose(got[1, t], np.log(spec @ fb.T + 1e-20), atol=1e-4)


def test_fused_needs_window_of_two_hops():
    with pytest.raises(ValueError, match="2\\*hop"):
        tf.log_mel_features_fused(torch.zeros(1, 4000), torch.tensor([4000]),
                                  FeaturizerConfig(window_size=0.025))
    with pytest.raises(ValueError, match="impl"):
        tf.fused_mel(torch.zeros(1, 4000), 3, FeaturizerConfig(), impl="pallas")


def test_kernel_wrapper_refuses_cpu_tensors():
    cos_m, sin_m, fbt = tf.device_constants(FeaturizerConfig(), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        features_cuda.log_mel_cuda(torch.zeros(1, 800), 3, cos_m, sin_m, fbt, 160, 1e-10)


@pytest.mark.parametrize("S", [1, 2, 5, 100, 256, 257, 700])
@pytest.mark.parametrize("pad", [1, 256])
def test_reflect_pad_matches_jnp_pad(S, pad):
    """pad_both(..., "reflect") is jnp.pad(mode="reflect") at any length,
    including S <= pad where the reflection repeats."""
    x = np.random.RandomState(S).randn(2, S).astype(np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (pad, pad)), mode="reflect"))
    np.testing.assert_array_equal(tf.pad_both(torch.from_numpy(x), pad, "reflect").numpy(), want)


@pytest.mark.parametrize("S", [100, 256, 257])
@pytest.mark.parametrize("normalize", ["per_feature", "none"])
def test_short_waveforms_reflect_match_jax(S, normalize):
    """log_mel_features and the fused path under pad_mode="reflect" at
    waveforms of n_fft/2 samples or fewer, against the JAX log_mel_features
    (raw log-mels with normalize="none", splicing 1)."""
    kw = dict(pad_mode="reflect", normalize=normalize)
    if normalize == "none":
        kw["frame_splicing"] = 1
    rng = np.random.RandomState(S)
    x = (rng.randn(2, S) * 0.1).astype(np.float32)
    lens = np.array([S, S - 40], np.int32)
    want, want_lens = jax.jit(jf.log_mel_features, static_argnames="cfg")(
        jnp.asarray(x), jnp.asarray(lens), JFeaturizerConfig(**kw))
    for fn in (tf.log_mel_features, tf.log_mel_features_fused):
        got, got_lens = fn(torch.from_numpy(x), torch.from_numpy(lens), FeaturizerConfig(**kw))
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
