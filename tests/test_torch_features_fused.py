"""Kernel D's module (ops/features.py log_mel_features_fused, fused_mel and
its plain twin; ops/features_cuda.py) against the JAX package's fused Pallas
featurizer (features_pallas.log_mel_features_pallas, interpret mode), and
the reflect-padding repair of frame_signal against jnp.pad, on the CPU.
The kernel's tf32 arithmetic (tf32_split, its operands in fragment order,
and tools/mel_precision.py's numpy emulation of its products) is held
against the same JAX function.

Tolerances: normalized features within 5e-4 (the bound of
tests/test_features.py:233; f32 DFT/mel sums in another order); lengths
equal; raw log-mels within 1e-4; padding exact; tf32 pieces exact as
stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.ops import features as jf
from rnnt_inference_tpu.ops.features_pallas import _fused_mel, log_mel_features_pallas
from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.ops import features as tf
from rnnt_inference_tpu_torch.ops import features_cuda
from rnnt_inference_tpu_torch.tools.mel_precision import emulate_fused_mel

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
    ops = tf.device_constants(FeaturizerConfig(), "cpu")[3]
    with pytest.raises(ValueError, match="CUDA"):
        features_cuda.log_mel_cuda(torch.zeros(1, 800), 3, ops, 160, 1e-10)


def _mantissa_low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_split_pieces():
    """tf32_split rounds as cvt.rna.tf32.f32 (nearest, ties away from zero)
    to 10 explicit mantissa bits; on cos, sin and fbT, hi and lo keep at
    most 10 explicit bits, hi + lo is within 2**-21 of the constant
    (relative) and hi + lo + lo2 equals it; the kernel's padded filterbank
    rows are zeros."""
    one = 1.0 + 2.0 ** -11  # halfway between two tf32 values
    got = tf.tf32_split(torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0]))[0]
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    cfg = FeaturizerConfig()
    cos_m, sin_m, fbt, ops = tf.device_constants(cfg, "cpu")
    for c in (cos_m, sin_m, fbt):
        hi, lo, lo2 = tf.tf32_split(c, 3)
        assert tf.tf32_split(c)[0].equal(hi) and tf.tf32_split(c)[1].equal(lo)
        for p in (hi, lo, lo2):
            assert not _mantissa_low_bits(p).any()
        c64 = c.double()
        rel = ((hi.double() + lo.double() - c64).abs() / c64.abs().clamp_min(1e-30)).max()
        assert float(rel) <= 2.0 ** -21
        assert torch.equal(hi.double() + lo.double() + lo2.double(), c64)
    K, M = fbt.shape
    kp = ops.fb.shape[0] * 8
    fb_hi = tf.cuda_build.b_fragments_inverse(ops.fb[..., :2].contiguous())
    fb_lo = tf.cuda_build.b_fragments_inverse(ops.fb[..., 2:].contiguous())
    assert kp == 264 and torch.equal(fb_hi[K:], torch.zeros(kp - K, M))
    assert torch.equal(fb_lo[K:], torch.zeros(kp - K, M))
    assert torch.equal(fb_hi[:K].double() + fb_lo[:K].double(),
                       sum(p.double() for p in tf.tf32_split(fbt)))


def test_kernel_operands_in_fragment_order():
    """MelOperands as csrc/mel.cu reads them: for bin tile jb, k-step s,
    cos (c = 0) or sin (c = 1) and lane 4g + t, dft[jb, s, c, lane] holds
    hi and lo of rows 8s + t and 8s + t + 4 of column 8jb + g, the bins
    past K = 257 zeros; dft3 the third pieces of the first bin tiles; fb
    the filterbank likewise; fb_steps the k-steps of each mel tile's
    nonzero rows."""
    cfg = FeaturizerConfig()
    cos_m, sin_m, fbt, ops = tf.device_constants(cfg, "cpu")
    K, M = fbt.shape
    assert ops.dft.shape == (33, 40, 2, 32, 4) and ops.dft3.shape == (2, 40, 32, 4)
    assert (ops.n_bins, ops.n_mels) == (K, M)
    pieces = [tf.tf32_split(torch.nn.functional.pad(c, (0, 7)), 3) for c in (cos_m, sin_m)]
    assert not ops.dft[32].reshape(40, 2, 8, 4, 4)[:, :, 1:].any()  # bins 257-263: zeros
    rng = np.random.RandomState(0)
    for jb, s, lane in zip(rng.randint(0, 33, 40), rng.randint(0, 40, 40), rng.randint(0, 32, 40)):
        g, t = divmod(int(lane), 4)
        rows, col = [8 * s + t, 8 * s + t + 4], 8 * jb + g
        for c in range(2):
            hi, lo, lo2 = pieces[c]
            want = [hi[rows[0], col], hi[rows[1], col], lo[rows[0], col], lo[rows[1], col]]
            assert ops.dft[jb, s, c, lane].tolist() == [float(v) for v in want]
            if jb < 2:
                assert ops.dft3[jb, s, lane, 2 * c:2 * c + 2].tolist() == [
                    float(lo2[rows[0], col]), float(lo2[rows[1], col])]
        fhi, flo = tf.tf32_split(fbt)
        ks, j = int(rng.randint(0, 32)), int(rng.randint(0, 10))  # rows 0-255 of fbT
        frow, fcol = [8 * ks + t, 8 * ks + t + 4], 8 * j + g
        assert ops.fb[ks, j, lane].tolist() == [
            float(fhi[frow[0], fcol]), float(fhi[frow[1], fcol]),
            float(flo[frow[0], fcol]), float(flo[frow[1], fcol])]
    for j, (lo, hi) in enumerate(ops.fb_steps.tolist()):
        rows = torch.nonzero(fbt[:, 8 * j:8 * j + 8].ne(0).any(dim=1)).flatten()
        assert (lo, hi) == (int(rows.min()) // 8, int(rows.max()) // 8 + 1)


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX fused featurizer on _inputs(), interpret mode: (the padded,
    preemphasized waveform x, its raw log-mel, the normalized features and
    lengths)."""
    wav, lens = _inputs()
    cfg = JFeaturizerConfig()
    x = jf.preemphasis(jnp.asarray(wav), jnp.asarray(lens), cfg.preemph)
    x = jnp.pad(x, ((0, 0), (cfg.n_fft // 2, cfg.n_fft // 2)))[:, jf._frontend_constants(cfg)[3][0]:]
    T = wav.shape[1] // cfg.hop_length + 1
    raw = _fused_mel(x, T, cfg, interpret=True)
    feats, flens = jax.jit(lambda a, b: log_mel_features_pallas(a, b, cfg, interpret=True))(
        jnp.asarray(wav), jnp.asarray(lens))
    return np.asarray(x), np.asarray(raw), np.asarray(feats), np.asarray(flens)


@pytest.mark.parametrize("pieces, within", [("kernel", True), ("1x", False)])
def test_tf32_emulation_against_jax_pallas(jax_fused, pieces, within):
    """The kernel's 3xTF32 products (numpy emulation) give the JAX fused
    featurizer's raw log-mel within 1e-4 and its normalized features within
    5e-4, the bounds of test_fused_twin_matches_jax_pallas.  Plain tf32
    (the leading piece alone) misses both: the log magnifies its error in
    low-power bins, as with bf16 (tests/test_features.py
    test_bf16_feature_matmuls); that is why the kernel splits."""
    x, raw, feats, flens = jax_fused
    cfg = FeaturizerConfig()
    got = emulate_fused_mel(x, raw.shape[1], cfg, pieces)
    raw_diff = float(np.abs(got - raw).max())
    _, lens = _inputs()
    f, fl = tf._finish(torch.from_numpy(got), torch.from_numpy(lens).long() // cfg.hop_length + 1,
                       cfg)
    np.testing.assert_array_equal(fl.numpy(), flens)
    feat_diff = float(np.abs(f.numpy() - feats).max())
    if within:
        assert raw_diff <= 1e-4 and feat_diff <= 5e-4, (raw_diff, feat_diff)
    else:
        assert raw_diff > 1e-4 and feat_diff > 5e-4, (raw_diff, feat_diff)


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


def test_kernel_phase_probes_match_mel_source():
    """tools/kernel_phases.py finds each of its kernel-D anchors exactly once
    in csrc/mel.cu, and its edits only add stamp lines (or a prefix): the
    profiled kernel is the real one."""
    from rnnt_inference_tpu_torch.ops import cuda_build
    from rnnt_inference_tpu_torch.tools import kernel_phases as kp

    probe = ("DPROF_BEGIN", "DPROF_END", "DMARK(", "DSTART", "DADD(")
    patched = kp._patch((cuda_build.CSRC / "mel.cu").read_text(), kp.MEL)
    assert patched.count("DMARK(") >= 3 and patched.count("DADD(") >= 4
    for anchor, stamped in kp.MEL:
        kept = [l for l in stamped.split("\n") if not any(w in l for w in probe)]
        assert stamped.endswith(anchor) or kept == anchor.split("\n"), anchor

