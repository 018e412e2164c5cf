"""PyTorch port vs the JAX package: activations, float LSTM, stack_time,
log-mel features, and the port's import isolation.

Inputs come from numpy seeds and go through both packages on the CPU.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import FeaturizerConfig as JFeaturizerConfig
from rnnt_inference_tpu.models.weights import LSTMLayerWeights as JLayer
from rnnt_inference_tpu.ops import activations as ja
from rnnt_inference_tpu.ops import features as jf
from rnnt_inference_tpu.ops import lstm as jl
from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights
from rnnt_inference_tpu_torch.ops import activations as ta
from rnnt_inference_tpu_torch.ops import features as tf
from rnnt_inference_tpu_torch.ops import lstm as tl

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("impl", ["exact", "approx"])
def test_gate_fns_match_jax(impl):
    """Tolerance 1e-6: f32 transcendentals of two libraries."""
    x = (np.random.RandomState(0).randn(4096) * 6).astype(np.float32)
    try:
        ja.set_gate_act(impl)
        ta.set_gate_act(impl)
        (js, jt), (ts, tt) = ja.gate_fns(), ta.gate_fns()
        for jfn, tfn in ((js, ts), (jt, tt)):
            np.testing.assert_allclose(
                tfn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))), atol=1e-6
            )
    finally:
        ja.set_gate_act("exact")
        ta.set_gate_act("exact")


def _layers(rng, sizes, H):
    """Random f32 layers as (jax, torch) pairs, same values."""
    out = []
    for ic in sizes:
        k = 1.0 / np.sqrt(H)
        a = [rng.uniform(-k, k, s).astype(np.float32) for s in ((ic, 4 * H), (H, 4 * H), (4 * H,))]
        out.append((JLayer(*map(jnp.asarray, a)), LSTMLayerWeights(*map(torch.from_numpy, a))))
    return out


def test_lstm_layer_matches_jax():
    """f32 scan, atol 1e-5 (summation order of f32 matmuls)."""
    rng = np.random.RandomState(1)
    T, N, IC, H = 7, 5, 24, 16
    (jlay, tlay), = _layers(rng, [IC], H)
    x = rng.randn(T, N, IC).astype(np.float32)
    h0 = rng.randn(N, H).astype(np.float32) * 0.5
    c0 = rng.randn(N, H).astype(np.float32) * 0.5
    want = jl.lstm_layer(jlay, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
    got = tl.lstm_layer(tlay, *map(torch.from_numpy, (x, h0, c0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_lstm_stack_and_single_step_match_jax():
    """Two-layer stack over a chunk and one single step, atol 1e-5."""
    rng = np.random.RandomState(2)
    T, N, IC, H = 5, 4, 12, 16
    pairs = _layers(rng, [IC, H], H)
    jls, tls = [p[0] for p in pairs], [p[1] for p in pairs]
    x = rng.randn(T, N, IC).astype(np.float32)
    hs = rng.randn(2, N, H).astype(np.float32) * 0.3
    cs = rng.randn(2, N, H).astype(np.float32) * 0.3
    want = jl.lstm_stack(jls, jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs))
    got = tl.lstm_stack(tls, *map(torch.from_numpy, (x, hs, cs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    want = jl.lstm_single_step(jls, jnp.asarray(x[0]), jnp.asarray(hs), jnp.asarray(cs))
    got = tl.lstm_single_step(tls, *map(torch.from_numpy, (x[0], hs, cs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("factor", [2, 3])
def test_stack_time_matches_jax(factor):
    """Pure data movement: exact, for f32 and int8 inputs."""
    rng = np.random.RandomState(3)
    x = rng.randn(7, 4, 6).astype(np.float32)
    lens = np.array([7, 5, 2, 0], np.int32)
    for arr in (x, (x * 40).astype(np.int8)):
        want = np.asarray(jl.stack_time(jnp.asarray(arr), jnp.asarray(lens), factor))
        got = tl.stack_time(torch.from_numpy(arr), torch.from_numpy(lens), factor).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
def test_log_mel_features_match_jax(pad_mode):
    """Normalised features within atol 1e-4 (f32 DFT/mel matmuls summed in
    another order); lengths equal."""
    rng = np.random.RandomState(4)
    S = 16000
    x = (rng.randn(3, S) * 0.1).astype(np.float32)
    lens = np.array([S, S - 4000, S // 2 + 77], np.int32)
    want, want_lens = jax.jit(jf.log_mel_features, static_argnames="cfg")(
        jnp.asarray(x), jnp.asarray(lens), JFeaturizerConfig(pad_mode=pad_mode)
    )
    got, got_lens = tf.log_mel_features(
        torch.from_numpy(x), torch.from_numpy(lens), FeaturizerConfig(pad_mode=pad_mode)
    )
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _preemphasis_pairs():
    """(waveforms, lengths) of the golden store's utterances, each alone,
    and of 40 random batches of 100-700 samples (numpy seed 0)."""
    from rnnt_inference_tpu.data.dataset import SampleStore as JSampleStore
    from rnnt_inference_tpu.utils import golden as jgolden

    store = JSampleStore.synthetic(n=jgolden.N_SAMPLES, seed=jgolden.SEED_STORE, min_seconds=0.4,
                                   max_seconds=2.0, mean_seconds=1.0)
    for s in store.samples:
        yield s[None], np.array([len(s)], np.int32)
    rng = np.random.RandomState(0)
    for _ in range(40):
        S = rng.randint(100, 701)
        x = (rng.randn(3, S) * rng.choice([0.01, 0.1, 1.0])).astype(np.float32)
        yield x, rng.randint(1, S + 1, 3).astype(np.int32)


def test_preemphasis_is_bit_equal_to_jax():
    """Preemphasis rounds once, as XLA fuses the JAX function inside the
    jitted featurizer: bit-equal on the golden store and on random lengths
    of 100-700 samples.  (The eager two-rounding form differs from it in
    the last bit of some samples.)"""
    jpre = jax.jit(jf.preemphasis)
    for x, lens in _preemphasis_pairs():
        want = np.asarray(jpre(jnp.asarray(x), jnp.asarray(lens)))
        got = tf.preemphasis(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
        np.testing.assert_array_equal(got, want)


def test_frontend_constants_match_jax():
    """The numpy-built DFT, window and mel constants are the same arrays."""
    got = tf._frontend_constants(FeaturizerConfig())
    want = jf._frontend_constants(JFeaturizerConfig())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_port_imports_no_jax():
    """Importing every module of the port, the bench, the profiler, the
    native loadgen's bindings, the text, manifest, audio and FLAC modules,
    the mesh, distributed and tensor-parallel modules, the Transcriber, the golden module
    and the tools (the entry scripts' counterparts eval_accuracy, check_calib,
    server_probe and run_stages among them) included, loads no jax and
    nothing of the JAX package (a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rnnt_inference_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rnnt_inference_tpu'))\n"
        "assert not bad, bad\n"
        "assert {'rnnt_inference_tpu_torch.bench', 'rnnt_inference_tpu_torch.utils.profiler', "
        "'rnnt_inference_tpu_torch.runtime.native', 'rnnt_inference_tpu_torch.data.text', "
        "'rnnt_inference_tpu_torch.data.manifest', 'rnnt_inference_tpu_torch.data.audio', "
        "'rnnt_inference_tpu_torch.data.flac', 'rnnt_inference_tpu_torch.parallel.mesh', "
        "'rnnt_inference_tpu_torch.parallel.distributed', 'rnnt_inference_tpu_torch.transcribe', "
        "'rnnt_inference_tpu_torch.parallel.tensor', "
        "'rnnt_inference_tpu_torch.utils.golden', 'rnnt_inference_tpu_torch.tools.multihost_probe', "
        "'rnnt_inference_tpu_torch.tools.dryrun_multichip', "
        "'rnnt_inference_tpu_torch.tools.convert_librispeech', "
        "'rnnt_inference_tpu_torch.tools.eval_accuracy', 'rnnt_inference_tpu_torch.tools.check_calib', "
        "'rnnt_inference_tpu_torch.tools.server_probe', "
        "'rnnt_inference_tpu_torch.tools.run_stages'} <= set(sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("target", ["rnnt_inference_tpu_torch", "chip_smoke.py"])
def test_sources_import_no_jax(target):
    """No source file of the port, and not chip_smoke.py, names jax or the
    JAX package in an import statement."""
    path = os.path.join(REPO, target)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs if f.endswith(".py")
    ]
    assert files
    for f in files:
        bad = {r for r in _imported_roots(f)} & {"jax", "jaxlib", "rnnt_inference_tpu"}
        assert not bad, (f, bad)
