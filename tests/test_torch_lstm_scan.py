"""Kernel C's module (ops/lstm.py lstm_layer / lstm_recurrence,
ops/lstm_scan_cuda.py) against the JAX Pallas float LSTM kernel
(lstm_pallas.lstm_layer_pallas, interpret mode) on the CPU, and the impl
wiring through the encoder and calibration.

Tolerances: f32 y/h/c within 1e-5 (f32 matmul summation order); bf16 y/h
within 2**-8 (one bf16 step below 1: an h may round to the other bf16
neighbour) and c within 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.models.weights import LSTMLayerWeights as JLayer
from rnnt_inference_tpu.ops.lstm_pallas import lstm_layer_pallas
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import rnnt as trnnt
from rnnt_inference_tpu_torch.models.quant import calibrate
from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights, init_weights
from rnnt_inference_tpu_torch.ops import lstm as tl
from rnnt_inference_tpu_torch.ops import lstm_scan_cuda

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2 ** -8, 1e-3)}


def _layer(rng, IC, H):
    k = 1.0 / np.sqrt(H)
    return [rng.uniform(-k, k, s).astype(np.float32) for s in ((IC, 4 * H), (H, 4 * H), (4 * H,))]


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 6])
def test_twin_matches_jax_pallas(mode, T):
    """lstm_layer (projection + the recurrence's plain twin) against
    lstm_layer_pallas(interpret=True) at T x N=8 x IC=64 -> H=128."""
    tdt, jdt, tol_h, tol_c = DTYPES[mode]
    rng = np.random.RandomState(11)
    N, IC, H = 8, 64, 128
    ws = _layer(rng, IC, H)
    x = rng.randn(T, N, IC).astype(np.float32)
    h0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    want = lstm_layer_pallas(JLayer(*(jnp.asarray(w).astype(jdt) for w in ws)),
                             jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), interpret=True)
    got = tl.lstm_layer(LSTMLayerWeights(*(torch.from_numpy(w).to(tdt) for w in ws)),
                        *map(torch.from_numpy, (x, h0, c0)))
    for g, w, tol in zip(got, want, (tol_h, tol_h, tol_c)):
        assert g.dtype == (torch.float32 if w.dtype == jnp.float32 else tdt)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), atol=tol)


def test_impl_dispatch_on_cpu():
    """CPU tensors take the twin with impl None or "reference" (the same
    numbers); an unknown impl raises; T=0 returns the carried state."""
    rng = np.random.RandomState(2)
    lay = LSTMLayerWeights(*map(torch.from_numpy, _layer(rng, 16, 16)))
    x = torch.from_numpy(rng.randn(3, 2, 16).astype(np.float32))
    h0, c0 = torch.zeros(2, 16), torch.ones(2, 16)
    a, b = tl.lstm_layer(lay, x, h0, c0), tl.lstm_layer(lay, x, h0, c0, impl="reference")
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="impl"):
        tl.lstm_layer(lay, x, h0, c0, impl="pallas")
    y, h, c = tl.lstm_layer(lay, x[:0], h0, c0)
    assert y.shape == (0, 2, 16) and torch.equal(h, h0) and torch.equal(c, c0)


def test_recurrent_weight_layout_and_rebuild():
    """Kernel C's operand is W_hh^T, contiguous, kept per layer and rebuilt
    after an in-place change of W_hh."""
    rng = np.random.RandomState(3)
    lay = LSTMLayerWeights(*map(torch.from_numpy, _layer(rng, 8, 16)))
    w_t = lstm_scan_cuda.recurrent_weight(lay)
    assert w_t.shape == (64, 16) and w_t.is_contiguous()
    assert torch.equal(w_t, lay.w_hh.t())
    assert lstm_scan_cuda.recurrent_weight(lay) is w_t
    lay.w_hh.neg_()
    assert torch.equal(lstm_scan_cuda.recurrent_weight(lay), lay.w_hh.t())
    other = dataclasses.replace(lay, w_hh=lay.w_hh.clone())
    assert lstm_scan_cuda.recurrent_weight(other) is not lstm_scan_cuda.recurrent_weight(lay)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only (the choice by device is
    lstm_layer's); nothing is built or launched for a CPU tensor."""
    lay = LSTMLayerWeights(torch.zeros(8, 64), torch.zeros(16, 64), torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA"):
        lstm_scan_cuda.lstm_recurrence_cuda(lay, torch.zeros(2, 3, 64), torch.zeros(3, 16),
                                            torch.zeros(3, 16))
    with pytest.raises(ValueError, match="bf16 or f32"):
        lstm_scan_cuda.lstm_recurrence_cuda(
            LSTMLayerWeights(*(t.half() for t in (lay.w_ih, lay.w_hh, lay.b))),
            torch.zeros(2, 3, 64), torch.zeros(3, 16), torch.zeros(3, 16))


P = RNNTParams(trans_hidden_size=64, pred_hidden_size=32, joint_hidden_size=32,
               max_res_len=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_and_calibration_thread_impl(dtype):
    """transcription's float branch and calibrate pass impl down to every
    layer: impl="reference" gives the default's numbers on the CPU, and an
    unknown impl reaches lstm_layer and raises."""
    w = init_weights(P, torch.Generator().manual_seed(0), dtype=dtype, device="cpu")
    x = torch.randn((10, 3, 240), generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([10, 7, 2])
    state = trnnt.init_encoder_state(3, P, dtype, "cpu")
    a, _ = trnnt.transcription(w, x, lens, state, P)
    b, _ = trnnt.transcription(w, x, lens, state, P, impl="reference")
    assert a.dtype == dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="impl"):
        trnnt.transcription(w, x, lens, state, P, impl="cuda")
    w32 = w.to(dtype=torch.float32)
    ca = calibrate(w32, [(x, lens)], P)
    cb = calibrate(w32, [(x, lens)], P, impl="reference")
    assert torch.equal(ca.pre_amax, cb.pre_amax) and torch.equal(ca.post_amax, cb.post_amax)
    with pytest.raises(ValueError, match="impl"):
        calibrate(w32, [(x, lens)], P, impl="cuda")
