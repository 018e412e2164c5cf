"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
check runs inside a fixture, never at import).  On a GPU machine:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models.decoder import greedy_decode
from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
from rnnt_inference_tpu_torch.models.weights import init_weights
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.ops import lstm_cuda
from rnnt_inference_tpu_torch.ops.lstm_int8 import quant_lstm_layer

pytestmark = pytest.mark.cuda

P = RNNTParams(trans_hidden_size=256, pred_hidden_size=64, joint_hidden_size=64,
               max_res_len=128)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def qweights(dev):
    w = init_weights(P, torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((12, 8, 240), generator=torch.Generator().manual_seed(1)).to(dev)
    calib = calibrate(w, [(x, torch.full((8,), 12, device=dev))], P)
    return quantize_weights(w, calib, P)


@pytest.mark.parametrize("emit_f32", [False, True])
def test_quant_lstm_kernel_matches_twin(dev, qweights, emit_f32):
    """int8 y/h equal except |diff| <= 1 on <= 0.1%; c and f32 y within 1e-5."""
    layer = qweights.post_rnn[0]
    IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-128, 128, (9, 20, IC), generator=g, dtype=torch.int8).to(dev)
    h = torch.randint(-128, 128, (20, H), generator=g, dtype=torch.int8).to(dev)
    c = torch.randn((20, H), generator=g).to(dev)
    got = lstm_cuda.quant_lstm_layer_cuda(layer, x, h, c, emit_f32)
    want = quant_lstm_layer(layer, x, h, c, emit_f32)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "h", "c"), got, want):
        if a.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3, name
        else:
            assert float((a - b).abs().max()) <= 1e-5, name


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_decode_step_kernel_matches_twin(dev, wdtype):
    """Each step from the twin's state: lanes, symbols and tokens equal.
    Both sum in f32 in different orders, so hg is held to one step of its
    dtype below 1 (bf16: 2**-8; f32: 1e-5) and cg to 1e-3 (bf16, where a
    layer-0 h may round to the other neighbour) or 1e-5 (f32)."""
    w = init_weights(P, torch.Generator().manual_seed(3), dtype=wdtype, device=dev)
    dw = dc.decode_weights(w)
    N, T2, L, R = 40, 5, P.pred_num_layers, P.max_res_len
    rng = np.random.RandomState(4)
    f_lens = rng.randint(0, T2 + 1, N)
    lanes = np.stack([
        rng.randint(-1, 28, N), np.minimum(rng.randint(0, T2, N), np.maximum(f_lens - 1, 0)),
        rng.choice([0, 3, 30], N), rng.choice([-1, 5, R - 1], N), (f_lens == 0),
        f_lens, np.maximum(f_lens - 1, 0), np.zeros(N),
    ]).astype(np.int32)
    fproj = torch.from_numpy(rng.randn(T2, N, P.joint_hidden_size).astype(np.float32)).to(dev)
    hg = torch.from_numpy(rng.randn(L, N, P.pred_hidden_size).astype(np.float32)).to(dev, wdtype)
    cg = torch.from_numpy(rng.randn(L, N, P.pred_hidden_size).astype(np.float32)).to(dev)
    res = torch.full((N, R), -1, dtype=torch.int8, device=dev)
    b = [torch.from_numpy(lanes).to(dev), hg, cg, res]
    bf16 = wdtype == torch.bfloat16
    for _ in range(3):
        a = [t.clone() for t in b]
        dc.decode_step_cuda(fproj, *a, dw, P)
        dc.decode_step_reference(fproj, *b, dw, P)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
        assert float((a[1].float() - b[1].float()).abs().max()) <= (2 ** -8 if bf16 else 1e-5)
        assert float((a[2] - b[2]).abs().max()) <= (1e-3 if bf16 else 1e-5)


def test_pipeline_kernels_match_twins(dev, qweights):
    """The int8 encoder + decode through both kernels gives the twins' tokens
    (at this size the f32 summation orders flip no symbol)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((30, 6, 240), generator=g).to(dev)
    lens = torch.tensor([30, 28, 20, 11, 3, 0], device=dev)
    got = greedy_decode(qweights, x, lens, P)
    want = greedy_decode(qweights, x, lens, P, impl="reference")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [5, 40])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_kernel_matches_twin(dev, wdtype, N):
    """Kernel C over T=7 steps, N lanes not a multiple of the block's 16:
    f32 y/h/c within 1e-5; bf16 y/h within 2**-8 (one bf16 step below 1)
    and c within 1e-3.  Launch count = T."""
    from rnnt_inference_tpu_torch.ops import lstm as tl
    from rnnt_inference_tpu_torch.ops import lstm_scan_cuda

    w = init_weights(P, torch.Generator().manual_seed(6), dtype=wdtype, device=dev)
    layer = w.post_rnn[0]
    IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
    g = torch.Generator().manual_seed(7)
    x = torch.randn((7, N, IC), generator=g).to(dev)
    h0 = (torch.randn((N, H), generator=g) * 0.5).to(dev)
    c0 = (torch.randn((N, H), generator=g) * 0.5).to(dev)
    before = lstm_scan_cuda.lstm_recurrence_cuda.launches
    got = tl.lstm_layer(layer, x, h0, c0)
    assert lstm_scan_cuda.lstm_recurrence_cuda.launches == before + 7
    want = tl.lstm_layer(layer, x, h0, c0, impl="reference")
    torch.cuda.synchronize()
    bf16 = wdtype == torch.bfloat16
    for name, a, b in zip(("y", "h", "c"), got, want):
        tol = (1e-3 if name == "c" else 2 ** -8) if bf16 else 1e-5
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= tol, name


def test_log_mel_kernel_matches_twin(dev):
    """Kernel D, and the fused entry point, against their twins: raw log-mel
    within 1e-4, normalized features within 5e-4, lengths equal."""
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.ops import features as tf
    from rnnt_inference_tpu_torch.ops import features_cuda

    cfg = FeaturizerConfig()
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 5000).astype(np.float32)).to(dev)
    for T in (1, 31, 33):
        a, b = tf.fused_mel(x, T, cfg), tf.fused_mel(x, T, cfg, impl="reference")
        torch.cuda.synchronize()
        assert a.shape == b.shape == (3, T, cfg.n_mels)
        assert float((a - b).abs().max()) <= 1e-4
    wav = torch.from_numpy((rng.randn(4, 24000) * 0.1).astype(np.float32)).to(dev)
    lens = torch.tensor([24000, 17000, 300, 0], device=dev)
    before = features_cuda.log_mel_cuda.launches
    got, gl = tf.log_mel_features_fused(wav, lens, cfg)
    assert features_cuda.log_mel_cuda.launches == before + 1
    want, wl = tf.log_mel_features_fused(wav, lens, cfg, impl="reference")
    assert torch.equal(gl, wl) and float((got - want).abs().max()) <= 5e-4


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_float_pipeline_kernels_match_twins(dev, wdtype):
    """The float encoder (kernel C) + decode (kernel B) give the twins'
    tokens at this size."""
    w = init_weights(P, torch.Generator().manual_seed(9), dtype=wdtype, device=dev)
    g = torch.Generator().manual_seed(10)
    x = torch.randn((30, 6, 240), generator=g).to(dev)
    lens = torch.tensor([30, 28, 20, 11, 3, 0], device=dev)
    got = greedy_decode(w, x, lens, P)
    want = greedy_decode(w, x, lens, P, impl="reference")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
