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
from rnnt_inference_tpu_torch.ops import cuda_build, lstm_scan_cuda

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
    """Kernel C's operand is W_hh in per-block order (block_columns), whose
    inverse gives W_hh back; it is kept per layer and rebuilt after an
    in-place change of W_hh."""
    rng = np.random.RandomState(3)
    lay = LSTMLayerWeights(*map(torch.from_numpy, _layer(rng, 8, 128)))
    op = lstm_scan_cuda.recurrent_weight(lay, 4)
    assert op.shape == (32, 128, 16) and op.is_contiguous()
    assert torch.equal(cuda_build.block_columns_inverse(op, 128, 4), lay.w_hh)
    assert lstm_scan_cuda.recurrent_weight(lay, 4) is op
    lay.w_hh.neg_()
    assert torch.equal(
        cuda_build.block_columns_inverse(lstm_scan_cuda.recurrent_weight(lay, 4), 128, 4),
        lay.w_hh)
    other = dataclasses.replace(lay, w_hh=lay.w_hh.clone())
    assert lstm_scan_cuda.recurrent_weight(other, 4) is not lstm_scan_cuda.recurrent_weight(lay, 4)


@pytest.mark.parametrize("H,U", [(128, 4), (256, 4), (1024, 8), (2048, 16)])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_scan_operand_inverse(mode, H, U):
    """block_columns' inverse gives W_hh back bit for bit.  In bf16, lane
    4 g + t of n-tiles 2i, 2i + 1 holds the four gates of unit 4i + t
    (column 8 j + 2 t + e: gate 2 (j % 2) + e), so an mma C fragment holds
    whole units; lane 4 g + t of the fragment of k-step s holds rows
    16 s + 2 t + (0, 1, 8, 9).  In f32 local column 4 u + g is gate g of
    unit u (csrc/hopper.cuh)."""
    tdt = DTYPES[mode][0]
    w = torch.from_numpy(np.random.RandomState(H).randn(H, 4 * H).astype(np.float32)).to(tdt)
    op = cuda_build.block_columns(w, U)
    assert torch.equal(cuda_build.block_columns_inverse(op, H, U), w)
    b = H // U - 1
    perm = cuda_build.gate_columns(U, tdt)  # local column c: unit perm[c] // 4, gate perm[c] % 4
    if mode == "bf16":
        for i in range(U // 4):
            for t in range(4):  # the C fragment's columns of lane 4 g + t
                held = {int(perm[8 * (2 * i + jj) + 2 * t + e]) for jj in (0, 1) for e in (0, 1)}
                assert held == {4 * (4 * i + t) + gate for gate in range(4)}
        s_, j, g, t = 3, U // 2 - 1, 5, 2
        unit, gate = divmod(int(perm[8 * j + g]), 4)
        want = w[[16 * s_ + 2 * t + k for k in (0, 1, 8, 9)], gate * H + b * U + unit]
        assert torch.equal(op[b, s_, j, 4 * g + t], want)
    else:
        u, gate = U - 1, 2
        assert int(perm[4 * u + gate]) == 4 * u + gate
        assert torch.equal(op[b, :, 4 * u + gate], w[:, gate * H + b * U + u])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_twin_from_operand_matches_jax_pallas(mode):
    """The twin's recurrence on W_hh recovered from kernel C's operand
    against the JAX Pallas recurrence (_lstm_recurrence, interpret mode) on
    the same xw, at T=5, N=8, H=128: the layout loses nothing.  Tolerances
    as the module's."""
    from rnnt_inference_tpu.ops.lstm_pallas import _lstm_recurrence

    tdt, jdt, tol_h, tol_c = DTYPES[mode]
    rng = np.random.RandomState(12)
    T, N, H = 5, 8, 128
    w_hh = _layer(rng, 8, H)[1]
    xw = (rng.randn(T, N, 4 * H) * 0.5).astype(np.float32)
    h0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    j = lambda a: jnp.asarray(a).astype(jdt)
    want = _lstm_recurrence(j(xw), j(w_hh), j(h0), jnp.asarray(c0), interpret=True)
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jdt).astype(jnp.float32))).to(tdt)
    op = cuda_build.block_columns(t(w_hh), 4)
    got = tl.lstm_recurrence(t(xw), cuda_build.block_columns_inverse(op, H, 4), t(h0),
                             torch.from_numpy(c0))
    for g, w, tol in zip(got, want, (tol_h, tol_h, tol_c)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), atol=tol)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plan_units_and_refusals(mode):
    """plan takes U=8 units per block, one block to an SM (H=1024 on 132
    SMs: 128 blocks; H=256: 32) and refuses, with ValueError, H not a
    multiple of 128, a grid larger than the card (H=2048 needs 256
    blocks), and more lanes than shared memory holds (N=8192; the bf16
    cluster loop holds up to ~4,100 at H=1024); N=1024 fits."""
    tdt = DTYPES[mode][0]
    assert lstm_scan_cuda.plan(1024, 1024, tdt, 132)[0] == 8
    assert lstm_scan_cuda.plan(256, 1, tdt, 132)[0] == 8
    with pytest.raises(ValueError, match="blocks"):
        lstm_scan_cuda.plan(2048, 8, tdt, 132)
    with pytest.raises(ValueError, match="multiple of 128"):
        lstm_scan_cuda.plan(192, 8, tdt, 132)
    with pytest.raises(ValueError, match="blocks"):
        lstm_scan_cuda.plan(4096, 8, tdt, 132)
    with pytest.raises(ValueError, match="shared memory"):
        lstm_scan_cuda.plan(1024, 8192, tdt, 132)


# clusters of 4 and of 2 the card reports holding at once, and the size plan
# takes: enough for 4, for 2 only, for neither (H=1024: 128 blocks, 32
# clusters of 4 or 64 of 2; H=256: 32 blocks, 8 or 16)
CARDS = {1024: [({4: 32, 2: 66}, 4), ({4: 31, 2: 64}, 2), ({4: 30, 2: 63}, 1)],
         256: [({4: 8, 2: 16}, 4), ({4: 7, 2: 16}, 2), ({4: 7, 2: 15}, 1)]}


@pytest.mark.parametrize("card", [0, 1, 2], ids=["four", "two_only", "neither"])
@pytest.mark.parametrize("H", [1024, 256])
def test_plan_cluster_size_from_the_card(H, card):
    """bf16 calls of more than 128 lanes run the cluster loop: plan takes
    the largest cluster size in {4, 2} of which the card holds all H / 8 /
    size clusters at once (what cudaOccupancyMaxActiveClusters reports),
    else 1; it asks for 4 first and for 2 only when 4 does not fit, and a
    plan given no report takes 1.  bf16 calls of one pass (N <= 128) and
    f32 run the pass engine, cluster size 0, and ask nothing."""
    reported, want = CARDS[H][card]
    asked = []

    def clusters(cs):
        asked.append(cs)
        return reported[cs]

    U, smem, cs = lstm_scan_cuda.plan(H, 1024, torch.bfloat16, 132, clusters)
    assert (U, cs) == (8, want)
    assert smem == lstm_scan_cuda.cluster_smem(H, 1024, 2) <= cuda_build.SMEM_PER_BLOCK
    assert asked == ([4] if want == 4 else [4, 2])
    assert lstm_scan_cuda.plan(H, 129, torch.bfloat16, 132, clusters)[2] == want
    assert lstm_scan_cuda.plan(H, 1024, torch.bfloat16, 132)[2] == 1
    asked.clear()
    for N, dt in ((128, torch.bfloat16), (16, torch.bfloat16), (1024, torch.float32)):
        assert lstm_scan_cuda.plan(H, N, dt, 132, clusters)[2] == 0
    assert asked == []


def test_cluster_launches_count_as_launches(monkeypatch):
    """Every launch adds one to lstm_recurrence_cuda.launches, and each
    launch of the cluster loop one to cluster_launches under its cluster
    size (the pass engine's, size 0, none), also while a recorder stands in
    for the function's name (as the benchmark's does)."""
    rec = lstm_scan_cuda.lstm_recurrence_cuda
    n, by = rec.launches, dict(rec.cluster_launches)
    for cs in (4, 4, 2, 1, 0):
        lstm_scan_cuda._count_launch(cs)
    assert rec.launches == n + 5
    assert rec.cluster_launches == {**by, 4: by.get(4, 0) + 2, 2: by.get(2, 0) + 1,
                                    1: by.get(1, 0) + 1}
    assert sum(rec.cluster_launches.values()) - sum(by.values()) == rec.launches - n - 1

    def stand_in(*args):
        return rec(*args)

    stand_in.launches = rec.launches
    monkeypatch.setattr(lstm_scan_cuda, "lstm_recurrence_cuda", stand_in)
    lstm_scan_cuda._count_launch(4)
    assert stand_in.launches == rec.launches + 1
    assert rec.cluster_launches[4] == by.get(4, 0) + 3


@pytest.mark.parametrize("H", [128, 1024])
def test_bf16_recurrent_weight_is_kmajor(H):
    """The cluster loop's operand is each block's 32 gate columns as rows of
    H inputs ({H / 8, 32, H}, the rows TMA brings to wgmma), in
    gate_columns order, kept beside the pass engine's fragment-order one;
    block_columns_inverse gives W_hh back bit for bit."""
    rng = np.random.RandomState(H)
    lay = LSTMLayerWeights(*(torch.from_numpy(w).to(torch.bfloat16) for w in _layer(rng, 8, H)))
    op = lstm_scan_cuda.recurrent_weight(lay, 8, kmajor=True)
    frag = lstm_scan_cuda.recurrent_weight(lay, 8)
    assert frag.shape == (H // 8, H // 16, 4, 32, 4)
    assert lstm_scan_cuda.recurrent_weight(lay, 8, kmajor=True) is op
    assert op.shape == (H // 8, 32, H) and op.is_contiguous()
    assert torch.equal(cuda_build.block_columns_inverse(op, H, 8, kmajor=True), lay.w_hh)
    perm = cuda_build.gate_columns(8, torch.bfloat16)
    b, r = H // 8 - 1, 13
    unit, gate = divmod(int(perm[r]), 4)
    assert torch.equal(op[b, r], lay.w_hh[:, gate * H + b * 8 + unit])


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
