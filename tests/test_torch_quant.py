"""PyTorch port vs the JAX package: calibration and weight quantization,
kernel A's module (the int8 LSTM layer), and the weight bridge.

The JAX package makes the weights (jax.random); the bridge carries them
into the port, so both run on the same values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.models import checkpoint as jckpt
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize as jquantize
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.ops.lstm_pallas import quant_lstm_layer_pallas
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models.quant import (
    QuantLSTMLayerWeights,
    calibrate,
    quantize,
    quantize_weights,
)
from rnnt_inference_tpu_torch.models.weights import (
    load_jax_npz,
    numpy_leaves,
    weights_from_numpy_leaves,
)
from rnnt_inference_tpu_torch.ops import cuda_build, lstm_cuda
from rnnt_inference_tpu_torch.ops.lstm_int8 import quant_lstm_layer

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=128, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=64)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.flatten(tree)[0]]


@pytest.fixture(scope="module")
def models():
    """f32 weights, one calibration batch, and both packages' quant models."""
    w = jinit_weights(jax.random.PRNGKey(0), JP)
    rng = np.random.RandomState(1)
    x = rng.randn(6, 8, 240).astype(np.float32)
    lens = np.array([6, 6, 5, 4, 6, 3, 6, 2], np.int32)
    jcal = jcalibrate(w, [(jnp.asarray(x), jnp.asarray(lens))], JP)
    tw = weights_from_numpy_leaves(_leaves(w), "rnnt_weights", TP, "cpu")
    tcal = calibrate(tw, [(torch.from_numpy(x), torch.from_numpy(lens))], TP)
    return dict(
        w=w, jcal=jcal, tcal=tcal,
        jq=jquantize_weights(w, jcal, JP),
        tq=quantize_weights(tw, tcal, TP),
    )


def test_calibration_and_scales_match_jax(models):
    """amax and every propagated scale within rtol 1e-6 (f32 encoder runs
    in two libraries); int8 and bf16 weights bit-equal."""
    for a, b in ((models["tcal"].pre_amax, models["jcal"].pre_amax),
                 (models["tcal"].post_amax, models["jcal"].post_amax)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    jq, tq = models["jq"], models["tq"]
    for tl, jl in zip(tq.pre_rnn + tq.post_rnn, jq.pre_rnn + jq.post_rnn):
        for name in ("in_scale", "w_scale", "out_scale"):
            np.testing.assert_allclose(
                getattr(tl, name).numpy(), np.asarray(getattr(jl, name)), rtol=1e-6
            )
        np.testing.assert_array_equal(tl.w_ih.numpy(), np.asarray(jl.w_ih))
        np.testing.assert_array_equal(tl.w_hh.numpy(), np.asarray(jl.w_hh))
    assert float(tq.post_rnn[-1].out_scale) == 0.0  # the f32-emitting sentinel
    np.testing.assert_array_equal(
        float(tq.pre_rnn[-1].out_scale), float(tq.post_rnn[0].in_scale)
    )  # the cross-StackTime tie
    for tl, jl in zip(numpy_leaves(tq.pred_rnn), _leaves(jq.pred_rnn)):
        np.testing.assert_array_equal(tl, jl.view(np.uint16))


def _int8_close(got, want, max_share=1e-3):
    """int8 outputs equal except |diff| <= 1 on at most 0.1% of elements."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= max_share, (d != 0).mean()


@pytest.mark.parametrize("N", [8, 24])
@pytest.mark.parametrize("emit_f32", [False, True])
def test_quant_lstm_layer_matches_pallas(models, emit_f32, N):
    """Kernel A's module: the port's plain int8 layer against the JAX Pallas
    kernel in interpret mode, on the same int8 weights and state.
    Tolerance: int8 y/h equal except |diff| <= 1 on <= 0.1% of elements
    (sigmoid/tanh of two libraries); c and f32 y within 1e-5."""
    jq = models["jq"]
    tq = weights_from_numpy_leaves(_leaves(jq), "rnnt_quant_weights", TP, "cpu")
    li = 1 if emit_f32 else 0  # IC = 128 and 240
    jlay, tlay = jq.pre_rnn[li], tq.pre_rnn[li]
    IC, H = tlay.w_ih.shape[0], tlay.w_hh.shape[0]
    rng = np.random.RandomState(10 + N)
    x = rng.randint(-128, 128, size=(5, N, IC)).astype(np.int8)
    h0 = rng.randint(-128, 128, size=(N, H)).astype(np.int8)
    c0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    jy, jh, jc = quant_lstm_layer_pallas(
        jlay, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), emit_f32, interpret=True
    )
    ty, th, tc = quant_lstm_layer(tlay, *map(torch.from_numpy, (x, h0, c0)), emit_f32)
    _int8_close(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    if emit_f32:
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    else:
        _int8_close(ty.numpy(), np.asarray(jy))


def test_kernel_a_operands_layout_and_rebuild(models):
    """Kernel A's operands: w_op is kernel_operand of the layer's W_ih and
    W_hh (its inverse gives them back), the bias and scales are the
    layer's; they are built once per layer and rebuilt after an in-place
    change."""
    src = models["tq"].post_rnn[0]
    layer = dataclasses.replace(src, w_hh=src.w_hh.clone())
    IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
    w_op, bias, rb, in_scale, out_scale = ops = lstm_cuda.kernel_operands(layer)
    assert w_op.shape == (H // 8, (-(-IC // 64) + H // 64) * 64 * 32) and w_op.is_contiguous()
    w_ih, w_hh = lstm_cuda.kernel_operand_inverse(w_op, IC, H)
    assert torch.equal(w_ih, layer.w_ih) and torch.equal(w_hh, layer.w_hh)
    np.testing.assert_array_equal(bias.numpy(), layer.b.numpy())
    assert (rb, in_scale, out_scale) == tuple(
        float(v) for v in (layer.rb_scale, layer.in_scale, layer.out_scale)
    )
    assert lstm_cuda.kernel_operands(layer) is ops
    layer.w_hh.neg_()
    w_op2 = lstm_cuda.kernel_operands(layer)[0]
    assert w_op2 is not w_op
    assert torch.equal(lstm_cuda.kernel_operand_inverse(w_op2, IC, H)[1], layer.w_hh)


@pytest.mark.parametrize("IC", [240, 128, 256])
def test_kernel_a_operand_inverse(IC):
    """kernel_operand's inverse gives W_ih and W_hh back bit for bit (IC=240
    is padded to 256 with zero rows).  Block b's operand is its W_ih
    fragments, then its W_hh fragments, in int8 mma m16n8k32 order: lane
    4g + t of k-step s, n-tile j holds rows 32s + 4t + (0..3, 16..19) of
    local column 8j + g, the gate_columns order shared with bf16."""
    H, U = 64, 8
    rng = np.random.RandomState(IC)
    w_ih = torch.from_numpy(rng.randint(-128, 128, (IC, 4 * H)).astype(np.int8))
    w_hh = torch.from_numpy(rng.randint(-128, 128, (H, 4 * H)).astype(np.int8))
    op = lstm_cuda.kernel_operand(w_ih, w_hh)
    ICP = -(-IC // 64) * 64
    assert op.shape == (H // U, (ICP + H) * 4 * U)
    got_ih, got_hh = lstm_cuda.kernel_operand_inverse(op, IC, H)
    assert torch.equal(got_ih, w_ih) and torch.equal(got_hh, w_hh)
    frag = op.reshape(H // U, -1, U // 2, 32, 8)  # block, k-step, n-tile, lane, byte
    perm = cuda_build.gate_columns(U, torch.int8)
    assert torch.equal(perm, cuda_build.gate_columns(U, torch.bfloat16))
    b = H // U - 1
    for which, w, s0 in (("ih", w_ih, 0), ("hh", w_hh, ICP // 32)):
        for s, j, g, t in ((0, 0, 0, 0), (1, 3, 5, 2), (ICP // 32 - 1 if which == "ih" else 1, 2, 7, 3)):
            unit, gate = divmod(int(perm[8 * j + g]), 4)
            col = w[:, gate * H + b * U + unit]
            col = torch.cat([col, col.new_zeros(ICP - len(col))]) if which == "ih" else col
            want = col[[32 * s + 4 * t + k for k in (0, 1, 2, 3, 16, 17, 18, 19)]]
            assert torch.equal(frag[b, s0 + s, j, 4 * g + t], want)
    if IC == 240:  # the padded rows are zeros
        assert not cuda_build.block_columns_inverse(frag[:, :ICP // 32], H, U)[IC:].any()


@pytest.mark.parametrize("emit_f32", [False, True])
def test_twin_from_kernel_a_operand_matches_pallas(models, emit_f32):
    """The twin on W_ih and W_hh recovered from kernel A's operand against
    the JAX Pallas kernel (interpret mode), with
    test_quant_lstm_layer_matches_pallas's tolerances: the layout loses
    nothing."""
    jq = models["jq"]
    tq = weights_from_numpy_leaves(_leaves(jq), "rnnt_quant_weights", TP, "cpu")
    jlay, tlay = jq.pre_rnn[0], tq.pre_rnn[0]  # IC = 240, padded in the operand
    IC, H = tlay.w_ih.shape[0], tlay.w_hh.shape[0]
    w_ih, w_hh = lstm_cuda.kernel_operand_inverse(lstm_cuda.kernel_operands(tlay)[0], IC, H)
    rng = np.random.RandomState(31)
    x = rng.randint(-128, 128, size=(4, 8, IC)).astype(np.int8)
    h0 = rng.randint(-128, 128, size=(8, H)).astype(np.int8)
    c0 = (rng.randn(8, H) * 0.5).astype(np.float32)
    jy, jh, jc = quant_lstm_layer_pallas(
        jlay, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), emit_f32, interpret=True
    )
    ty, th, tc = quant_lstm_layer(dataclasses.replace(tlay, w_ih=w_ih, w_hh=w_hh),
                                  *map(torch.from_numpy, (x, h0, c0)), emit_f32)
    _int8_close(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    if emit_f32:
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    else:
        _int8_close(ty.numpy(), np.asarray(jy))


def test_kernel_a_plan_and_refusals():
    """plan: H=1024 on 132 SMs takes 128 blocks of 8 units; the first post
    layer (IC=2048) fits 1,024 lanes; H or IC not a multiple of 16, more
    blocks than SMs and more lanes than shared memory holds raise
    ValueError.  The wrapper takes CUDA tensors only."""
    assert lstm_cuda.plan(1024, 2048, 1024, 132) < cuda_build.SMEM_PER_BLOCK
    assert lstm_cuda.plan(1024, 240, 16, 132) < lstm_cuda.plan(1024, 2048, 16, 132)
    for args, msg in [((1000, 240, 16), "multiples of 16"), ((1024, 250, 16), "multiples of 16"),
                      ((2048, 1024, 16), "blocks"), ((1024, 2048, 4096), "shared memory")]:
        with pytest.raises(ValueError, match=msg):
            lstm_cuda.plan(*args, 132)
    z = lambda *s, dt=torch.int8: torch.zeros(s, dtype=dt)
    lay = QuantLSTMLayerWeights(z(32, 64), z(16, 64), z(64, dt=torch.float32),
                                *(torch.tensor(1.0) for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cuda.quant_lstm_layer_cuda(lay, z(2, 3, 32), z(3, 16), z(3, 16, dt=torch.float32),
                                        False)


@pytest.mark.parametrize("T, N, IC, hoisted", [
    (16, 1024, 240, True),     # the packed runner's chunk: pre-net layer 0
    (16, 1024, 1024, True),    # pre-net layer 1
    (8, 1024, 2048, True),     # post-net layer 0, after the time reduction
    (8, 1024, 1024, True),     # post-net layers 1 and 2
    (24, 128, 1024, False),    # the Server: 128 slots, split 24
    (12, 128, 2048, False),    # its post-net
    (251, 1, 240, False),      # SingleStream: one lane
    (48, 16, 1024, False),     # the bucketed int8 runner's 16 lanes
    (750, 128, 240, False),    # a bucketed batch of 128 whole utterances
    (3, 341, 240, False),      # 1,023 rows: below HOIST_MIN_ROWS
    (4, 256, 240, True),       # 1,024 rows
    (17, 1024, 1024, False),   # 17,408 rows: above HOIST_MAX_ROWS
])
def test_kernel_a_hoist_rule(T, N, IC, hoisted):
    """Kernel A's path from the call's shape alone: more lanes than one pass
    of the loop (128) and HOIST_MIN_ROWS <= T N <= HOIST_MAX_ROWS hoist,
    at every IC.  The hoisted loop's shared memory stages no W_ih (ICP x
    32 bytes) and keeps the warps' sums (8 x 16 x 40 words) beside its two
    h slots."""
    assert lstm_cuda.hoists(T, N, IC) is hoisted
    smem = {h: lstm_cuda.plan(1024, IC, N, 132, hoisted=h) for h in (False, True)}
    assert smem[True] - smem[False] == 8 * 16 * 40 * 4 - -(-IC // 64) * 64 * 32


@pytest.mark.parametrize("IC", [240, 1024])
def test_kernel_a_xw_operand_and_layout(IC):
    """The input GEMM's operand and output: xw_operand's inverse gives W_ih
    back bit for bit, its row b 4U + 4u + g is W_ih's column g H + b U + u,
    and x times the operand's rows (what the GEMM computes), each row's
    columns stored at (t, b, n, u, g) as its epilogue stores them, equals
    input_products, whose int4 at ((t H/U + b) N + n) U + u (what the time
    loop reads) holds gates 0-3 of unit b U + u for lane n at step t."""
    H, U, T, N = 64, lstm_cuda.U, 3, 5
    rng = np.random.RandomState(IC)
    w_ih = torch.from_numpy(rng.randint(-128, 128, (IC, 4 * H)).astype(np.int8))
    x = torch.from_numpy(rng.randint(-128, 128, (T, N, IC)).astype(np.int8))
    op = lstm_cuda.xw_operand(w_ih)
    assert op.shape == (4 * H, IC) and op.is_contiguous()
    assert torch.equal(lstm_cuda.xw_operand_inverse(op), w_ih)
    b, u, g = H // U - 1, 5, 2
    assert torch.equal(op[b * 4 * U + 4 * u + g], w_ih[:, g * H + b * U + u])
    sums = torch.matmul(x.reshape(T * N, IC).double(), op.t().double()).to(torch.int32)
    stored = torch.empty(T * (H // U) * N * 4 * U, dtype=torch.int32)
    for r in range(T * N):
        t, n = divmod(r, N)
        for c0 in range(0, 4 * H, 4 * U):  # one block's 4U columns: a 128-byte row
            off = ((t * (H // U) + c0 // (4 * U)) * N + n) * 4 * U
            stored[off:off + 4 * U] = sums[r, c0:c0 + 4 * U]
    xw = lstm_cuda.input_products(x, w_ih)
    assert xw.shape == (T, H // U, N, U, 4) and xw.dtype == torch.int32
    assert torch.equal(stored, xw.reshape(-1))
    plain = torch.matmul(x.double(), w_ih.double())
    flat = xw.reshape(-1, 4)
    for t, n, b, u in ((0, 0, 0, 0), (2, 4, H // U - 1, 7), (1, 2, 3, 5)):
        want = plain[t, n, [gg * H + b * U + u for gg in range(4)]]
        assert torch.equal(flat[((t * (H // U) + b) * N + n) * U + u].double(), want)


def test_quantize_rounds_half_to_even():
    """quantize == the JAX package's: round half to even, clamp [-128, 127]."""
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -128.5, 300.0, -300.0],
                 np.float32)
    got = quantize(torch.from_numpy(v), 1.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jquantize(jnp.asarray(v), 1.0)))
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, 126, 127, -128, 127, -128])


@pytest.mark.parametrize("route", ["leaves", "npz"])
@pytest.mark.parametrize("kind", ["rnnt_weights", "rnnt_quant_weights"])
def test_weight_bridge_round_trip(models, tmp_path, kind, route):
    """JAX weights -> port -> arrays reproduces every leaf bit for bit, both
    from flattened leaves and from a save_pytree container."""
    tree = models["w"] if kind == "rnnt_weights" else models["jq"]
    want = _leaves(tree)
    if route == "leaves":
        tw = weights_from_numpy_leaves(want, kind, TP, "cpu")
    else:
        path = str(tmp_path / "w.npz")
        jckpt.save_pytree(path, tree, kind)
        tw = load_jax_npz(path, TP, "cpu")
    got = numpy_leaves(tw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
