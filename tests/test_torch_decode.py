"""PyTorch port vs the JAX package: kernel B's module (one decode step) and
the greedy decode, on the same weights (made by the JAX package, carried
over by the bridge) and the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.models import decoder as jdec
from rnnt_inference_tpu.models import rnnt as jmodel
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.ops import decode_pallas as jdp
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import rnnt as tmodel
from rnnt_inference_tpu_torch.models.decoder import greedy_decode
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.ops import cuda_build
from rnnt_inference_tpu_torch.ops import decode_cuda as dc

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=64)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _both(seed, dtype, jp=JP, tp=TP):
    w = jinit_weights(jax.random.PRNGKey(seed), jp, dtype=DTYPES[dtype])
    leaves = [np.asarray(a) for a in jax.tree.flatten(w)[0]]
    return w, weights_from_numpy_leaves(leaves, "rnnt_weights", tp, "cpu")


# kernel B's operand widths: these tests' narrow ones, and the full model's
# prediction net and joint (P=320, J=512; the encoder stays narrow)
FULL_STEP = dict(DIMS, pred_hidden_size=320, joint_hidden_size=512)
STEP_WIDTHS = {"narrow": (JP, TP), "full": (JParams(**FULL_STEP), RNNTParams(**FULL_STEP))}


@pytest.mark.parametrize("width", ["narrow", "full"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_reference_matches_pallas(dtype, width):
    """Kernel B's module: decode_step_reference (fproj gather and token
    write folded in) against the JAX Pallas step in interpret mode plus the
    gather and scatter the JAX decoder runs around it.  Symbols, every lane
    value and the token buffer equal.  Both sum in f32, in the two
    libraries' orders: narrow, hg/cg within 1e-6; full width (sums of 640
    products), f32 hg/cg within 1e-5, and with bf16 weights hg within 2**-8,
    one bf16 step below 1 (an h may land on the other side of a rounding
    boundary), and cg within 1e-3 (such an h in layer 0 moves the layer-1
    gates by up to 2**-8 * max|W_ih| ~ 2e-4)."""
    _step_against_pallas(dtype, width)


def _step_against_pallas(dtype, width, relayout=None):
    """decode_step_reference on the bridged weights (``relayout(dw)`` of
    them if given) against the JAX Pallas step; see the tests below."""
    jp, tp = STEP_WIDTHS[width]
    jw, tw = _both(3, dtype, jp, tp)
    rng = np.random.RandomState(5)
    N, T2, L, P, J, R = 24, 6, 2, jp.pred_hidden_size, jp.joint_hidden_size, jp.max_res_len
    fproj = rng.randn(T2, N, J).astype(np.float32)
    f_lens = rng.randint(0, T2 + 1, N).astype(np.int32)
    eos = np.maximum(f_lens - 1, 0)
    time_idx = np.minimum(rng.randint(0, T2, N), eos).astype(np.int32)
    pre_g = rng.randint(-1, jp.num_labels - 1, N).astype(np.int32)  # SOS included
    symadd = rng.choice([0, 1, 5, 29, 30], N).astype(np.int32)  # 30 = the cap
    res_idx = rng.choice([-1, 0, 7, R - 2, R - 1, R + 3], N).astype(np.int32)
    finish = ((f_lens == 0) | (rng.rand(N) < 0.2)).astype(np.int32)
    hg = rng.randn(L, N, P).astype(np.float32) * 0.5
    cg = rng.randn(L, N, P).astype(np.float32) * 0.5
    hg_w = np.asarray(jnp.asarray(hg).astype(DTYPES[dtype]))
    res = rng.randint(-1, jp.num_labels, (N, R)).astype(np.int8)

    # JAX: the Pallas step on the gathered row, then the decoder's scatter
    lanes_in = [pre_g, time_idx, symadd, res_idx, finish, f_lens, eos]
    col = lambda v: jnp.asarray(v)[:, None]
    pw = jdp._pad_pred_weights(jw, jp)
    out, jhg, jcg = jdp.decode_step_pallas(
        jnp.asarray(fproj[time_idx, np.arange(N)]), [col(v) for v in lanes_in],
        jdp.pad_state(jnp.asarray(hg_w), P), jdp.pad_state(jnp.asarray(cg), P),
        pw, jp, interpret=True,
    )
    out = [np.asarray(o)[:, 0] for o in out]
    want_res = res.copy()
    write_idx, symbols = out[5], out[6]
    ok = write_idx < R
    want_res[np.arange(N)[ok], write_idx[ok]] = symbols[ok]

    # port: the twin, in place
    dw = dc.decode_weights(tw)
    dw = relayout(dw) if relayout else dw
    lanes = torch.from_numpy(np.stack(lanes_in + [np.zeros(N, np.int32)]))
    wdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    thg = torch.from_numpy(hg_w.astype(np.float32)).to(wdt)  # exact: values are wdt's
    tcg = torch.from_numpy(cg.copy())
    tres = torch.from_numpy(res.copy())
    dc.decode_step_reference(
        torch.from_numpy(fproj), lanes, thg, tcg, tres, dw, tp
    )
    got = lanes.numpy()
    for row, want in zip((dc.PRE_G, dc.TIME, dc.SYMADD, dc.RES_IDX, dc.FINISH), out[:5]):
        np.testing.assert_array_equal(got[row], want)
    np.testing.assert_array_equal(got[dc.SYMBOL], symbols)
    np.testing.assert_array_equal(tres.numpy(), want_res)
    want_hg = np.asarray(jdp.unpad_state(jhg, P)).astype(np.float32)
    want_cg = np.asarray(jdp.unpad_state(jcg, P))
    if width == "narrow":
        np.testing.assert_allclose(thg.float().numpy(), want_hg, atol=1e-6)
        np.testing.assert_allclose(tcg.numpy(), want_cg, atol=1e-6)
    elif dtype == "f32":
        np.testing.assert_allclose(thg.float().numpy(), want_hg, atol=1e-5)
        np.testing.assert_allclose(tcg.numpy(), want_cg, atol=1e-5)
    else:
        np.testing.assert_allclose(thg.float().numpy(), want_hg, atol=2**-8)
        np.testing.assert_allclose(tcg.numpy(), want_cg, atol=1e-3)



def _via_kernel_operands(dw):
    """DecodeWeights rebuilt from the operands kernel B reads
    (kernel_operands_inverse): W_ih[1], W_hh, W1p and W2.  Layer 0's
    embedding, W_ih and bias reach the kernel only as eproj, which
    test_kernel_operands_inverse holds to embed . W_ih[0] + b[0] bit for
    bit, so they stay the plain ones."""
    w_ih1, w_hh, w1p, w2 = dc.kernel_operands_inverse(dc.kernel_operands(dw, dc.UP),
                                                      dw.w2.shape[1])
    w_ih = torch.stack([dw.w_ih[0], w_ih1])
    return dataclasses.replace(dw, w_ih=w_ih, w_hh=w_hh, w1p=w1p, w2=w2)


@pytest.mark.parametrize("width", ["narrow", "full"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_twin_from_kernel_operands_matches_pallas(dtype, width):
    """The twin on weights recovered from kernel B's per-block, fragment-
    ordered operands against the JAX Pallas step, with the tolerances of
    test_decode_step_reference_matches_pallas: the layout loses nothing."""
    _step_against_pallas(dtype, width, _via_kernel_operands)


@pytest.mark.parametrize("UP,P,J", [(4, 64, 64), (4, 320, 512), (8, 640, 512)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_operands_inverse(dtype, UP, P, J):
    """kernel_operands' inverse gives W_ih[1], W_hh, W1p and W2 back bit
    for bit, and each per-block operand holds the columns its pass needs:
    whh the gate columns of units b UP .. b UP + UP - 1 of W_hh per layer;
    w1 those of W_ih[1] and then W_hh[0] (layer 1's pass on layer 0's h');
    w2 W1p's columns b UJ .. and W_hh[1]'s (the joint's pass on layer 1's
    h'), zeros where the block owns none; eproj embed . W_ih[0] + b[0] for
    every embedding row and b[0] for SOS."""
    wdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    rng = np.random.RandomState(P + UP)
    L, V = 2, 29
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    dw = dc.DecodeWeights(
        embed=r(V - 1, P).to(wdt), w_ih=r(L, P, 4 * P).to(wdt), w_hh=r(L, P, 4 * P).to(wdt),
        b=r(L, 4 * P), w1p=r(P, J).to(wdt), b1=r(J), w2=r(J, V).to(wdt), b2=r(V))
    ops = dc.kernel_operands(dw, UP)
    for got, want in zip(dc.kernel_operands_inverse(ops, V),
                         (dw.w_ih[1], dw.w_hh, dw.w1p, dw.w2)):
        assert torch.equal(got, want)
    plain = [cuda_build.b_fragments_inverse(t) if dtype == "bf16" else t for t in ops[:3]]
    whh, w1, w2 = plain
    nbp, nbj, uj = P // UP, J // dc.UJ, dc.UJ
    col = lambda w, b, u, g: w[:, g * P + b * UP + u]
    for b in (0, nbp - 1):
        perm = cuda_build.gate_columns(UP, wdt)
        for c in (0, 4 * UP - 1):
            u, g = divmod(int(perm[c]), 4)
            for l in range(L):
                assert torch.equal(whh[b, l, :, c], col(dw.w_hh[l], b, u, g))
        perm = cuda_build.gate_columns(2 * UP, wdt)
        for c in range(8 * UP):
            v, g = divmod(int(perm[c]), 4)
            want = col(dw.w_ih[1], b, v, g) if v < UP else col(dw.w_hh[0], b, v - UP, g)
            assert torch.equal(w1[b, :, c], want)
    perm = dc._joint_columns(UP, wdt)
    for b in range(w2.shape[0]):
        for c in range(uj + 4 * UP):
            x = int(perm[c])
            if x < uj:
                want = dw.w1p[:, b * uj + x] if b < nbj else torch.zeros(P, dtype=wdt)
            else:
                u, g = divmod(x - uj, 4)
                want = col(dw.w_hh[1], b, u, g) if b < nbp else torch.zeros(P, dtype=wdt)
            assert torch.equal(w2[b, :, c], want)
    table = torch.cat([dw.embed.float() @ dw.w_ih[0].float() + dw.b[0], dw.b[0][None]])
    assert torch.equal(ops[4].permute(1, 3, 0, 2).reshape(V, 4 * P), table)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plan_units_and_refusals(dtype):
    """plan: P=320, J=512 on 132 SMs takes UP=4 (80 prediction blocks, 64
    joint blocks) up to N=1024 lanes and beyond; P=64 takes UP=4; P or J
    not a multiple of 64, more than 32 labels, other than two prediction
    layers, more blocks than SMs (P=640 needs 160) or more lanes than
    shared memory holds raise ValueError."""
    wdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert dc.plan(320, 512, 29, 1024, 2, wdt, 132)[0] == 4
    assert dc.plan(64, 64, 29, 1, 2, wdt, 132)[0] == 4
    for args, msg in [((96, 512, 29, 8), "multiples of 64"), ((320, 500, 29, 8), "multiples of 64"),
                      ((320, 512, 40, 8), "labels"), ((320, 512, 29, 8192), "shared memory"),
                      ((640, 512, 29, 8), "blocks")]:
        with pytest.raises(ValueError, match=msg):
            dc.plan(*args, 2, wdt, 132)
    with pytest.raises(ValueError, match="two prediction layers"):
        dc.plan(320, 512, 29, 8, 3, wdt, 132)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-6), ("bf16", 4e-3)])
def test_prediction_step_and_joint_match_jax(dtype, atol):
    """models/rnnt.py prediction_step (SOS embeds to zeros) and joint against
    the JAX functions.  Tolerance: f32 1e-6 (summation order); bf16 4e-3,
    one bf16 step below 1, since an f32 sum that lands on a bf16 rounding
    boundary may round either way in the two libraries."""
    jw, tw = _both(13, dtype)
    rng = np.random.RandomState(8)
    N, P = 6, 32
    tokens = np.array([-1, 0, 5, 27, 13, -1], np.int32)
    hg = np.asarray(jnp.asarray(rng.randn(2, N, P) * 0.5).astype(DTYPES[dtype]))
    cg = (rng.randn(2, N, P) * 0.5).astype(np.float32)
    f = rng.randn(N, 64).astype(np.float32)
    wdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jmodel.prediction_step(jw, jnp.asarray(tokens), jnp.asarray(hg), jnp.asarray(cg), JP)
    got = tmodel.prediction_step(
        tw, torch.from_numpy(tokens), torch.from_numpy(hg.astype(np.float32)).to(wdt),
        torch.from_numpy(cg), TP,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w).astype(np.float32), atol=atol)
    want = jmodel.joint(jw, jnp.asarray(f), want[0])
    got = tmodel.joint(tw, torch.from_numpy(f), got[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.fixture(scope="module")
def decode_inputs():
    rng = np.random.RandomState(7)
    T, N = 10, 8
    feats = rng.randn(T, N, 240).astype(np.float32)
    flens = np.array([10, 9, 7, 6, 4, 3, 1, 0], np.int32)  # one zero-length lane
    return feats, flens


@pytest.fixture(scope="module")
def jax_decode(decode_inputs):
    """(dtype, split_len) -> the JAX decode's (res, lens) under both of its
    step implementations, which must agree; each computed once."""
    feats, flens = decode_inputs
    cache = {}

    def get(dtype, split_len):
        if (dtype, split_len) not in cache:
            cache[dtype, split_len] = _jax_decode(feats, flens, dtype, split_len)
        return cache[dtype, split_len]

    return get


def _jax_decode(feats, flens, dtype, split_len):
    jw, _ = _both(11, dtype)
    want = None
    try:
        for impl in ("xla", "pallas"):
            jdec.set_decode_impl(impl)
            res, lens = jdec.greedy_decode(
                jw, jnp.asarray(feats), jnp.asarray(flens), params=JP, split_len=split_len
            )
            got = (np.asarray(res), np.asarray(lens))
            if want is None:
                want = got
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
    finally:
        jdec.set_decode_impl("xla")
    return want


# iterations per finish check: 1, 2, 3, the default, and max_iters of one
# chunk (T2 * 31 + 1: the whole symbol loop in one call)
@pytest.mark.parametrize("ks", ["1,2,3", "16", "max"])
@pytest.mark.parametrize("split_len", [-1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_greedy_decode_matches_jax(decode_inputs, jax_decode, dtype, split_len, ks):
    """Tokens and lengths equal to the JAX decode under both of its step
    implementations (XLA body and Pallas kernel in interpret mode), at the
    symbol cap 30, for K iterations between finish checks."""
    feats, flens = decode_inputs
    _, tw = _both(11, dtype)
    want = jax_decode(dtype, split_len)
    assert want[1][-1] == 0  # the zero-length lane emits nothing
    T2 = -(-(feats.shape[0] if split_len == -1 else split_len) // TP.stack_time_factor)
    max_iters = T2 * (TP.max_symbols_per_step + 1) + 1
    for k in ([max_iters] if ks == "max" else map(int, ks.split(","))):
        res, lens = greedy_decode(
            tw, torch.from_numpy(feats), torch.from_numpy(flens), TP,
            split_len=split_len, steps_per_check=k,
        )
        np.testing.assert_array_equal(lens.numpy(), want[1])
        np.testing.assert_array_equal(res.numpy(), want[0])


def test_kernel_phase_probes_match_sources():
    """The phase-profile tool (rnnt_inference_tpu_torch/tools/kernel_phases.py)
    finds each of its anchors exactly once in kernels A, B and C and their
    shared header, so its stamps land where its segment names say, and its
    edits only add stamp lines: the profiled kernels are the real ones."""
    from rnnt_inference_tpu_torch.tools import kernel_phases as kp

    probe = ("STAMP", "g_base", "g_it")
    for name, edits in (("hopper.cuh", kp.HEADER), ("decode_step.cu", kp.DECODE),
                        ("lstm_scan.cu", kp.SCAN), ("quant_lstm.cu", kp.QUANT)):
        patched = kp._patch((cuda_build.CSRC / name).read_text(), edits)
        assert patched.count("STAMP(") >= (1 if name == "hopper.cuh" else 3)
        for anchor, stamped in edits:  # the stamps only add lines or a prefix
            kept = [l for l in stamped.split("\n") if not any(w in l for w in probe)]
            assert stamped.endswith(anchor) or kept == anchor.split("\n"), anchor


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_twin_summed_in_halves_is_the_same_function(dtype):
    """tools/decode_divergence.summed_in_halves (the twin's products summed
    in two halves of K: a second plain version of kernel B's function) is
    the same product within f32 rounding (2 K eps sum|a||b|) and the same greedy
    decode at these widths; the plain sum is back after the block."""
    from rnnt_inference_tpu_torch.tools.decode_divergence import summed_in_halves

    _, tw = _both(3, dtype)
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(24, 4, 240).astype(np.float32))
    flens = torch.tensor([24, 17, 9, 0], dtype=torch.int32)
    a, b = torch.from_numpy(rng.randn(8, 320).astype(np.float32)), \
        torch.from_numpy(rng.randn(320, 64).astype(np.float32))
    want = greedy_decode(tw, feats, flens, TP)
    plain = dc.dot_f32
    with summed_in_halves():
        assert dc.dot_f32 is not plain
        # two f32 sums of the same K terms: within 2 K eps sum|a||b| of each other
        bound = 2 * a.shape[1] * torch.finfo(torch.float32).eps * (a.abs() @ b.abs())
        assert bool(((dc.dot_f32(a, b) - plain(a, b)).abs() <= bound).all())
        got = greedy_decode(tw, feats, flens, TP)
    assert dc.dot_f32 is plain
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
