"""Kernel E's module (ops/projection_cuda.py) on the CPU: the plain twin
against today's formulas bit for bit, the choice between kernel and twin,
the weight layout the kernel reads, and the wiring of the main path's
products through ``project``.  The kernel itself runs on the card
(chip_smoke.py phase ``projection``)."""

import numpy as np
import pytest
import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import decoder
from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights, init_weights
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.ops import lstm as tl
from rnnt_inference_tpu_torch.ops import projection_cuda as pc
from rnnt_inference_tpu_torch.runtime.offline import launch_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers

# (M, K, N): the encoder's K = 240 with ragged M, the joint's N = 512, an
# odd N (W2's 29), K off a multiple of 8, and no rows
SHAPES = [(16, 240, 64), (37, 240, 96), (5, 64, 512), (9, 32, 29), (7, 20, 24), (0, 240, 64)]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _operands(M, K, N, dtype, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
    return t(M, K), t(K, N) / np.sqrt(K), t(N)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_cpu_takes_the_plain_product(M, K, N, dtype):
    """On CPU tensors ``project`` without a bias is dot_f32's product bit for
    bit, f32 out, and launches nothing."""
    a, w, _ = _operands(M, K, N, DTYPES[dtype])
    before = pc.project_cuda.launches
    got = pc.project(a, w)
    assert pc.project_cuda.launches == before
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, torch.matmul(a.float(), w.float()))
    assert torch.equal(got, tl.dot_f32(a, w))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_bias_epilogue_twin_is_the_projection_formula(M, K, N, dtype):
    """With a bias the twin is lstm_layer's former projection, (dot_f32(x, w)
    + b.float()) rounded once to the weights' dtype, bit for bit; without
    one it returns f32 sums with no bias (epilogue b)."""
    a, w, b = _operands(M, K, N, DTYPES[dtype], seed=1)
    got = pc.project_reference(a, w, b)
    assert got.dtype == DTYPES[dtype]
    assert torch.equal(got, (tl.dot_f32(a, w) + b.float()).to(DTYPES[dtype]))
    assert torch.equal(pc.project(a, w, b), got)
    plain = pc.project_reference(a, w)
    assert plain.dtype == torch.float32 and torch.equal(plain, tl.dot_f32(a, w))


def test_leading_dims_and_one_dimensional_a():
    """a {T, N, K} and a {K} keep their leading dims, as torch.matmul does."""
    a, w, b = _operands(12, 16, 8, torch.bfloat16, seed=2)
    a3 = a.reshape(3, 4, 16)
    assert torch.equal(pc.project(a3, w, b), pc.project(a, w, b).reshape(3, 4, 8))
    assert torch.equal(pc.project(a[0], w), tl.dot_f32(a[0], w))


class _Stand:
    """A stand-in operand for the dispatch: only what ``project`` reads."""

    def __init__(self, cuda, dtype, ndim=2):
        self.is_cuda, self.dtype, self._ndim = cuda, dtype, ndim

    def dim(self):
        return self._ndim


@pytest.mark.parametrize("cuda,da,dw,ndim,impl,kernel", [
    (True, torch.bfloat16, torch.bfloat16, 2, None, True),
    (True, torch.bfloat16, torch.bfloat16, 2, "reference", False),
    (True, torch.float32, torch.float32, 2, None, False),
    (True, torch.float32, torch.bfloat16, 2, None, False),
    (True, torch.bfloat16, torch.float32, 2, None, False),
    (True, torch.bfloat16, torch.bfloat16, 3, None, False),
    (False, torch.bfloat16, torch.bfloat16, 2, None, False),
    (False, torch.float32, torch.float32, 2, None, False),
])
def test_dispatch_sends_only_bf16_card_operands_to_kernel_e(monkeypatch, cuda, da, dw, ndim,
                                                            impl, kernel):
    """bf16 operands on the card go to kernel E unless impl="reference";
    f32 or mixed operands, CPU tensors and batched weights never do."""
    calls = []
    monkeypatch.setattr(pc, "project_cuda", lambda a, w, b=None: calls.append("kernel"))
    monkeypatch.setattr(pc, "project_reference", lambda a, w, b=None: calls.append("twin"))
    pc.project(_Stand(cuda, da), _Stand(cuda, dw, ndim), None, impl)
    assert calls == ["kernel" if kernel else "twin"]
    with pytest.raises(ValueError, match="impl"):
        pc.project(_Stand(cuda, da), _Stand(cuda, dw, ndim), None, "pallas")


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """project_cuda raises for CPU tensors; the CPU launches nothing."""
    a, w, b = _operands(4, 16, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pc.project_cuda(a, w, b)


@pytest.mark.parametrize("K", [240, 20, 1])
def test_weight_operand_is_the_padded_transpose_kept_per_weight(K):
    """The kernel's B operand is w^T {N, K8} with zero columns up to a
    multiple of 8, made once per weight and made again after an in-place
    change of w."""
    _, w, _ = _operands(1, K, 24, torch.bfloat16, seed=3)
    op = pc.weight_operand(w)
    K8 = -(-K // 8) * 8
    assert op.shape == (24, K8) and op.is_contiguous() and op.dtype == torch.bfloat16
    assert torch.equal(op[:, :K], w.t()) and not op[:, K:].any()
    assert pc.weight_operand(w) is op
    w.add_(1)
    again = pc.weight_operand(w)
    assert again is not op and torch.equal(again[:, :K], w.t())


def test_projection_is_a_counted_kernel():
    """Kernel E's launches reach every runner's count as "projection"."""
    counts = launch_counts()
    assert "projection" in counts and counts["projection"] == pc.project_cuda.launches


def _spy(monkeypatch):
    seen = []
    real = pc.project

    def spy(a, w, b=None, impl=None):
        seen.append((tuple(w.shape), b is not None, impl))
        return real(a, w, b, impl)

    monkeypatch.setattr(pc, "project", spy)
    return seen


@pytest.mark.parametrize("impl", [None, "reference"])
def test_float_layers_project_through_kernel_e_s_entry(monkeypatch, impl):
    """lstm_layer and lstm_layer_tp take their projection from ``project``
    with the bias and the caller's impl, and their numbers are the former
    formula's: (dot_f32(x, W_ih) + b) in bf16, then the recurrence."""
    rng = np.random.RandomState(4)
    T, N, IC, H = 3, 2, 16, 8
    w = lambda *s: torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32)).to(
        torch.bfloat16)
    layer = LSTMLayerWeights(w(IC, 4 * H), w(H, 4 * H), w(4 * H))
    x = torch.from_numpy(rng.randn(T, N, IC).astype(np.float32))
    h0, c0 = torch.zeros(N, H), torch.zeros(N, H)
    seen = _spy(monkeypatch)
    got = tl.lstm_layer(layer, x, h0, c0, impl)
    assert seen == [((IC, 4 * H), True, impl)]
    xw = (tl.dot_f32(x.to(torch.bfloat16), layer.w_ih) + layer.b.float()).to(torch.bfloat16)
    want = tl.lstm_recurrence(xw, layer.w_hh, h0.to(torch.bfloat16), c0)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    seen.clear()
    tl.lstm_layer_tp([layer], [x], [h0], [c0], impl)
    assert seen == [((IC, 4 * H), True, impl)]


@pytest.mark.parametrize("impl", [None, "reference"])
def test_decode_projects_fproj_and_eproj_through_kernel_e_s_entry(monkeypatch, impl):
    """The symbol loop's fproj goes through ``project`` with no bias and the
    caller's impl; kernel B's set-up eproj too (its operands are built for
    the kernel alone)."""
    params = RNNTParams(trans_hidden_size=64, pred_hidden_size=32, joint_hidden_size=32,
                        max_res_len=16)
    weights = init_weights(params, torch.Generator().manual_seed(5), dtype=torch.bfloat16,
                           device="cpu")
    seen = _spy(monkeypatch)
    x = torch.randn((6, 2, params.trans_input_size), generator=torch.Generator().manual_seed(6))
    decoder.greedy_decode(weights, x, torch.tensor([6, 4]), params, impl=impl)
    assert ((64, 32), False, impl) in seen
    seen.clear()
    dc.kernel_operands(dc.decode_weights(weights), dc.UP)
    assert seen == [((32, 128), False, None)]
