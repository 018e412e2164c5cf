"""The Conformer's kernels against their plain twins, on the card: kernel F
(relative-position attention) at the published widths over a mix of
lengths, kernel B's wide-vocabulary instantiation (one prediction layer,
P = J = 640, V = 1,025) bucketed and packed, and the packed runner with
its kernels against the runner on its twins.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip
elsewhere (the check runs inside a fixture, never at import).  On a GPU
machine:
    python -m pytest tests/test_torch_conformer_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rnnt_inference_tpu_torch.config import ConformerParams
from rnnt_inference_tpu_torch.models import conformer
from rnnt_inference_tpu_torch.ops import attention_cuda as ac
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.tools.decode_divergence import (compare_k_launch,
                                                               wide_parting_explained)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def attention_case(dev, lens, H=8, d=64, seed=0):
    """q, k, v as column slices of one (R, 3 H d) bf16 product in the varlen
    layout of ``lens``, u and v_b, the projected positions and the segments."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    starts, R = conformer.varlen_layout(lens)
    seg = ac.Segments.of(starts, lens, dev)
    qkv = torch.randn((R, 3 * H * d), generator=g).to(dev, torch.bfloat16)
    u, vb = (0.1 * torch.randn((H, d), generator=g)).to(dev), (0.1 * torch.randn((H, d),
                                                                               generator=g)).to(dev)
    pos = torch.randn((2 * seg.t_max - 1, H * d), generator=g).to(dev, torch.bfloat16)
    D = H * d
    return (qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :], u, vb, pos, seg)


def f_tolerance(case, want):
    """Kernel F's bound on |kernel - twin|, element by element: the kernel
    rounds each unnormalized probability to bf16 before the product with v
    (2^-9 of each term of sum_j p_ij |v_j| / l_i, doubled for margin: 2^-8
    of the twin run on |v|); both round the output to bf16 (one ulp of it,
    2^-7 of |out|); the products' sums in another order and exp2 for exp
    add f32 roundings (1e-6)."""
    q, k, v, u, vb, pos, seg = case
    absv = ac.rel_attention(q, k, v.abs(), u, vb, pos, seg, impl="reference").float()
    return 2 ** -7 * want.float().abs() + 2 ** -8 * absv + 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_rel_attention_kernel_matches_twin(dev, seed):
    """Kernel F against its twin at the published widths (8 heads of 64)
    over 40 utterances of 1 to 376 frames (both ends among them), one
    launch; the rows no utterance owns stay zero."""
    rng = np.random.RandomState(seed)
    lens = np.concatenate([[1, 376, 64, 65], rng.randint(1, 377, 36)])
    case = attention_case(dev, lens, seed=seed)
    before = ac.rel_attention_cuda.launches
    got = ac.rel_attention(*case)
    assert ac.rel_attention_cuda.launches == before + 1
    want = ac.rel_attention(*case, impl="reference")
    torch.cuda.synchronize()
    over = (got.float() - want.float()).abs() - f_tolerance(case, want)
    assert float(over.max()) <= 0, float(over.max())
    seg = case[-1]
    gaps = conformer.gap_mask(seg.starts.cpu().numpy(), seg.lens_host, got.shape[0], dev)
    assert not bool(got[gaps].any())


@pytest.mark.parametrize("R", [1, 5000, 1705675])
def test_depthwise_kernel_matches_twin(dev, R):
    """Kernel G against its twin at the published widths (512 channels, 31
    taps) over varlen rows (utterances of 1 to 376 frames with their gaps,
    up to a rep's 1.7 M rows): the same f32 function summed in another
    order, the output rounded once to bf16 (one bf16 ulp allowed, 2^-7 of
    the output's size), gap rows read as zeros: an utterance next to a
    garbage-filled gap gives what it gives next to zeros."""
    from rnnt_inference_tpu_torch.ops import depthwise_cuda as dg

    rng = np.random.RandomState(R)
    lens = rng.randint(1, 377, max(1, R // 200))
    starts, rows = conformer.varlen_layout(lens)
    gaps = conformer.gap_mask(starts, lens, rows, dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((rows, 512), generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((31, 512), generator=g) / 5).to(dev, torch.bfloat16)
    b = torch.randn(512, generator=g).to(dev)
    before = dg.depthwise_silu_cuda.launches
    got = dg.depthwise_silu(x, gaps, w, b)
    assert dg.depthwise_silu_cuda.launches == before + 1
    want = dg.depthwise_silu(x, gaps, w, b, impl="reference")
    clean = dg.depthwise_silu(x.masked_fill(gaps[:, None], 0), gaps, w, b)
    torch.cuda.synchronize()
    own = ~gaps
    err = (got.float() - want.float()).abs()[own]
    assert float((err - want.float().abs()[own] * 2 ** -7).max()) <= 1e-6
    assert torch.equal(got[own], clean[own])


def wide_case(dev, N, P=640, J=640, V=1025, seed=5, packed=False, ties=False):
    """Kernel B's wide-vocabulary case: one bf16 prediction layer of P, a
    joint of J over V labels and N lanes in random states over T2 = 6
    frames, as decode_divergence.decode_case; ``ties`` copies label 300's
    W2 column and bias to labels 302 and 700 and raises them, so lanes pick
    among exact ties."""
    params = ConformerParams(pred_hidden_size=P, joint_hidden_size=J, num_labels=V, BLANK=V - 1,
                             max_res_len=128, max_symbols_per_step=10)
    g = torch.Generator().manual_seed(seed)
    u = lambda *shape, k: ((torch.rand(shape, generator=g) * 2 - 1) * k)
    w2, b2 = u(J, V, k=J ** -0.5), u(V, k=J ** -0.5)
    if ties:
        for v in (302, 700):
            w2[:, v], b2[v] = w2[:, 300], b2[300]
        b2[[300, 302, 700]] += 3.0
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    dw = dc.DecodeWeights(embed=bf(torch.randn((V - 1, P), generator=g)),
                          w_ih=bf(u(1, P, 4 * P, k=P ** -0.5)), w_hh=bf(u(1, P, 4 * P, k=P ** -0.5)),
                          b=u(1, 4 * P, k=P ** -0.5).to(dev), w1p=bf(u(P, J, k=(2 * P) ** -0.5)),
                          b1=u(J, k=0.05).to(dev), w2=bf(w2), b2=b2.to(dev))
    T2, R = 6, params.max_res_len
    rng = np.random.RandomState(seed)
    f_lens = rng.randint(0, T2 + 1, N)
    eos = np.maximum(f_lens - 1, 0)
    lanes = np.stack([
        rng.randint(-1, V - 1, N), np.minimum(rng.randint(0, T2, N), eos),
        rng.choice([0, 3, 10], N), rng.choice([-1, 5, R - 1], N), f_lens == 0,
        f_lens, eos, np.zeros(N),
    ]).astype(np.int32)
    fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32)).to(dev)
    hg = torch.from_numpy(rng.randn(1, N, P).astype(np.float32) * 0.5).to(dev, torch.bfloat16)
    cg = torch.from_numpy(rng.randn(1, N, P).astype(np.float32) * 0.5).to(dev)
    res = torch.full((N, R), -1, dtype=dc.token_dtype(V), device=dev)
    case = (params, dw, fproj, [torch.from_numpy(lanes).to(dev), hg, cg, res])
    if not packed:
        return case
    rng = np.random.RandomState(seed + 1)
    starts = rng.rand(T2, N) < 0.5
    starts[0] = True
    rb = np.maximum(lanes[dc.RES_IDX] - rng.randint(0, 10, N), -1)
    return case + (torch.from_numpy(starts).to(dev),
                   torch.from_numpy(rb.astype(np.int32)).to(dev))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["bucketed", 0, 4])
@pytest.mark.parametrize("N", [1, 64, 1024])
def test_decode_wide_kernel_parts_from_twin_only_at_near_ties(dev, N, mode, ties):
    """The wide instantiation at P = J = 640, V = 1,025 against its twin
    (tools/decode_divergence.py compare_k_launch): one launch of K = 8
    iterations against 8 twin iterations from the same state, bucketed and
    packed (utterance budget 0 and 4).  Two launches agree bit for bit;
    lanes that never part end within kernel B's per-step tolerances (hg
    2^-8, cg 1e-3); a lane parts only at a tie (decode_divergence
    .wide_parting_explained: the twin given the kernel's own state chooses
    the kernel's symbol, or from the same state the twin's gap is within
    the product-tie tolerance, or it is within how far the logits move
    between the two states; over 1,024 random logits the top two often lie
    closer than one bf16 rounding of z moves them).  The tokens are int16; with ties, no emission is 302 or 700,
    the exact copies of label 300: the first maximum wins."""
    packed = mode != "bucketed"
    case = wide_case(dev, N, packed=packed, ties=ties)
    params, dw, fproj, state = case[:4]
    starts, rb = case[4:] if packed else (None, None)
    budget = mode if packed else 0
    before = dc.decode_step_cuda.launches
    r = compare_k_launch(fproj, state, dw, params, 8, starts, rb, budget)
    assert dc.decode_step_cuda.launches > before
    assert r["deterministic"] and r["end_drift_within_tolerance"], r
    assert all(wide_parting_explained(lane) for lane in r["lanes"]), r["lanes"][:8]
    s = [t.clone() for t in state]
    dc.decode_step_cuda(fproj, *s, dw, params, 8, starts, None if rb is None else rb.clone(),
                        budget)
    toks = s[3][s[3] >= 0]
    assert s[3].dtype == torch.int16
    if ties:
        assert not bool(((toks == 302) | (toks == 700)).any())
        assert N < 64 or bool((toks == 300).any())


def test_conformer_runner_kernels_match_twins(dev):
    """The packed runner on a two-block Conformer at the published widths
    (random weights, blank not raised): with kernels E, F and B
    on the card, and on the twins (impl="reference"), 12 utterances on 3
    lanes at cap 10, each run's tokens judged as the benchmark judges a
    run (benchmark/check.py against the plain reference): their mean
    widest logit gap below 0.01 (on these untrained two-block weights near
    ties leave gaps of about 1e-3 in either run; one wrong token among 12
    answers costs tenths), and each kernel's launches counted."""
    from benchmark import check
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    from test_torch_conformer import MODEL, tiny_config  # the CPU tests' model module

    cfg = tiny_config(d_model=512, num_blocks=2, n_heads=8, conv_kernel_size=31,
                      conv_channels=512, pred_hidden_size=640, joint_hidden_size=640,
                      num_labels=1025, max_res_len=1024)
    w = MODEL.apply_emission(MODEL.random_weights(cfg, dev),
                             dict(model="blank", amp=1.0, delta=0.0), cfg)
    served, params, fz = MODEL.program(cfg, w, dev, 10)
    rng = np.random.RandomState(3)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in rng.randint(16000, 240000, 12)]
    store = SampleStore(kind="waveform", samples=wavs, transcripts=[""] * len(wavs))
    qsl = QuerySampleLibrary(store, fz, wav_buckets_s=[5.0, 10.0, 15.0])
    for impl in (None, "reference"):
        r = PackedOfflineRunner(served, params, fz, n_lanes=3, chunk_frames=16, batch_size=4,
                                decode_chunk=32, device=dev, impl=impl)
        r.stage(qsl)
        res = r.run_device()
        if impl is None:
            assert res.launches["attention"] == 2 and res.launches["depthwise"] == 2
            assert res.launches["decode_step"] > 0
            assert res.launches["projection"] > 0
        else:
            assert res.launches["attention"] == res.launches["depthwise"] == 0
            assert res.launches["decode_step"] == 0
        gaps = check.gaps(cfg, w, 10, wavs, res.tokens, dev, MODEL)
        assert sum(len(t) for t in res.tokens) > 0
        assert check.mean_gap(gaps) < 0.01, (impl, gaps)
