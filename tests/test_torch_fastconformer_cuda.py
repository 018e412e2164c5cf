"""The streaming FastConformer's kernels against their plain twins, on the
card, at the cell's widths (128 slots, 8 heads of 64, chunks of 14 rows,
a ring of 6 chunks; 9 taps over 512 channels): kernel F's streaming form
and kernel G's causal form, then ServerRunner on the kernels and on the
twins, each judged by the benchmark's plain reference.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
check runs inside a fixture, never at import).  On a GPU machine:
    python -m pytest tests/test_torch_fastconformer_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rnnt_inference_tpu_torch.ops import attention_cuda as ac
from rnnt_inference_tpu_torch.ops import depthwise_cuda as dg

pytestmark = pytest.mark.cuda

N, H, DH, C, R = 128, 8, 64, 14, 6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def stream_case(dev, seed=0, pos=3):
    """q as a column slice of one (N C, 3 H d) bf16 product, a filled ring,
    the band, u and v_b, and per slot a chunk index and an encoder length:
    slots idle (length 0), at their first chunk, past the ring's reach, and
    ending inside this chunk."""
    g = torch.Generator().manual_seed(seed)
    D = H * DH
    qkv = torch.randn((N * C, 3 * D), generator=g).to(dev, torch.bfloat16)
    kv = torch.randn((N, R, C, 2 * D), generator=g).to(dev, torch.bfloat16)
    band = torch.randn(((R + 1) * C - 1, D), generator=g).to(dev, torch.bfloat16)
    u, vb = (0.1 * torch.randn((H, DH), generator=g)).to(dev), (0.1 * torch.randn(
        (H, DH), generator=g)).to(dev)
    rng = np.random.RandomState(seed)
    chunk = rng.randint(0, 14, N)
    enc = np.minimum(189, C * chunk + rng.randint(1, 40, N))
    chunk[:4], enc[:4] = [0, 0, 13, 5], [0, 3, 189, 5 * C + 1]
    enc[4:8] = 0  # idle slots
    to = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    return qkv[:, :D], kv, band, u, vb, to(chunk), to(enc), pos


def test_rel_attention_stream_kernel_matches_twin(dev):
    """Kernel F's streaming form against its twin, one launch: the kernel
    rounds each unnormalized probability to bf16 before the product with v
    (2^-8 of the twin run on |v| allowed, as the full form) and both round
    the output to bf16 (2^-7 of |out|); idle slots read zeros."""
    case = stream_case(dev)
    before = ac.rel_attention_stream_cuda.launches
    got = ac.rel_attention_stream(*case)
    assert ac.rel_attention_stream_cuda.launches == before + 1
    want = ac.rel_attention_stream(*case, impl="reference")
    q, kv, *rest = case
    absv = ac.rel_attention_stream(q, torch.cat([kv[..., : H * DH], kv[..., H * DH :].abs()], -1),
                                   *rest, impl="reference").float()
    torch.cuda.synchronize()
    over = (got.float() - want.float()).abs() - (2 ** -7 * want.float().abs() + 2 ** -8 * absv
                                                  + 1e-6)
    assert float(over.max()) <= 0, float(over.max())
    assert not bool(got.view(N, C, -1)[4:8].any())


def test_depthwise_causal_kernel_matches_twin(dev):
    """Kernel G's causal form against its twin, twice in a row on the same
    cache: the convolution and the LayerNorm in f32 in another order (one
    bf16 ulp of the output allowed, 2^-7 of its size, and 1e-3 of the
    LayerNorm's unit scale for its statistics), and the cache rewritten
    with the chunk's last 8 rows exactly."""
    g = torch.Generator().manual_seed(3)
    D, K = 512, 9
    w = (torch.randn((K, D), generator=g) / 3).to(dev, torch.bfloat16)
    b, lg, lb = (torch.randn(D, generator=g).to(dev) for _ in range(3))
    cache = torch.randn((N, K - 1, D), generator=g).to(dev, torch.bfloat16)
    twin_cache = cache.clone()
    for step in range(2):
        x = torch.randn((N * C, D), generator=g).to(dev, torch.bfloat16)
        before = dg.depthwise_causal_cuda.launches
        got = dg.depthwise_causal(x, cache, w, b, lg, lb, 1e-5)
        assert dg.depthwise_causal_cuda.launches == before + 1
        want = dg.depthwise_causal(x, twin_cache, w, b, lg, lb, 1e-5, impl="reference")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        assert float((err - 2 ** -7 * want.float().abs() - 1e-3).max()) <= 0, step
        assert torch.equal(cache, twin_cache) and torch.equal(cache, x.view(N, C, D)[:, -8:])


def test_server_on_kernels_and_on_twins_serve_the_reference(dev):
    """ServerRunner on the streaming FastConformer at the cell's widths (17
    blocks, 16 slots, 24 utterances of 1-6 s at cap 10, slots reused), on
    the kernels and on the plain twins on the card (impl="reference"), each
    run's tokens judged as the benchmark judges a run (benchmark/check.py
    against the plain reference): their mean widest logit gap below 0.01
    (on these untrained weights near ties leave gaps of about 1e-3 in
    either run, and a parting at a near tie changes the rest of an answer,
    so the two runs' tokens differ; one wrong token among 24 answers costs
    tenths), and the streaming kernels' launches counted, one of each a
    block a step."""
    import json
    from pathlib import Path

    from benchmark import check
    from benchmark.models import load
    from rnnt_inference_tpu_torch.runtime.offline import launch_counts, launches_since
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner

    repo = Path(__file__).resolve().parents[1]
    model = load("fastconformer_streaming", repo)
    cfg = json.loads((repo / "benchmark" / "configs" /
                      "nemo_fastconformer_transducer_large_streaming.json").read_text())
    w = model.apply_emission(model.random_weights(cfg, dev),
                             dict(model="blank", amp=1.0, delta=0.75), cfg)
    served, params, fz = model.program(cfg, w, dev, 10)
    rng = np.random.RandomState(2)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in rng.randint(16000, 96000, 24)]
    for impl in (None, "reference"):
        r = ServerRunner(served, params, fz, slots=16, split_len=112, insert_batch=8,
                         steps_per_dispatch=1, device=dev, impl=impl)
        pending, got, steps = list(range(len(wavs))), {}, 0
        before = launch_counts()
        while pending or r.n_active:
            k = min(len(r.free_slots), r.insert_batch, len(pending))
            if k:
                r.insert_samples([wavs[i] for i in pending[:k]], pending[:k])
                pending = pending[k:]
            fin = r.step()
            steps += 1
            if len(fin):
                got.update(r.extract(fin))
        n = launches_since(before)
        blocks = 0 if impl else 17 * steps
        assert n["attention_stream"] == n["depthwise_causal"] == blocks
        tokens = [got[i] for i in range(len(wavs))]
        assert sum(len(t) for t in tokens) > 0
        gaps = check.gaps(cfg, w, 10, wavs, tokens, dev, model)
        assert check.mean_gap(gaps) < 0.01, (impl, gaps)
