"""NeMo's cache-aware streaming FastConformer-Transducer on the CPU at a small
size (d_model 64, 2 heads, 2 blocks, 16 subsampling channels,
att_context_size [6, 2]: chunks of 3 encoder frames that see 2 chunks back,
conv kernel 5, P = J = 64, V = 40, seeded random weights), held to the
benchmark's plain reference, benchmark/reference/fastconformer_streaming.py,
which computes each utterance whole under the chunk mask and the causal
convolutions: the port's streaming encoder run chunk by chunk with its
caches, kernel F's streaming twin and kernel G's causal twin against their
plain formulas, and ServerRunner's tokens against the reference's greedy
decode, slots reused."""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.models import load
from rnnt_inference_tpu_torch.config import ConformerParams
from rnnt_inference_tpu_torch.models import fastconformer as fc
from rnnt_inference_tpu_torch.ops import attention_cuda as ac
from rnnt_inference_tpu_torch.ops import depthwise_cuda as dg
from rnnt_inference_tpu_torch.ops.features import log_mel_features
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.server import ServerRunner, StreamServerState
from rnnt_inference_tpu_torch.utils.profiler import REGISTRY, record_call

REPO = Path(__file__).resolve().parents[1]
MODEL = load("fastconformer_streaming", REPO)
SMALL = dict(d_model=64, num_blocks=2, n_heads=2, conv_kernel_size=5,
             subsampling_conv_channels=16, att_context_size=[6, 2], pred_hidden_size=64,
             joint_hidden_size=64, num_labels=40, max_res_len=128)
F32 = {"encoder": "f32", "prediction": "f32", "joint": "f32"}
# 1.0, 0.56, 0.27, 0.0625, 0.044, 0.75 s: 14, 8, 5, 2, 2 and 11 encoder frames,
# so utterances end inside a chunk of 3, one past the ring's reach (5 chunks
# against 3 kept), and two are shorter than one chunk
LENS = [16000, 9000, 4321, 1000, 700, 12007]


def tiny_config() -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "nemo_fastconformer_transducer_large_streaming.json").read_text())
    return dict(cfg, **SMALL)


@pytest.fixture(scope="module")
def case():
    cfg = tiny_config()
    w = MODEL.random_weights(cfg, "cpu")
    rng = np.random.RandomState(1)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in LENS]
    return cfg, w, wavs


def _feats(cfg, wavs):
    wav = torch.zeros((len(wavs), max(len(x) for x in wavs)))
    for i, x in enumerate(wavs):
        wav[i, : len(x)] = torch.from_numpy(x)
    return log_mel_features(wav, torch.tensor([len(x) for x in wavs]),
                            MODEL.program_featurizer(cfg))


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = 448.0 / t.abs().max().clamp(min=1e-30)
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


def test_streaming_params_and_lengths():
    """The streaming fields: three causal stride-2 stages (L -> L // 2 + 1,
    80 -> 11 bins), chunks of 14 frames that see 5 before; the full-context
    Large keeps its striding x4 lengths."""
    p = MODEL.program_params(json.loads((REPO / "benchmark" / "configs" /
                                         "nemo_fastconformer_transducer_large_streaming.json")
                                        .read_text()))
    assert (p.streaming, p.chunk_frames, p.left_chunks, p.sub_freq, p.sub_stages) == \
        (True, 14, 5, 11, 3)
    assert [p.encoded_len(n) for n in (0, 1, 2, 8, 112, 1501)] == [0, 1, 2, 2, 15, 189]
    assert fc.encoded_len(torch.tensor([0, 1, 112, 1501]), p).tolist() == [0, 1, 15, 189]
    assert fc.window_frames(p) == 119
    large = ConformerParams()
    assert not large.streaming and large.sub_freq == 20 and large.encoded_len(101) == 26


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_encoder_matches_reference_masked_forward(case, dtype):
    """The port's encoder, chunk by chunk with its caches (every utterance a
    slot), against the reference's full forward of each utterance under the
    chunk mask, at the same precision.  f32: both exact f32 programs of the
    same equations, apart by summation order (1.5e-6 measured of outputs of
    about 2.9; 1e-4 allowed).  bf16: the program rounds every product's
    output to bf16 where the reference keeps f32 until the next product's
    input, a few bf16 roundings through two blocks (0.010 measured; 0.04
    allowed).  A wrong mask, cache or window moves them by tenths; the
    encoder's products in fp8 exceed the bound (the next test)."""
    cfg, w, wavs = case
    prec = F32 if dtype == torch.float32 else cfg["precision"]
    ref = MODEL.reference(dict(cfg, precision=prec), w, "cpu")
    params = MODEL.program_params(cfg)
    got = fc.encode(fc.weights_from_dict(w, params, dtype), *_feats(cfg, wavs), params)
    want = ref.encode([torch.from_numpy(x) for x in wavs])
    tol = 1e-4 if dtype == torch.float32 else 0.04
    assert [g.shape[0] for g in got] == [14, 8, 5, 2, 2, 11]
    for g, r in zip(got, want):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) < tol


def test_fp8_products_fail_the_encoder_bound(case, monkeypatch):
    """The bf16 bound of the test above is no wider than it must be: the same
    encoder with every product's operands rounded through float8 e4m3 parts
    from the reference by more than 0.04."""
    from rnnt_inference_tpu_torch.models import conformer
    from rnnt_inference_tpu_torch.ops import projection_cuda

    cfg, w, wavs = case
    plain = projection_cuda.project

    def fp8_project(a, wt, b=None, impl=None):
        return plain(_fp8(a), _fp8(wt), b, impl)

    for mod in (fc, conformer):
        monkeypatch.setattr(mod, "project", fp8_project)
    ref = MODEL.reference(cfg, w, "cpu")
    params = MODEL.program_params(cfg)
    got = fc.encode(fc.weights_from_dict(w, params, torch.bfloat16), *_feats(cfg, wavs), params)
    want = ref.encode([torch.from_numpy(x) for x in wavs])
    assert max(float((g - r).abs().max()) for g, r in zip(got, want)) > 0.04


def test_a_prefix_streams_to_the_same_frames(case):
    """Cache-aware streaming: an utterance cut after 4 chunks (8 C = 24 mel
    frames a chunk) gives, on the frames of its first 3 chunks, what the
    whole utterance gives (the 4th chunk's last frames read the cut's
    padding): nothing of the future reaches a frame before its chunk's end
    (1e-5 allowed: summation order over other row counts)."""
    cfg, w, wavs = case
    params = MODEL.program_params(cfg)
    wp = fc.weights_from_dict(w, params, torch.float32)
    feats, flens = _feats(cfg, wavs[:1])
    whole = fc.encode(wp, feats, flens, params)[0]
    cut = 4 * 24
    part = fc.encode(wp, feats[:cut], torch.tensor([cut]), params)[0]
    assert part.shape[0] == params.encoded_len(cut) == 13
    assert float((part[:9] - whole[:9]).abs().max()) < 1e-5


def _stream_case(seed, N=6, H=2, d=8, C=3, R=3):
    g = torch.Generator().manual_seed(seed)
    D = H * d
    q = torch.randn((N * C, D), generator=g)
    kv = torch.randn((N, R, C, 2 * D), generator=g)
    band = torch.randn(((R + 1) * C - 1, D), generator=g)
    u, vb = torch.randn((H, d), generator=g), torch.randn((H, d), generator=g)
    chunk = torch.tensor([0, 1, 2, 5, 7, 3], dtype=torch.int32)[:N]
    enc = torch.tensor([2, 5, 9, 17, 22, 0], dtype=torch.int32)[:N]
    return q, kv, band, u, vb, chunk, enc


@pytest.mark.parametrize("pos", [0, 2])
def test_rel_attention_stream_twin_matches_the_masked_formula(pos):
    """Kernel F's streaming twin against the chunked-limited attention
    written out per slot in f32: the slot's keys as a sequence (its chunks c
    - 2 .. c that exist, read from the ring at their places), scores ((q_i +
    u) k_j + (q_i + v_b) p(i - j)) / sqrt(d) over the keys of frames below
    the utterance's length, p(r) the band's row R C - 1 - r; a slot with no
    frame reads zeros (1e-5 allowed: summation order)."""
    q, kv, band, u, vb, chunk, enc = _stream_case(0)
    N, R, C, _ = kv.shape
    H, d = u.shape
    got = ac.rel_attention_stream(q, kv, band, u, vb, chunk, enc, pos)
    want = torch.zeros_like(q)
    for s in range(N):
        c, L = int(chunk[s]), int(enc[s])
        keys, kidx = [], []
        for m in range(R):
            cc = c - (R - 1) + m
            for r in range(C):
                if cc >= 0 and cc * C + r < L:
                    keys.append(kv[s, (pos - (R - 1) + m) % R, r])
                    kidx.append(cc * C + r)
        for i in range(C):
            if c * C >= L:
                continue
            for h in range(H):
                hs = slice(h * d, (h + 1) * d)
                qi = q[s * C + i, hs]
                sc = torch.stack([((qi + u[h]) @ kr[: H * d][hs]
                                   + (qi + vb[h]) @ band[R * C - 1 - (c * C + i - j), hs])
                                  / math.sqrt(d) for kr, j in zip(keys, kidx)])
                p = torch.softmax(sc, 0)
                want[s * C + i, hs] = sum(pk * kr[H * d :][hs] for pk, kr in zip(p, keys))
    assert float((got - want).abs().max()) < 1e-5
    assert not bool(got.view(N, C, -1)[5].any())


def test_depthwise_causal_twin_streams_the_whole_convolution():
    """Kernel G's causal twin, fed a sequence chunk by chunk (chunks of 3
    rows, 5 taps: the cache of 4 rows reaches past the last chunk) against
    the whole sequence's causal convolution (4 zeros before), bias,
    LayerNorm and Swish in f32 (1e-5 allowed: summation order); the cache
    ends holding the last 4 rows."""
    g = torch.Generator().manual_seed(2)
    N, T, C, K, D = 3, 12, 3, 5, 8
    x = torch.randn((N, T, D), generator=g)
    w, b = torch.randn((K, D), generator=g), torch.randn(D, generator=g)
    lg, lb = torch.randn(D, generator=g), torch.randn(D, generator=g)
    cache = torch.zeros((N, K - 1, D))
    got = torch.cat([dg.depthwise_causal(x[:, t : t + C].reshape(N * C, D), cache, w, b, lg, lb,
                                         1e-5).view(N, C, D) for t in range(0, T, C)], 1)
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :], b, groups=D)
    want = F.silu(F.layer_norm(y.transpose(1, 2), (D,), lg, lb, 1e-5))
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(cache, x[:, -(K - 1):])


def _serve(runner, wavs):
    pending, got = list(range(len(wavs))), {}
    while pending or runner.n_active:
        k = min(len(runner.free_slots), runner.insert_batch, len(pending))
        if k:
            runner.insert_samples([wavs[i] for i in pending[:k]], pending[:k])
            pending = pending[k:]
        fin = runner.step()
        if len(fin):
            got.update(runner.extract(fin))
    return got


@pytest.mark.parametrize("cap", [1, 10])
def test_server_tokens_match_reference_greedy(case, cap):
    """ServerRunner on the streaming model (f32 twins), 8 utterances on 3
    slots (so inserts land on slots that held another utterance: caches
    reset), one chunk a step, against the reference's greedy decode of each
    utterance alone: equal tokens at cap 1 and at the yaml's cap of 10
    (the blank model at about 0.32 symbols a frame); an insert resets the
    slot's convolution cache and counts a cache_reset span."""
    cfg, w, wavs = case
    w = MODEL.apply_emission(w, dict(model="blank", amp=1.0, delta=0.28418), cfg)
    rng = np.random.RandomState(4)
    wavs = wavs + [(rng.randn(n) * 0.1).astype(np.float32) for n in (5000, 3000)]
    params = MODEL.program_params(cfg, cap)
    runner = ServerRunner(fc.weights_from_dict(w, params, torch.float32), params,
                          MODEL.program_featurizer(cfg), slots=3, split_len=24, insert_batch=2,
                          steps_per_dispatch=1, device="cpu")
    assert isinstance(runner.state, StreamServerState)
    resets = REGISTRY.stats("rnnt.server.cache_reset").count
    got = _serve(runner, wavs)
    assert REGISTRY.stats("rnnt.server.cache_reset").count - resets >= 4  # 8 in 2s or 1s
    ref = MODEL.reference(dict(cfg, precision=F32), w, "cpu")
    want = [ref.greedy(f, cap, ref.max_len) for f in ref.encode([torch.from_numpy(x)
                                                                  for x in wavs])]
    for i, tok in enumerate(want):
        np.testing.assert_array_equal(got[i], tok)
    assert sum(map(len, want)) > 0
    runner.insert_samples([wavs[0]], [99])
    slot = next(s for s, q in runner.slot_sample.items() if q == 99)
    assert not bool(runner.state.stream.conv[:, slot].any())


def test_server_refusals(case):
    """ServerRunner takes the streaming model at one chunk a step only; the
    packed Offline runner sends it to the Server."""
    cfg, w, _ = case
    params = MODEL.program_params(cfg)
    wp = fc.weights_from_dict(w, params, torch.float32)
    fz = MODEL.program_featurizer(cfg)
    with pytest.raises(ValueError, match="split_len must be 24"):
        ServerRunner(wp, params, fz, slots=2, split_len=48, device="cpu")
    with pytest.raises(ValueError, match="Server"):
        PackedOfflineRunner(wp, params, fz, n_lanes=2, chunk_frames=8, device="cpu")
    with pytest.raises(ValueError, match="streaming FastConformer"):
        fc.check_params(dataclasses.replace(params, conv_norm="batch_norm"))


def test_call_record_keeps_calls_only_under_a_profiler():
    """record_call keeps a call's shapes only while a torch profiler runs."""
    before = len(REGISTRY.calls.get("test_kernel", []))
    record_call("test_kernel", 1, rows=3)
    assert len(REGISTRY.calls.get("test_kernel", [])) == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        record_call("test_kernel", 2, rows=3)
    assert list(REGISTRY.calls["test_kernel"])[-1] == dict(rows=3, launch=2)
