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
from rnnt_inference_tpu_torch.tools.decode_divergence import decode_case, run_case

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


def _assert_quant_layer_equal(got, want):
    """Kernel A and its twin bit for bit: int8 y and h equal, c and f32 y
    with a max abs diff of 0 (int8 sums are exact in any order, and the
    float epilogue rounds as the twin's)."""
    for name, a, b in zip(("y", "h", "c"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, float((a.double() - b.double()).abs().max()))


@pytest.mark.parametrize("emit_f32", [False, True])
def test_quant_lstm_kernel_matches_twin(dev, qweights, emit_f32):
    """A calibrated layer (IC=1024 -> H=256), 9 steps, 20 lanes: y, h and c
    bit-equal to the twin's; one launch per call."""
    layer = qweights.post_rnn[0]
    IC, H = layer.w_ih.shape[0], layer.w_hh.shape[0]
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-128, 128, (9, 20, IC), generator=g, dtype=torch.int8).to(dev)
    h = torch.randint(-128, 128, (20, H), generator=g, dtype=torch.int8).to(dev)
    c = torch.randn((20, H), generator=g).to(dev)
    before = lstm_cuda.quant_lstm_layer_cuda.launches
    got = lstm_cuda.quant_lstm_layer_cuda(layer, x, h, c, emit_f32)
    assert lstm_cuda.quant_lstm_layer_cuda.launches == before + 1
    want = quant_lstm_layer(layer, x, h, c, emit_f32)
    torch.cuda.synchronize()
    _assert_quant_layer_equal(got, want)


def _quant_layer(dev, IC, H, seed=15):
    """Random int8 weights, with scales that keep the gates near N(0, 2)
    (sigmoid and tanh unsaturated, so a wrong column would show)."""
    from rnnt_inference_tpu_torch.models.quant import QuantLSTMLayerWeights

    rng = np.random.RandomState(seed)
    w = lambda *s: torch.from_numpy(rng.randint(-128, 128, s).astype(np.int8)).to(dev)
    sum_std = np.sqrt(IC + H) * 128 * 128 / 3  # of x.W_ih + h.W_hh for uniform int8
    in_scale = 127.0
    w_scale = sum_std / (2 * in_scale)  # rb = 1 / (in_scale w_scale) = 2 / sum_std
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return QuantLSTMLayerWeights(
        w(IC, 4 * H), w(H, 4 * H), torch.from_numpy(rng.randn(4 * H).astype(np.float32)).to(dev),
        f32(in_scale), f32(w_scale), f32(100.0))


@pytest.mark.parametrize("emit_f32", [False, True])
@pytest.mark.parametrize("IC", [240, 1024, 2048])
@pytest.mark.parametrize("T", [1, 48])
@pytest.mark.parametrize("N", [1, 16, 128, 200, 1024])
def test_quant_lstm_kernel_mlperf_width(dev, N, T, IC, emit_f32):
    """Kernel A at H=1024 (MLPerf's width) for the three int8 layer shapes
    (IC=240 padded to 256 inside), 1 to 1,024 lanes (more than one pass of
    128 from N=200), one and 48 steps: bit-equal to the twin, one launch per
    call."""
    layer = _quant_layer(dev, IC, 1024)
    g = torch.Generator().manual_seed(N + T + IC)
    x = torch.randint(-128, 128, (T, N, IC), generator=g, dtype=torch.int8).to(dev)
    h = torch.randint(-128, 128, (N, 1024), generator=g, dtype=torch.int8).to(dev)
    c = (torch.randn((N, 1024), generator=g) * 0.5).to(dev)
    before = lstm_cuda.quant_lstm_layer_cuda.launches
    got = lstm_cuda.quant_lstm_layer_cuda(layer, x, h, c, emit_f32)
    assert lstm_cuda.quant_lstm_layer_cuda.launches == before + 1
    want = quant_lstm_layer(layer, x, h, c, emit_f32)
    torch.cuda.synchronize()
    _assert_quant_layer_equal(got, want)


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
    """Kernel C over T=7 steps, N lanes not a multiple of the lane tile:
    f32 y/h/c within 1e-5; bf16 y/h within 2**-8 (one bf16 step below 1)
    and c within 1e-3.  One launch per call."""
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
    assert lstm_scan_cuda.lstm_recurrence_cuda.launches == before + 1
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


def _decode_case(dev, wdtype, N, P=320, J=512, seed=12):
    """Full-width (P=320, J=512 by default) decode weights and N lanes in
    random states."""
    return decode_case(dev, wdtype, N, P, J, seed)


def _assert_decode_close(a, b, bf16):
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
    assert float((a[1].float() - b[1].float()).abs().max()) <= (2 ** -8 if bf16 else 1e-5)
    assert float((a[2] - b[2]).abs().max()) <= (1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("N", [1, 16, 64, 128, 200, 1024])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_one_and_k_steps(dev, wdtype, N):
    """Kernel B at full width, 1 to 1,024 lanes: one iteration from the
    twin's state, and one launch of K=8 iterations from a fresh state
    against 8 twin steps, held
    to the per-step tolerances (lanes and tokens equal; bf16 hg 2**-8, cg
    1e-3; f32 1e-5).  One launch per call."""
    params, dw, fproj, state = _decode_case(dev, wdtype, N)
    bf16 = wdtype == torch.bfloat16
    for steps in (1, 8):
        a = [t.clone() for t in state]
        b = [t.clone() for t in state]
        before = dc.decode_step_cuda.launches
        dc.decode_step_cuda(fproj, *a, dw, params, steps)
        assert dc.decode_step_cuda.launches == before + 1
        for _ in range(steps):
            dc.decode_step_reference(fproj, *b, dw, params)
        torch.cuda.synchronize()
        _assert_decode_close(a, b, bf16)


def test_decode_kernel_leaves_early(dev):
    """A launch asked for 100000 iterations on lanes that all finish within
    31 leaves once they have: it takes far less than 100000 iterations'
    time, and its state is the twin's after 31 steps."""
    params, dw, fproj, state = _decode_case(dev, torch.bfloat16, 64)
    state[0][dc.F_LENS] = 1
    state[0][dc.EOS] = 0
    state[0][dc.TIME] = 0
    state[0][dc.FINISH] = 0
    state[0][dc.SYMADD] = 0
    a = [t.clone() for t in state]
    dc.decode_step_cuda(fproj, *[t.clone() for t in state], dw, params, 1)  # warm
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    dc.decode_step_cuda(fproj, *[t.clone() for t in state], dw, params, 1)
    t1.record()
    t1.synchronize()
    one = t0.elapsed_time(t1)
    t0.record()
    dc.decode_step_cuda(fproj, *a, dw, params, 100000)
    t1.record()
    t1.synchronize()
    assert bool(a[0][dc.FINISH].all())
    assert t0.elapsed_time(t1) < 200 * one
    b = [t.clone() for t in state]
    for _ in range(params.max_symbols_per_step + 1):
        dc.decode_step_reference(fproj, *b, dw, params)
    _assert_decode_close(a, b, True)


def _scan_layer(dev, dtype, H, IC=64, seed=13):
    from rnnt_inference_tpu_torch.models.weights import LSTMLayerWeights

    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(H)
    return LSTMLayerWeights(*(
        torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32)).to(dev, dtype)
        for s in ((IC, 4 * H), (H, 4 * H), (4 * H,))))


@pytest.mark.parametrize("T", [1, 48])
@pytest.mark.parametrize("N", [1, 16, 128, 200, 1024])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_kernel_mlperf_width(dev, wdtype, N, T):
    """Kernel C at H=1024 (MLPerf's width), 1 to 1,024 lanes, against its
    twin on the same xw:
    f32 within 1e-5; bf16 y/h within 2**-8 and c within 1e-3.  One launch
    per call."""
    from rnnt_inference_tpu_torch.ops import lstm as tl
    from rnnt_inference_tpu_torch.ops import lstm_scan_cuda

    layer = _scan_layer(dev, wdtype, 1024)
    g = torch.Generator().manual_seed(14)
    xw = (torch.randn((T, N, 4096), generator=g) * 0.5).to(dev, wdtype)
    h0 = (torch.randn((N, 1024), generator=g) * 0.5).to(dev, wdtype)
    c0 = (torch.randn((N, 1024), generator=g) * 0.5).to(dev)
    before = lstm_scan_cuda.lstm_recurrence_cuda.launches
    got = lstm_scan_cuda.lstm_recurrence_cuda(layer, xw, h0, c0)
    assert lstm_scan_cuda.lstm_recurrence_cuda.launches == before + 1
    want = tl.lstm_recurrence(xw, layer.w_hh, h0, c0)
    torch.cuda.synchronize()
    bf16 = wdtype == torch.bfloat16
    for name, a, b in zip(("y", "h", "c"), got, want):
        tol = (1e-3 if name == "c" else 2 ** -8) if bf16 else 1e-5
        assert float((a.float() - b.float()).abs().max()) <= tol, name


def test_refused_shapes_raise(dev):
    """Shapes the kernels cannot take raise ValueError before any launch:
    kernel C with H not a multiple of 128 or too many lanes for shared
    memory; kernel B with P not a multiple of 64; kernel A with H not a
    multiple of 16, more blocks than SMs, too many lanes for shared memory,
    or x not 16-byte aligned."""
    from rnnt_inference_tpu_torch.ops import lstm_scan_cuda

    before = (lstm_scan_cuda.lstm_recurrence_cuda.launches, dc.decode_step_cuda.launches,
              lstm_cuda.quant_lstm_layer_cuda.launches)
    layer = _scan_layer(dev, torch.float32, 192)
    with pytest.raises(ValueError, match="multiple of 128"):
        lstm_scan_cuda.lstm_recurrence_cuda(
            layer, torch.zeros((2, 3, 768), device=dev), torch.zeros((3, 192), device=dev),
            torch.zeros((3, 192), device=dev))
    layer = _scan_layer(dev, torch.float32, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        lstm_scan_cuda.lstm_recurrence_cuda(
            layer, torch.zeros((1, 4000, 4096), device=dev), torch.zeros((4000, 1024), device=dev),
            torch.zeros((4000, 1024), device=dev))
    params, dw, fproj, state = _decode_case(dev, torch.float32, 4, P=96, J=64)
    with pytest.raises(ValueError, match="multiples of 64"):
        dc.decode_step_cuda(fproj, *state, dw, params, 4)
    i8 = lambda *s: torch.zeros(s, dtype=torch.int8, device=dev)
    f32 = lambda *s: torch.zeros(s, device=dev)
    for (IC, H, N), msg in [((240, 1000, 4), "multiples of 16"), ((240, 2048, 4), "blocks"),
                            ((2048, 1024, 4096), "shared memory")]:
        with pytest.raises(ValueError, match=msg):
            lstm_cuda.quant_lstm_layer_cuda(_quant_layer(dev, IC, H), i8(2, N, IC), i8(N, H),
                                            f32(N, H), False)
    x = i8(2 * 4 * 240 + 1)[1:].view(2, 4, 240)  # contiguous, one byte off
    with pytest.raises(ValueError, match="16-byte"):
        lstm_cuda.quant_lstm_layer_cuda(_quant_layer(dev, 240, 1024), x, i8(4, 1024),
                                        f32(4, 1024), False)
    assert before == (lstm_scan_cuda.lstm_recurrence_cuda.launches, dc.decode_step_cuda.launches,
                      lstm_cuda.quant_lstm_layer_cuda.launches)


def _packed_case(dev, wdtype, N, seed=21):
    """``_decode_case``'s lanes on packed timelines: utterance starts on
    about half the frames, and each lane's current utterance begun 0-9
    tokens before its res_idx (res_base)."""
    return decode_case(dev, wdtype, N, seed=seed, packed=True)


@pytest.mark.parametrize("budget", [0, 4])
@pytest.mark.parametrize("N", [1, 16, 64, 128, 200, 1024])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_packed_mode(dev, wdtype, N, budget):
    """Kernel B's packed mode against its twin at full width, 1 to 1,024
    lanes, one iteration and one launch of K=8 from the same state (as the
    bucketed mode's test): lanes, tokens, markers and res_base equal, hg
    and cg within the per-step tolerances.  budget 4 binds on lanes whose
    utterance already holds 4 tokens; budget 0 is the gate off.  One launch
    per call."""
    params, dw, fproj, state, starts, rb = _packed_case(dev, wdtype, N)
    for steps in (1, 8):
        a = [t.clone() for t in state]
        b = [t.clone() for t in state]
        ra, rr = rb.clone(), rb.clone()
        before = dc.decode_step_cuda.launches
        dc.decode_step_cuda(fproj, *a, dw, params, steps, starts, ra, budget)
        assert dc.decode_step_cuda.launches == before + 1
        for _ in range(steps):
            dc.decode_step_reference(fproj, *b, dw, params, starts, rr, budget)
        torch.cuda.synchronize()
        _assert_decode_close(a, b, wdtype == torch.bfloat16)
        assert torch.equal(ra, rr)
    if N >= 16:  # some lane entered an utterance (its marker may lie past R)
        assert bool((rr != rb).any())


@pytest.mark.parametrize("mode", ["bucketed", 0, 4])
@pytest.mark.parametrize("seed", [12, 21])
@pytest.mark.parametrize("N", [64, 1024])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_k64_launch_parts_only_at_near_ties(dev, wdtype, N, seed, mode):
    """One launch of K = 64 iterations, the symbol loop's K, against 64
    twin iterations from the same state (``_decode_case``'s lanes, seeds 12
    and 21), bucketed and packed (budget gate off and at 4): two launches
    agree bit for bit; every lane that never parts from the twin ends
    within the per-step tolerances; and a lane parts only at a near-tie,
    where its h and c drift is within those tolerances and the twin given
    the kernel's own state chooses the kernel's symbol
    (tools/decode_divergence.py, which also reports the logit gaps)."""
    r = run_case(dev, wdtype, N, seed, mode)
    assert r["deterministic"]
    assert r["end_drift_within_tolerance"], r
    assert all(lane["near_tie"] for lane in r["lanes"]), r["lanes"]


def test_packed_runner_kernels_match_twins(dev, qweights):
    """A small packed int8 run (3 lanes, 16-frame chunks, 8-frame decode
    pieces) gives its impl="reference" run's tokens; kernel A launches five
    times per chunk, kernel B at least once, and the reference run
    launches nothing."""
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    store = SampleStore.synthetic(n=7, seed=3, min_seconds=0.3, max_seconds=2.0,
                                  mean_seconds=1.0)
    qsl = QuerySampleLibrary(store, wav_buckets_s=(1.0, 2.0))
    out = {}
    for impl in (None, "reference"):
        r = PackedOfflineRunner(qweights, P, n_lanes=3, chunk_frames=16, batch_size=4,
                                decode_chunk=8, device=dev, impl=impl)
        plan = r.stage(qsl)
        out[impl] = r.run_device()
    assert out[None].launches["quant_lstm_layer"] == 5 * plan.n_chunks
    assert out[None].launches["decode_step"] > 0
    assert not any(out["reference"].launches.values())
    for a, b in zip(out[None].tokens, out["reference"].tokens, strict=True):
        np.testing.assert_array_equal(a, b)


def test_fake_quant_on_card_matches_twins(dev):
    """The fake_quant model (no kernel in its encoder: an eager per-step
    loop, as the JAX package's XLA scan) on the card: the encoder output
    within 1e-5 of the CPU's (f32 products, TF32 off), and the greedy
    decode through kernel B's f32 instantiation gives the CPU twins'
    tokens."""
    from rnnt_inference_tpu_torch.models import rnnt
    from rnnt_inference_tpu_torch.models.quant import fake_quantize_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    w = init_weights(P, torch.Generator().manual_seed(3), device="cpu")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((16, 4, 240), generator=g)
    lens = torch.tensor([16, 13, 9, 16], dtype=torch.int32)
    fq = fake_quantize_weights(w, calibrate(w, [(x, lens)], P), P)
    fq_dev = fq.to(dev)
    f_cpu, _ = rnnt.transcription(fq, x, lens, rnnt.init_encoder_state(4, P, device="cpu"))
    f_dev, _ = rnnt.transcription(fq_dev, x.to(dev), lens.to(dev),
                                  rnnt.init_encoder_state(4, P, device=dev))
    assert float((f_dev.cpu() - f_cpu).abs().max()) <= 1e-5
    before = dc.decode_step_cuda.launches
    res, n = greedy_decode(fq_dev, x.to(dev), lens.to(dev), P)
    assert dc.decode_step_cuda.launches > before
    want, want_n = greedy_decode(fq, x, lens, P)
    assert torch.equal(n.cpu(), want_n) and torch.equal(res.cpu(), want) and int(want_n.sum()) > 0


def test_quant_linear_on_card_is_exact(dev):
    """iLinear on the card: the int8 products summed exactly (f64) give the
    CPU's result bit for bit; the int8 joint within 1e-5 of the CPU's."""
    from rnnt_inference_tpu_torch.models import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    w, b, xs = torch.randn((1024, 512), generator=g), torch.randn(512, generator=g), \
        torch.randn((64, 1024), generator=g)
    ql = quant.quantize_linear(w, b, xs.abs().max())
    ql_dev = quant.quantize_linear(w.to(dev), b.to(dev), xs.abs().max().to(dev))
    assert torch.equal(ql_dev.w_i8.cpu(), ql.w_i8)
    assert torch.equal(quant.quant_linear_apply(ql_dev, xs.to(dev)).cpu(),
                       quant.quant_linear_apply(ql, xs))
    wts = init_weights(P, torch.Generator().manual_seed(6), device="cpu")
    f = torch.randn((8, P.trans_hidden_size), generator=g)
    gg = torch.randn((8, P.pred_hidden_size), generator=g)
    jq = quant.quantize_joint_fc1_trans(wts, f.abs().max())
    jq_dev = quant.quantize_joint_fc1_trans(wts.to(dev), f.abs().max().to(dev))
    got = quant.joint_quant_fc1(wts.to(dev), jq_dev, f.to(dev), gg.to(dev)).cpu()
    assert float((got - quant.joint_quant_fc1(wts, jq, f, gg)).abs().max()) <= 1e-5


def test_device_trace_records_the_card(dev, tmp_path):
    """device_trace on the card: the chrome trace holds the kernels of a
    timed-rep span, so its idle share can be read."""
    from rnnt_inference_tpu_torch.utils import profiler

    a = torch.randn((2048, 2048), device=dev)
    with profiler.device_trace(str(tmp_path), dev) as path:
        with torch.profiler.record_function(profiler.TIMED_REP):
            for _ in range(4):
                a = a @ a / 64
            torch.cuda.synchronize()
    (span,) = profiler.device_idle_share(profiler.load_trace(path))
    assert span["busy_us"] > 0 and 0.0 <= span["idle_share"] < 1.0


BENCH_KNOB_CASES = {
    "default": {},
    "unpacked": dict(BENCH_PACKED="0"),
    "bf16": dict(BENCH_DTYPE="bf16"),
    "f32_unpacked": dict(BENCH_DTYPE="f32", BENCH_PACKED="0"),
    "uniform": dict(BENCH_EMISSION="uniform"),
    "chunks_res_len_buckets": dict(BENCH_PACK_CHUNK="8", BENCH_PACK_DECODE_CHUNK="32",
                                   BENCH_RES_LEN="64", BENCH_SECONDS="2,4,8,15"),
    "burst_targets": dict(BENCH_EMISSION="burst", BENCH_SYM_CAP="30", BENCH_BURST_RATE="0.6",
                          BENCH_BURST_FACTOR="1.2"),
    "burst_replay": dict(BENCH_EMISSION="burst", BENCH_SYM_CAP="30",
                         BENCH_BURST_DELTA="4:0.5:1"),
}


@pytest.mark.parametrize("case", list(BENCH_KNOB_CASES))
def test_bench_knob_values_on_card(dev, monkeypatch, case):
    """The bench on the card at full width with each knob value (64
    utterances on 32 lanes or batch rows, at least 0.05 s of timed reps,
    the emission model calibrated on the card unless replayed): a positive
    value, the calibrated rate within 2x of its target, and the kernels of
    its path launched in the timed rep (A and B for int8, C and B for the
    float types)."""
    from rnnt_inference_tpu_torch import bench

    knobs = dict(BENCH_N="64", BENCH_BATCH="32", BENCH_MIN_S="0.05", **BENCH_KNOB_CASES[case])
    for k in list(bench.KNOB_DEFAULTS) + ["BENCH_BLANK_DELTA", "BENCH_BURST_DELTA"]:
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    payload = bench.run(dev)
    proto = payload["protocol"]
    assert payload["value"] > 0
    assert proto["packed"] == (knobs.get("BENCH_PACKED", "1") == "1")
    assert proto["max_res_len"] == int(knobs.get("BENCH_RES_LEN", "512"))
    encoder = "quant_lstm_layer" if proto["dtype"] == "quant" else "lstm_recurrence"
    assert proto["launches"][encoder] > 0 and proto["launches"]["decode_step"] > 0
    assert proto["launched_decode_iterations"] == 64 * proto["launches"]["decode_step"]
    calib = proto["calibration"]
    if "target" in calib:
        assert 0.5 * calib["target"] <= calib["sym_per_frame"] <= 2.0 * calib["target"], calib
    if case == "burst_targets":
        assert calib["target"] == 0.6 and calib["target_burst"] == 1.2


def test_packed_runner_launches_part_only_at_ties(dev, qweights):
    """Every kernel-B launch of a packed int8 run on 64 lanes against K twin
    iterations from the state it starts from
    (tools/decode_divergence.compare_run_launches): each lane that parts
    does so at a near-tie or a product tie, the others end within kernel
    B's per-step tolerances, each launch repeats bit for bit, and the run's
    tokens equal those of the same rep without the comparisons."""
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
    from rnnt_inference_tpu_torch.tools.decode_divergence import compare_run_launches

    store = SampleStore.synthetic(n=96, seed=5, min_seconds=0.5, max_seconds=3.0,
                                  mean_seconds=1.5)
    r = PackedOfflineRunner(qweights, P, n_lanes=64, chunk_frames=16, batch_size=64,
                            decode_chunk=32, device=dev)
    r.stage(QuerySampleLibrary(store, wav_buckets_s=(1.0, 2.0, 3.0)))
    plain = r.run_device()
    got, summary = compare_run_launches(r.run_device)
    assert summary["launches"] == plain.launches["decode_step"] > 0
    assert summary["faults"] == 0, summary
    for a, b in zip(got.tokens, plain.tokens, strict=True):
        np.testing.assert_array_equal(a, b)
