"""The Conformer-Transducer on the CPU at a small size (d_model 64, 2 heads,
2 blocks, conv kernel 7, P = J = 64, V = 40, seeded random weights), held
to the benchmark's plain reference, benchmark/reference/conformer_transducer.py:
the encoder per utterance, kernel F's twin against NeMo's rel_shift, the
joint's logits on the reference's lattice, and the packed runner's tokens
against the reference's greedy decode."""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.models import load
from rnnt_inference_tpu_torch.config import ConformerParams, FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models import conformer
from rnnt_inference_tpu_torch.models.decoder import init_decode_state
from rnnt_inference_tpu_torch.ops import attention_cuda as ac
from rnnt_inference_tpu_torch.ops import cuda_build
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.ops.features import log_mel_features
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
from rnnt_inference_tpu_torch.runtime.server import ServerRunner

REPO = Path(__file__).resolve().parents[1]
MODEL = load("conformer_transducer", REPO)
SMALL = dict(d_model=64, num_blocks=2, n_heads=2, conv_kernel_size=7, conv_channels=16,
             pred_hidden_size=64, joint_hidden_size=64, num_labels=40, max_res_len=128)
F32 = {"encoder": "f32", "prediction": "f32", "joint": "f32"}
# 1.0, 0.5625, 0.27, 0.75, 0.44, 0.19 and 0.94 s: first-convolution lengths
# 51 (odd), 29 (odd), 14, 38, 22, 10 and 47 (odd)
LENS = [16000, 9000, 4321, 12007, 7000, 3100, 15000]


def tiny_config(**sizes) -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "nemo_conformer_transducer_large.json").read_text())
    return dict(cfg, **(sizes or SMALL))


def tiny_weights(cfg: dict, device, cap: int = 1, dtype=torch.bfloat16, emission=0.0):
    """(ConformerWeights on ``device``, params at ``cap``, featurizer) of the
    configuration's random weights, blank's logit raised by ``emission``."""
    w = MODEL.apply_emission(MODEL.random_weights(cfg, "cpu"),
                             dict(model="blank", amp=1.0, delta=emission), cfg)
    params = MODEL.program_params(cfg, cap)
    return (conformer.weights_from_dict(w, params, dtype).to(device), params,
            MODEL.program_featurizer(cfg))


@pytest.fixture(scope="module")
def case():
    cfg = tiny_config()
    w = MODEL.apply_emission(MODEL.random_weights(cfg, "cpu"),
                             dict(model="blank", amp=1.0, delta=0.0), cfg)
    rng = np.random.RandomState(1)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in LENS]
    return cfg, w, wavs


def _batch(wavs):
    wav = torch.zeros((len(wavs), max(len(x) for x in wavs)))
    for i, x in enumerate(wavs):
        wav[i, : len(x)] = torch.from_numpy(x)
    return wav, torch.tensor([len(x) for x in wavs])


def test_config_and_featurizer_fields():
    """The new FeaturizerConfig fields keep the MLPerf featurizer as it was
    (dither^2 added, guard 1e-20); the Conformer's adds no dither and 2^-24;
    ConformerParams' lengths follow the two stride-2 convolutions."""
    mlperf = FeaturizerConfig()
    assert mlperf.dither_power == 1e-5 ** 2 and mlperf.log_guard == 1e-20
    fz = MODEL.program_featurizer(tiny_config())
    assert fz.dither_power == 0.0 and fz.log_guard == 2.0 ** -24
    assert fz.win_length == 400 and fz.out_frames(16000) == 101
    p = ConformerParams()
    assert [p.encoded_len(n) for n in (0, 1, 2, 3, 4, 5, 8, 9, 101)] == \
        [0, 1, 1, 1, 1, 2, 2, 3, 26]
    assert p.sub_freq == 20 and p.d_head == 64 and p.BLANK == p.num_labels - 1


def test_features_match_reference(case):
    cfg, w, wavs = case
    ref = MODEL.reference(dict(cfg, precision=F32), w, "cpu")
    feats, flens = log_mel_features(*_batch(wavs), MODEL.program_featurizer(cfg))
    for i, x in enumerate(wavs):
        want = ref.featurizer(torch.from_numpy(x))
        assert int(flens[i]) == want.shape[0]
        # f32 DFT and mel products against the reference's float64, one rounding
        assert float((feats[: flens[i], i] - want).abs().max()) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_matches_reference_per_utterance(case, dtype):
    """The port's encoder on its twins, all utterances in one varlen group,
    against the reference computing each alone at the same precision.
    f32: both exact f32 programs of the same equations, apart by summation
    order (5e-6 of outputs of about 3.6 measured; 1e-4 allowed).  bf16: the
    program rounds every product's output to bf16 and folds BatchNorm into
    the bf16 depthwise weights where the reference keeps f32 until the next
    product's input, so they part by a few bf16 roundings through two
    blocks (0.012 measured, 0.06 allowed; a wrong weight or frame moves them
    by 1 or more)."""
    cfg, w, wavs = case
    prec = F32 if dtype == torch.float32 else cfg["precision"]
    ref = MODEL.reference(dict(cfg, precision=prec), w, "cpu")
    params = MODEL.program_params(cfg)
    wp = conformer.weights_from_dict(w, params, dtype)
    feats, flens = log_mel_features(*_batch(wavs), MODEL.program_featurizer(cfg))
    got = conformer.encode(wp, feats, flens, params)
    want = ref.encode([torch.from_numpy(x) for x in wavs])
    tol = 1e-4 if dtype == torch.float32 else 0.06
    for g, r in zip(got, want):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_utterance_encodes_alike_in_a_group_and_alone(case, dtype):
    """Every utterance of a group, odd first-convolution lengths among them
    (51, 29, 47), equals its encode as a batch of one, up to the summation
    order of products over another number of rows (the CPU BLAS blocks them
    otherwise; 1e-5 allowed of outputs of about 3).  A frame that leaked
    across utterances or past an odd length (ReLU(bias), NeMo's batched
    read) would move them by 0.1 or more."""
    cfg, w, wavs = case
    params = MODEL.program_params(cfg)
    wp = conformer.weights_from_dict(w, params, dtype)
    feats, flens = log_mel_features(*_batch(wavs), MODEL.program_featurizer(cfg))
    group = conformer.encode(wp, feats, flens, params)
    assert {int(f - 1) // 2 + 1 for f in flens} >= {51, 29, 47}
    for i in range(len(wavs)):
        alone = conformer.encode(wp, feats[: int(flens[i]), i : i + 1], flens[i : i + 1],
                                 params)[0]
        assert float((alone - group[i]).abs().max()) < 1e-5, i


def _nemo_attention(q, k, v, u, vb, pos, lens, starts):
    """NeMo's RelPositionMultiHeadAttention core as written there, per
    utterance: positions of the utterance's own length, matrix_bd through
    rel_shift (pad, view, slice), scores / sqrt(d_k), softmax, . v."""
    H, d = u.shape
    out = torch.zeros_like(q)
    for s, T in zip(starts, lens):
        heads = lambda t: t[s : s + T].reshape(T, H, d).transpose(0, 1)
        qh, kh, vh = heads(q), heads(k), heads(v)
        tm = (pos.shape[0] + 1) // 2
        p = pos[tm - T : tm + T - 1].reshape(2 * T - 1, H, d).transpose(0, 1)
        ac_ = (qh + u[:, None]) @ kh.transpose(1, 2)
        bd = (qh + vb[:, None]) @ p.transpose(1, 2)  # (H, T, 2T - 1)
        bd = F.pad(bd, (1, 0)).view(H, 2 * T, T)[:, 1:].view(H, T, 2 * T - 1)[..., :T]
        attn = torch.softmax((ac_ + bd) / math.sqrt(d), dim=-1)
        out[s : s + T] = (attn @ vh).transpose(0, 1).reshape(T, H * d)
    return out


def test_rel_attention_twin_matches_nemo_rel_shift():
    """Kernel F's twin (positions read as p(i - j) from one band shared by
    the group) against NeMo's rel_shift on each utterance's own positions,
    in f32: the same sums in another order (1e-5 allowed)."""
    g = torch.Generator().manual_seed(4)
    lens = np.array([1, 7, 13, 2, 9])
    starts, R = conformer.varlen_layout(lens)
    H, d = 3, 8
    seg = ac.Segments.of(starts, lens, "cpu")
    q, k, v = (torch.randn((R, H * d), generator=g) for _ in range(3))
    u, vb = torch.randn((H, d), generator=g), torch.randn((H, d), generator=g)
    pos = torch.randn((2 * seg.t_max - 1, H * d), generator=g)
    got = ac.rel_attention(q, k, v, u, vb, pos, seg)
    want = _nemo_attention(q, k, v, u, vb, pos, lens, starts)
    assert float((got - want).abs().max()) < 1e-5
    gaps = conformer.gap_mask(starts, lens, R, "cpu")
    assert int(gaps.sum()) == R - lens.sum() and not bool(got[gaps].any())


def test_relative_positions_table():
    """NeMo's sinusoids: row t_max - 1 is position 0 (sin 0, cos 0), the table
    is odd in its sine columns about it."""
    pe = ac.relative_positions(5, 8)
    assert pe.shape == (9, 8)
    assert torch.equal(pe[4, 0::2], torch.zeros(4)) and torch.equal(pe[4, 1::2], torch.ones(4))
    assert torch.allclose(pe[0, 0::2], -pe[8, 0::2]) and torch.allclose(pe[0, 1::2], pe[8, 1::2])


def test_joint_logits_on_the_reference_lattice(case):
    """The port's prediction net and joint (kernel B's twin, one layer, the
    encoder's output through the hoisted projection) at every node of an
    utterance's alignment lattice against the reference's lattice, f32
    (1e-4 allowed: summation order)."""
    cfg, w, wavs = case
    ref = MODEL.reference(dict(cfg, precision=F32), w, "cpu")
    params = MODEL.program_params(cfg)
    wp = conformer.weights_from_dict(w, params, torch.float32)
    f = ref.encode([torch.from_numpy(wavs[0])])[0]
    tokens = np.array([3, 17, 17, 0, 38, 5])
    want = ref.lattice(f, tokens)  # (T2, K + 1, V)
    dw = dc.decode_weights(wp)
    T2, P = f.shape[0], params.pred_hidden_size
    hg, cg = torch.zeros((1, T2, P)), torch.zeros((1, T2, P))
    fp = (f @ wp.joint.w1_trans)[:, None, :].expand(T2, T2, -1)  # lane t reads frame t
    for kk in range(len(tokens) + 1):
        lanes = torch.zeros((dc.N_LANE_ROWS, T2), dtype=torch.int32)
        lanes[dc.PRE_G] = params.SOS if kk == 0 else int(tokens[kk - 1])
        lanes[dc.TIME] = torch.arange(T2)
        logits, h_new, c_new = dc.decode_logits_reference(fp, lanes, hg, cg, dw, params)
        assert float((logits - want[:, kk]).abs().max()) < 1e-4, kk
        hg, cg = h_new, c_new


def _runner_tokens(w, params, fz, wavs, impl=None):
    store = SampleStore(kind="waveform", samples=wavs, transcripts=[""] * len(wavs))
    qsl = QuerySampleLibrary(store, fz, wav_buckets_s=[0.5, 1.0])
    runner = PackedOfflineRunner(w, params, fz, n_lanes=3, chunk_frames=16, batch_size=4,
                                 decode_chunk=8, device="cpu", impl=impl)
    runner.stage(qsl)
    return runner, runner.run_device()


@pytest.mark.parametrize("cap", [1, 10])
def test_packed_runner_tokens_match_reference_greedy(case, cap):
    """PackedOfflineRunner on the Conformer (f32 twins), 7 utterances on 3
    lanes, against the reference's greedy decode of each utterance alone:
    equal tokens at cap 1 and at cap 10 (where answers reach max_res_len);
    the phase clock has the subsample mark, and the tokens are int16."""
    cfg, w, wavs = case
    params = MODEL.program_params(cfg, cap)
    wp = conformer.weights_from_dict(w, params, torch.float32)
    runner, r = _runner_tokens(wp, params, MODEL.program_featurizer(cfg), wavs)
    assert set(r.phase_seconds) == {"features", "subsample", "encoder", "decode"}
    ref = MODEL.reference(dict(cfg, precision=F32), w, "cpu")
    fs = ref.encode([torch.from_numpy(x) for x in wavs])
    lens = []
    for tok, f in zip(r.tokens, fs):
        np.testing.assert_array_equal(tok, ref.greedy(f, cap, ref.max_len))
        lens.append(len(tok))
    assert sum(lens) > 0 and (cap == 1 or max(lens) == params.max_res_len)
    assert runner._params_pack.max_res_len % 128 == 0


def test_packed_runner_bf16_twins_match_its_f32_tokens_mostly(case):
    """The served form (bf16 weights) on the runner: every answer within
    reach of the f32 one (a near tie may part them: at most 2 of 7)."""
    cfg, w, wavs = case
    params = MODEL.program_params(cfg, 1)
    fz = MODEL.program_featurizer(cfg)
    _, a = _runner_tokens(conformer.weights_from_dict(w, params, torch.float32), params, fz, wavs)
    _, b = _runner_tokens(conformer.weights_from_dict(w, params, torch.bfloat16), params, fz,
                          wavs)
    assert sum(not np.array_equal(x, y) for x, y in zip(a.tokens, b.tokens)) <= 2


def test_conformer_decode_state_and_server_refusal(case):
    """The decode state of a Conformer carries no encoder state and int16
    tokens (1,025 labels); the MLPerf RNN-T keeps int8; ServerRunner
    refuses Conformer params."""
    st = init_decode_state(4, ConformerParams(), torch.bfloat16, torch.bfloat16, "cpu")
    assert st.enc is None and st.res.dtype == torch.int16 and st.hg.shape == (1, 4, 640)
    assert init_decode_state(2, RNNTParams(), device="cpu").res.dtype == torch.int8
    assert dc.token_dtype(127) == torch.int8 and dc.token_dtype(128) == torch.int16
    cfg, w, _ = case
    params = MODEL.program_params(cfg)
    wp = conformer.weights_from_dict(w, params, torch.float32)
    with pytest.raises(ValueError, match="Conformer"):
        ServerRunner(wp, params, MODEL.program_featurizer(cfg), slots=2, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        PackedOfflineRunner(wp, params, MODEL.program_featurizer(cfg), n_lanes=2,
                            chunk_frames=6, device="cpu")


def test_wide_kernel_operands_hold_each_blocks_columns():
    """kernel_operands_wide lays out, per block b: W_hh's gate columns of
    units 8b .. 8b + 7, [W1p's columns 8b .. | those gates] for the joint's
    pass, W2's labels 16b .. 16b + 15 (zeros past V), and eproj = embed .
    W_ih + b with SOS's row b; plan_wide refuses a grid beyond the SMs."""
    P, J, V = 64, 64, 40
    g = torch.Generator().manual_seed(7)
    r = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    dw = dc.DecodeWeights(embed=r(V - 1, P), w_ih=r(1, P, 4 * P), w_hh=r(1, P, 4 * P),
                          b=torch.randn((1, 4 * P), generator=g), w1p=r(P, J),
                          b1=torch.randn(J, generator=g), w2=r(J, V),
                          b2=torch.randn(V, generator=g))
    whh, wj, wout, eproj = dc.kernel_operands_wide(dw)
    UP, nbv = dc.UP_WIDE, -(-V // dc.VB)
    inv = cuda_build.b_fragments_inverse
    perm = cuda_build.gate_columns(UP, torch.bfloat16)
    gates = lambda b: torch.stack([dw.w_hh[0][:, gg * P + b * UP + u] for u in range(UP)
                                   for gg in range(4)], 1)  # column 4u + g
    for b in range(P // UP):
        assert torch.equal(inv(whh[b]), gates(b)[:, perm])
        j = inv(wj[b])
        assert torch.equal(j[:, : dc.UJ], dw.w1p[:, b * dc.UJ : (b + 1) * dc.UJ])
        assert torch.equal(j[:, dc.UJ :], gates(b)[:, perm])
    assert wout.shape[0] == nbv
    w2p = torch.cat([dw.w2, torch.zeros((J, nbv * dc.VB - V), dtype=dw.w2.dtype)], 1)
    for b in range(nbv):
        assert torch.equal(inv(wout[b]), w2p[:, b * dc.VB : (b + 1) * dc.VB])
    table = torch.cat([dw.embed.float() @ dw.w_ih[0].float() + dw.b[0], dw.b[0][None]])
    assert torch.allclose(eproj.permute(1, 3, 0, 2).reshape(V, 4 * P), table, atol=1e-5)
    assert dc.plan_wide(640, 640, 1025, 1024, 1, torch.bfloat16, 132) > 0
    with pytest.raises(ValueError, match="SMs"):
        dc.plan_wide(1280, 640, 1025, 1024, 1, torch.bfloat16, 132)
    with pytest.raises(ValueError, match="one bf16"):
        dc.plan_wide(640, 640, 1025, 1024, 2, torch.bfloat16, 132)
