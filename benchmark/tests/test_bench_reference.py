"""The plain reference held to the port at small widths on the CPU (the
port's plain twins), and the alignment gap on hand-made lattices."""

import numpy as np
import pytest
import torch

import tiny
from benchmark import check, traffic
from benchmark.common import Cell, cell_weights
from benchmark.reference.rnnt import fp8, int_round, int_scale, widest_gap
from benchmark.models.rnnt import program_featurizer, program_params


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_repo(tmp_path_factory.mktemp("tiny"))


def _batch(cell, n=5, seed=3):
    lens = traffic.durations(cell.traffic["duration"], n, seed)
    wavs = traffic.host_waveforms(traffic.speechlike(lens, seed + 1, "cpu"), lens)
    x = torch.zeros((n, int(lens.max())))
    for i, w in enumerate(wavs):
        x[i, : len(w)] = torch.from_numpy(w)
    return wavs, x, torch.as_tensor(lens)


@pytest.mark.parametrize("name,enc_tol", [("tiny.int8.offline", 0.0), ("tiny.bf16.offline", 2e-3)])
def test_reference_features_and_encoder_follow_the_port(root, name, enc_tol):
    from rnnt_inference_tpu_torch.models import rnnt as model
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    cell = Cell.load(name, root)
    w, served = cell_weights(cell, "cpu")
    wavs, x, lens = _batch(cell)
    params = program_params(cell.config)
    feats, flens = log_mel_features(x, lens, program_featurizer(cell.config))
    ref = check._reference(cell.config, w, "cpu")
    for i, wav in enumerate(wavs):
        rf = ref.featurizer(torch.from_numpy(wav))
        assert rf.shape[0] == int(flens[i])
        torch.testing.assert_close(rf, feats[: rf.shape[0], i], atol=1e-4, rtol=0)
    f, _ = model.transcription(served, feats, flens, model.init_encoder_state(
        len(wavs), params, served.pre_rnn[0].w_ih.dtype, "cpu"), params)
    for i, rf in enumerate(ref.encode([torch.from_numpy(wv) for wv in wavs])):
        assert rf.shape[0] == -(-int(flens[i]) // 2)
        assert float((f[: rf.shape[0], i].float() - rf).abs().max()) <= enc_tol


@pytest.mark.parametrize("name", ["tiny.int8.offline", "tiny.bf16.offline"])
def test_the_ports_greedy_tokens_sit_on_the_references_best_logits(root, name):
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode
    from rnnt_inference_tpu_torch.ops.features import log_mel_features

    cell = Cell.load(name, root)
    w, served = cell_weights(cell, "cpu")
    wavs, x, lens = _batch(cell, seed=8)
    params = program_params(cell.config, 1)
    feats, flens = log_mel_features(x, lens, program_featurizer(cell.config))
    res, rlens = greedy_decode(served, feats, flens, params)
    tokens = [res[i, : int(rlens[i])].numpy().astype(np.int64) for i in range(len(wavs))]
    assert sum(len(t) for t in tokens) > 50
    gaps = check.gaps(cell.config, w, 1, wavs, tokens, "cpu")
    assert max(gaps) < 1e-4
    # the reference's own greedy decode serves tokens at gap 0
    ref = check._reference(cell.config, w, "cpu")
    fs = ref.encode([torch.from_numpy(v) for v in wavs])
    own = [ref.greedy(f, 1, 1024) for f in fs]
    assert check.gaps(cell.config, w, 1, wavs, own, "cpu") == [0.0] * len(wavs)


def test_number_formats():
    s = int_scale(torch.tensor(2.0), "int8")
    assert float(s) == pytest.approx(63.5)
    x = torch.tensor([-3.0, -2.0, 0.5 / 63.5, 1.5 / 63.5, 2.0, 9.0])
    # half to even, clamped
    assert int_round(x, s, "int8").tolist() == [-128.0, -127.0, 0.0, 2.0, 127.0, 127.0]
    assert int_round(x, int_scale(torch.tensor(2.0), "int4"), "int4").tolist() == [
        -8.0, -7.0, 0.0, 0.0, 7.0, 7.0]
    v = torch.linspace(-1, 1, 101)
    q = fp8(v)
    assert float((q - v).abs().max()) <= 1 / 16 and not torch.equal(q, v)


def _gap(best, tokens, cap, truncated=False, B=3):
    """widest_gap on logits where label ``best(t, k)`` is on top by 1."""
    T2 = 3
    lat = np.zeros((T2, len(tokens) + 1, 4))
    for t in range(T2):
        for k in range(len(tokens) + 1):
            lat[t, k, best(t, k)] = 1.0
    return widest_gap(lat, tokens, cap=cap, blank=B, truncated=truncated)


def test_widest_gap_by_hand():
    B = 3  # blank
    # frame 0 wants token 0 first, frame 2 wants token 1 after one token
    speech = lambda t, k: 0 if (t, k) == (0, 0) else 1 if (t, k) == (2, 1) else B
    assert _gap(speech, [0, 1], 1) == 0.0
    assert _gap(speech, [0, 2], 1) == 1.0  # a wrong token
    assert _gap(speech, [0, 1, 1], 1) == 1.0  # a token too many
    assert _gap(speech, [0], 1) == 1.0  # one left out
    assert _gap(speech, [0], 1, truncated=True) == 0.0  # cut at the buffer: ends early
    # frame 0 wants two symbols: at cap 2 it takes both, at cap 1 it advances
    # after one whatever it says, and 1 must wait for a frame that wants it
    burst = lambda t, k: k if t == 0 and k < 2 else B
    assert _gap(burst, [0, 1], 2) == 0.0
    assert _gap(burst, [0, 1], 1) == 1.0
    assert _gap(burst, [0], 1) == 0.0
    # more tokens than frames times the cap: no alignment serves them
    assert _gap(burst, [0, 1, 2, 0], 1) == np.inf
