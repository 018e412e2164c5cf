"""The streaming FastConformer-Transducer's Server cell taken by the harness
as files: a tiny configuration of it (fastconformer_tiny.py) beside the tiny
RNN-T cells, run through run_cell on the CPU on the program's plain twins;
and its model module's counts, by hand."""

import json
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

import fastconformer_tiny
import tiny
from benchmark import harness
from benchmark.common import Cell
from benchmark.models import load

MODEL = load("fastconformer_streaming", tiny.REPO)


def test_a_tiny_streaming_server_cell_runs_through_the_harness(tmp_path):
    """Untraced: correct, latency_p50_ms and setup_s reported.  Traced: the
    Server's host metrics read on the CPU; the streaming kernels' rooflines
    stay silent (no device kernels in a CPU trace), and so does
    server.stream_encode_host_ms, as server.extract_host_ms, over a stretch
    (1 s to trace_from_s - 0.5 s) that ends before it begins; its
    reader over a stretch that holds the window's steps reads their mean
    rnnt.server.stream_encode span."""
    root = tiny.make_repo(tmp_path)
    cell = Cell.load(fastconformer_tiny.add_cell(root), root)
    assert cell.model.__file__.endswith("fastconformer_streaming.py")
    seed = 2 ** 31 + 20
    r = harness.run_cell(cell, "cpu", seed, 1.0, False, time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"latency_p50_ms", "setup_s"}
    # the bf16 twins against the f32 reference: near ties only (a wrong token costs tenths)
    assert r["checks"]["mean_logit_gap"]["value"] < 1e-2
    t = harness.run_cell(cell, "cpu", seed, 1.0, True, time.perf_counter())
    assert t["correct"] is True
    got = set(t["metrics"])
    assert {"server.dispatch_host_ms", "server.insert_host_ms", "server.idle_share"} <= got
    assert not got & {"kernel_f_stream.roofline", "kernel_g_causal.roofline",
                      "server.stream_encode_host_ms", "server.extract_host_ms"}
    late = SimpleNamespace(cell=SimpleNamespace(traffic=dict(trace_from_s=100.0)))
    assert 0 < harness.reader(cell, "server.stream_encode_host_ms")(late) < 1e4


def test_masked_pairs_and_work_by_hand():
    """The chunked-limited mask's pairs at [70, 13] (chunks of 14, 5 back):
    14 frames, 14 x 14; 100 frames, chunk by chunk 14 x (14, 28, 42, 56, 70,
    84, 84) and the last chunk's 2 rows x 72 keys (frames 28 .. 99); the
    causal lengths of 1, 112 and 1,501 mel frames, 1, 15 and 189 encoder
    frames."""
    cfg = json.loads((tiny.REPO / "benchmark" / "configs" /
                      f"{fastconformer_tiny.REAL}.json").read_text())
    assert MODEL.masked_pairs(cfg, 14) == 14 * 14
    assert MODEL.masked_pairs(cfg, 100) == 14 * (14 + 28 + 42 + 56 + 70 + 84 + 84) + 2 * 72
    assert MODEL.enc_len(np.array([0, 1, 112, 1501])).tolist() == [0, 1, 15, 189]
    fz = MODEL.program_featurizer(cfg)
    w = MODEL.work(cfg, None, fz, [16000, 1600], [[1, 2], [3]], 2)
    frames = [fz.num_frames(16000), fz.num_frames(1600)]
    post = MODEL.enc_len(np.array(frames))
    assert w == dict(frames=2.0 * sum(frames), post_frames=2.0 * post.sum(), symbols=6.0,
                     attention_pairs=2.0 * sum(MODEL.masked_pairs(cfg, int(t)) for t in post))
    assert MODEL.least(cfg, w) > 0
    large = load("conformer_transducer", tiny.REPO)
    assert MODEL.decode_costs(cfg) == large.decode_costs(cfg)


def test_stream_rooflines_count_the_recorded_calls():
    """The readers' counts: the last profile's calls are the record's last
    run of consecutive launch numbers; a kernel launched before the profile
    (no host launch event) is not counted; F's least time per slot and head
    from the rows the mask keeps, G's from its bytes."""
    from rnnt_inference_tpu_torch.utils.profiler import REGISTRY

    old = REGISTRY.calls.get("kernel_f_stream")
    chunk, enc = torch.tensor([0, 6, 3], dtype=torch.int32), torch.tensor([5, 100, 0],
                                                                           dtype=torch.int32)
    call = lambda n: dict(launch=n, chunk=chunk, enc_len=enc, chunk_rows=14, ring=6, heads=8,
                          d_head=64, band_rows=97)
    try:
        REGISTRY.calls["kernel_f_stream"] = deque([call(3), call(4), call(9), call(10)])
        calls = MODEL.profiled_calls("kernel_f_stream")
        assert [c["launch"] for c in calls] == [9, 10]
    finally:
        if old is None:
            REGISTRY.calls.pop("kernel_f_stream", None)
        else:
            REGISTRY.calls["kernel_f_stream"] = old
    # slot 0: 5 query rows, 5 keys; slot 1 (chunk 6 of 100 frames): 14 rows,
    # keys of chunks 1..6, 84 - 0 = min(100, 98) - 14; slot 2 idle
    q, k = np.array([5, 14, 0]), np.array([5, 98 - 14, 0])
    ops = 6.0 * (q * k).sum() * 64 * 8
    nbytes = 2.0 * 8 * 64 * (q.sum() + 2 * k.sum() + 14 * 3 + 97)
    from benchmark.roofline import least

    assert MODEL.stream_f_least([call(1)]) == least(ops, nbytes, "bf16")
    g = dict(slots=128, chunk_rows=14, cache_rows=8, channels=512, taps=9)
    assert MODEL.stream_g_least([g]) == least(
        2.0 * 9 * 128 * 14 * 512, 2.0 * 512 * (2 * 128 * 14 + 2 * 128 * 8 + 9) + 4.0 * 3 * 512,
        "f32")
    ev = lambda cat, name, corr, dur=1.0: dict(cat=cat, name=name, ph="X", ts=0.0, dur=dur,
                                               args=dict(correlation=corr))
    trace = SimpleNamespace(events=[ev("cuda_runtime", "cudaLaunchKernel", 7),
                                    ev("kernel", "rel_attention_stream<64>", 7, 3.0),
                                    ev("kernel", "rel_attention_stream<64>", 5, 4.0),
                                    ev("kernel", "other", 7, 5.0)])
    trace.device = lambda cats: [e for e in trace.events if e["cat"] in cats]
    assert MODEL.traced_kernel(trace, "rel_attention_stream") == (1, 3e-6)


def test_emission_probe_decodes_the_streamed_frames():
    """emission_probe on the tiny configuration: the program's streaming
    encoder over a batch, then ``symbols(w, cap)`` per utterance, its
    frames the causal encoder lengths; at cap 1 no utterance emits more
    symbols than it has frames, and a blank raised by 30 emits none."""
    cfg = fastconformer_tiny.config()
    w = MODEL.random_weights(cfg, "cpu")
    lens = np.array([16000, 4000, 900])
    rng = np.random.RandomState(0)
    wav = torch.zeros((3, 16000))
    for i, n in enumerate(lens):
        wav[i, :n] = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
    probe = MODEL.emission_probe(cfg, w, wav, lens, "cpu")
    fz = MODEL.program_featurizer(cfg)
    want = MODEL.enc_len(np.array([fz.num_frames(int(n)) for n in lens]))
    syms, frames = probe(w, 1)
    assert frames.tolist() == want.tolist() and (syms <= frames).all()
    quiet = MODEL.apply_emission(w, dict(model="blank", amp=1.0, delta=30.0), cfg)
    assert probe(quiet, 10)[0].sum() == 0
    with MODEL.recording() as calls:
        assert calls == {}
