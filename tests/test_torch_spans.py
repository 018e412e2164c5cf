"""The port's spans (rnnt_inference_tpu_torch/utils/profiler.py ``span``,
``REGISTRY``) on the CPU: the registry's counts, totals and rings, the
per-query record's stages, the profiler annotation opened only while a
profiler runs, the packed Offline runner's spans in a CPU trace, and the
benchmark's readers of them (benchmark/metrics/) on hand-made runs.  The
Server loop's per-query stamps are tested with its runner in
tests/test_torch_pipelined.py."""

import numpy as np
import pytest
import torch

from benchmark.common import Cell, Run
from benchmark.harness import reader
from benchmark.trace import SPAN, Trace
from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models.weights import init_weights
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
from rnnt_inference_tpu_torch.utils import profiler
from rnnt_inference_tpu_torch.utils.profiler import (
    REGISTRY,
    RING,
    QueryRecord,
    SpanStats,
    span,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

MS = 1_000_000  # ns


def test_registry_counts_totals_and_rings_spans():
    """Each span adds one count, its length to the total and its (start,
    end) to the ring, which keeps the last RING pairs; ``intervals`` picks
    the pairs that start in a window."""
    st = REGISTRY.stats("rnnt.test.registry")
    count, total = st.count, st.total_ns
    for _ in range(3):
        with span("rnnt.test.registry") as s:
            sum(range(100))
    assert st.count == count + 3 and REGISTRY.stats("rnnt.test.registry") is st
    last = list(st.ring)[-3:]
    assert last[-1] == (s.start_ns, s.end_ns)
    assert all(a <= b <= c for (a, b), (c, _) in zip(last, last[1:]))
    assert st.total_ns - total == sum(e - b for b, e in last)

    ring = SpanStats()
    for i in range(RING + 5):
        ring.add(10 * i, 10 * i + 3)
    assert ring.count == RING + 5 and ring.total_ns == 3 * (RING + 5)
    assert len(ring.ring) == RING and ring.ring[0] == (50, 53)
    assert ring.intervals(100, 130) == [(100, 103), (110, 113), (120, 123)]
    assert ring.intervals(10 * (RING + 4)) == [(10 * (RING + 4), 10 * (RING + 4) + 3)]


def test_query_record_stages():
    """Stages run from each stamp to the next; a query is left out until it
    holds every stamp, and the window picks queries by their completion."""
    rec = QueryRecord()
    rec.start_ns = 0
    for q, t0 in ((0, 100), (1, 2_000), (2, 4_000)):
        for k, name in enumerate(profiler.QUERY_STAMPS):
            rec.stamps[name][q] = (t0 + k * (k + 1)) * MS
    rec.stamps["polled"][3] = 5 * MS  # not completed yet
    del rec.stamps["inserted"][1]  # a stamp missing
    st = rec.stages()
    assert list(st["query"]) == [0, 2]
    for k, name in enumerate(profiler.QUERY_STAGES):
        np.testing.assert_array_equal(st[name], [2 * (k + 1) * MS] * 2)
    assert list(rec.stages(3.0, 5.0)["query"]) == [2]
    assert len(rec.stages(5.0)["in_slot"]) == 0


def test_span_annotates_only_while_a_profiler_runs(monkeypatch, tmp_path):
    """With no profiler running a span opens no record_function (it would
    raise here) and still counts; under torch.profiler it is a
    user_annotation around the work it spans, on the trace's clock."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        before = REGISTRY.stats("rnnt.test.off").count
        with span("rnnt.test.off"):
            torch.ones(4) + 1
        assert REGISTRY.stats("rnnt.test.off").count == before + 1
    with profiler.device_trace(str(tmp_path), "cpu") as path:
        with span("rnnt.test.on"):
            torch.ones(4) + 1
    events = profiler.load_trace(path)
    (note,) = [e for e in events if e.get("name") == "rnnt.test.on"]
    assert note["cat"] == "user_annotation"
    lo, hi = note["ts"], note["ts"] + note["dur"]
    assert any(e.get("name") == "aten::add" and lo <= e["ts"] and e["ts"] + e["dur"] <= hi
               for e in events)


def test_packed_runner_trace_holds_the_offline_spans(tmp_path):
    """A CPU trace of PackedOfflineRunner.run_device holds every
    rnnt.offline span as a user_annotation: one features, encode, decode,
    sync, readback and harvest, an encode_chunk per chunk and a
    decode_piece per decode piece, the tail after the decode."""
    params = RNNTParams(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
                        joint_hidden_size=32, max_res_len=128, max_symbols_per_step=2)
    w = init_weights(params, torch.Generator().manual_seed(5), device="cpu")
    store = SampleStore.synthetic(n=4, seed=6, min_seconds=0.3, max_seconds=0.8,
                                  mean_seconds=0.5)
    cfg = FeaturizerConfig()
    runner = PackedOfflineRunner(w, params, cfg, n_lanes=2, chunk_frames=16, batch_size=4,
                                 decode_chunk=8, device="cpu")
    plan = runner.stage(QuerySampleLibrary(store, cfg, wav_buckets_s=(1.0,)))
    with profiler.device_trace(str(tmp_path), "cpu") as path:
        result = runner.run_device()
    assert len(result.tokens) == 4
    notes = [e for e in profiler.load_trace(path)
             if e.get("cat") == "user_annotation" and e["name"].startswith("rnnt.offline.")]
    by_name = {}
    for e in notes:
        by_name.setdefault(e["name"], []).append(e)
    once = ["features", "encode", "decode", "sync", "readback", "harvest"]
    assert {k: len(v) for k, v in by_name.items()} == dict(
        {f"rnnt.offline.{n}": 1 for n in once}, **{
            "rnnt.offline.encode_chunk": plan.n_chunks,
            "rnnt.offline.decode_piece": -(-runner._shards[0]["src_idx"].shape[0] // 8)})
    start = {n: by_name[f"rnnt.offline.{n}"][0]["ts"] for n in once}
    assert sorted(start, key=start.get) == once


def _record(stages_ms, completed_s):
    """A Server record starting at 0 with one query per completion time,
    its stages (admit, in_slot, readback_wait, respond) in ms."""
    rec = QueryRecord()
    rec.start_ns = 0
    for q, (stages, done) in enumerate(zip(stages_ms, completed_s)):
        t = int(done * 1e9) - sum(stages) * MS
        rec.stamps["polled"][q] = t
        for name, ms in zip(profiler.QUERY_STAMPS[1:], stages):
            t += ms * MS
            rec.stamps[name][q] = t
    return rec


def _extract_spans():
    st = SpanStats()
    for start_s, ms in ((0.5, 2), (2.0, 4), (3.0, 6), (5.6, 50)):
        st.add(int(start_s * 1e9), int(start_s * 1e9) + ms * MS)
    return st


# queries completed at 0.5 s and 5.8 s lie outside the stretch 1-5.5 s
# (trace_from_s 6.0); the last never completes
SERVER = _record([(1, 9, 900, 90), (1, 20, 100, 5), (1, 30, 120, 7), (1, 40, 90, 3),
                  (1, 99, 999, 99)], [0.5, 2.0, 3.0, 4.0, 5.8])
SERVER.stamps["polled"][5] = int(2e9)


def _offline_trace():
    note = lambda name, ts, dur, cat="user_annotation": dict(
        name=name, cat=cat, ph="X", ts=ts, dur=dur)
    return Trace.of([
        note(SPAN, 1000, 1000), note(SPAN, 3000, 1000),
        note("rnnt.offline.readback", 1800, 50), note("rnnt.offline.harvest", 1850, 140),
        note("rnnt.offline.readback", 3900, 50), note("rnnt.offline.harvest", 3950, 100),
        note("rnnt.offline.readback", 1800, 50, "gpu_user_annotation"),
        note("rnnt.offline.harvest", 5000, 900), note("rnnt.offline.sync", 1500, 300),
        note("quant_lstm<false>", 1000, 500, "kernel"),
    ])


@pytest.mark.parametrize("metric,cell,want", [
    ("server.in_slot_ms", "int8.server.poisson", 30.0),
    ("server.readback_wait_ms", "int8.server.poisson", 100.0),
    ("server.respond_ms", "int8.server.poisson", 5.0),
    ("server.extract_host_ms", "int8.server.poisson", 5.0),
    # (50 + 140 + 50 + the harvest's 50 us inside the window) / 2 reps
    ("offline.host_tail_ms", "int8.offline.speech", 0.145),
])
def test_span_metric_reads_a_hand_made_run(monkeypatch, metric, cell, want):
    """Each reader of the program's spans on a hand-made Run: the Server's
    stage medians and extract mean over the stretch 1 s to trace_from_s -
    0.5 s of the registry's record, the Offline host tail from the traced
    window's annotations; None where there is nothing to read."""
    c = Cell.load(cell)
    read = reader(c, metric)
    monkeypatch.setattr(REGISTRY, "server", None)
    monkeypatch.setattr(REGISTRY, "spans", {})
    assert read(Run(cell=c)) is None
    if metric.startswith("server."):
        monkeypatch.setattr(REGISTRY, "server", _record([], []))
        assert read(Run(cell=c)) is None
        monkeypatch.setattr(REGISTRY, "server", SERVER)
        monkeypatch.setattr(REGISTRY, "spans", {"rnnt.server.extract": _extract_spans()})
        got = read(Run(cell=c))
    else:
        no_spans = Trace.of([e for e in _offline_trace().events
                             if not e["name"].startswith("rnnt.")])
        assert read(Run(cell=c, trace=no_spans)) is None
        got = read(Run(cell=c, trace=_offline_trace()))
    assert got == pytest.approx(want)
