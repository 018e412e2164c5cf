"""Benchmark/accuracy harness, the mlperf-loadgen-shaped front door
(counterpart of rnnt_inference_tpu/runtime/harness.py: the bucketed Offline
run, host-assembled or device-resident, the sequence-packed Offline run,
SingleStream, the accuracy log, and the Offline and SingleStream runs timed
by the native mini-loadgen, runtime/native.py).

Artifacts are the JAX package's, byte for byte in format:
  - accuracy log JSON [{qsl_idx, data: <hex of int32 little-endian tokens>}]
  - summary JSON with throughput (samples/s and audio-seconds/s) and WER
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner, launch_counts, launches_since
from rnnt_inference_tpu_torch.runtime.qsl import (
    DEFAULT_WAV_BUCKETS_S,
    QuerySampleLibrary,
    to_int16_pcm,
)
from rnnt_inference_tpu_torch.utils.labels import seq_to_sen
from rnnt_inference_tpu_torch.utils.profiler import TIMED_REP
from rnnt_inference_tpu_torch.utils.wer import word_error_rate


def tokens_to_hex(tokens: np.ndarray) -> str:
    """int32 little-endian hex (the reference's res_len*4-byte responses)."""
    return tokens.astype("<i4").tobytes().hex()


def hex_to_tokens(data: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(data), dtype="<i4")


@dataclass
class RunReport:
    scenario: str
    samples: int
    wall_seconds: float
    samples_per_second: float
    audio_seconds_per_second: float
    wer: Optional[float] = None
    hypotheses: List[str] = field(default_factory=list)
    extra: dict = field(default_factory=dict)
    # seconds per phase (OfflineResult.phase_seconds) and kernel launches
    # of the timed pass (OfflineResult.launches); not in the summary
    phase_seconds: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)

    def summary(self) -> dict:
        d = dict(
            scenario=self.scenario,
            samples=self.samples,
            wall_seconds=round(self.wall_seconds, 4),
            samples_per_second=round(self.samples_per_second, 2),
            audio_seconds_per_second=round(self.audio_seconds_per_second, 2),
        )
        if self.wer is not None:
            d["wer_percent"] = round(self.wer * 100, 3)
        d.update(self.extra)
        return d


def _write_outputs(output_dir: str, tokens: List[np.ndarray], report: RunReport) -> None:
    os.makedirs(output_dir, exist_ok=True)
    acc_log = [{"qsl_idx": i, "data": tokens_to_hex(t)} for i, t in enumerate(tokens)]
    with open(os.path.join(output_dir, "accuracy_log.json"), "w") as f:
        json.dump(acc_log, f)
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(report.summary(), f, indent=2)


def run_offline(
    weights,
    store: SampleStore,
    params: RNNTParams = RNNTParams(),
    cfg: FeaturizerConfig = FeaturizerConfig(),
    batch_size: int = 128,
    split_len: int = -1,
    accuracy: bool = False,
    output_dir: Optional[str] = None,
    warmup: bool = True,
    runner=None,
    device_resident: bool = False,
    packed: bool = False,
    device="cuda",
    chunk_frames: int = 16,
    decode_chunk: int = 128,
    min_duration_s: float = 0.0,
    wav_buckets_s=None,
) -> RunReport:
    """Offline scenario: the whole sample set as one query, end-to-end
    throughput.  device_resident=True stages a waveform store in device
    memory untimed and times only the serve loop (run_device), after one
    untimed priming pass.  packed=True serves it through the sequence-packed
    runner (runtime/packing.py, staged untimed, one untimed rep before the
    timed ones) on min(batch_size, len(store)) lanes.  ``runner`` replaces the
    default OfflineRunner or PackedOfflineRunner (for example one with
    impl="reference").

    Timed reps repeat until their walls sum to ``min_duration_s`` (at least
    one); ``extra`` lists every rep's wall, and the tokens, phase seconds
    and launches are the last rep's.  ``wav_buckets_s`` sets the QSL's
    waveform bucket ladder in seconds (the default ladder when None)."""
    qsl = QuerySampleLibrary(store, cfg, wav_buckets_s or DEFAULT_WAV_BUCKETS_S)
    packing = {}
    if packed:
        prunner, packing = _packed_runner(weights, store, qsl, params, cfg, batch_size, warmup,
                                          runner, device, chunk_frames, decode_chunk)
        rep = prunner.run_device
    else:
        runner = runner or OfflineRunner(weights, params, cfg, batch_size, split_len, device)
        if device_resident and store.kind == "waveform":
            dqsl = qsl.load_to_device(batch_size, device=runner.device)
            if warmup:
                runner.warmup_device(dqsl)
                runner.run_device(dqsl)  # untimed priming pass
            rep = lambda: runner.run_device(dqsl)
        else:
            if warmup:
                runner.warmup(qsl, waveform_mode=(store.kind == "waveform"))
            rep = lambda: runner.run(qsl)
    rep_walls, result = [], None
    while result is None or sum(rep_walls) < min_duration_s:
        with torch.profiler.record_function(TIMED_REP):  # read by utils/profiler.py
            result = rep()
        rep_walls.append(result.wall_seconds)

    reps, wall = len(rep_walls), sum(rep_walls)
    report = RunReport(
        scenario="Offline",
        samples=len(store) * reps,
        wall_seconds=wall,
        samples_per_second=len(store) * reps / wall,
        audio_seconds_per_second=store.audio_seconds * reps / wall,
        extra=dict(
            batches=result.batches,
            reps=reps,
            batch_size=batch_size,
            rep_wall_seconds=[round(w, 3) for w in rep_walls],
            # the bulk token transfer of the last rep (device-resident and
            # packed runs, outside wall_seconds)
            readback_seconds=round(result.readback_seconds, 3),
            **packing,
        ),
    )
    report.hypotheses = [seq_to_sen(t, len(t)) for t in result.tokens]
    report.phase_seconds = result.phase_seconds
    report.launches = result.launches
    if accuracy and any(store.transcripts):
        report.wer, _, _ = word_error_rate(report.hypotheses, store.transcripts)
    if output_dir:
        _write_outputs(output_dir, result.tokens, report)
    return report


def _packed_runner(weights, store, qsl, params, cfg, batch_size, warmup, runner, device,
                   chunk_frames, decode_chunk, mesh=None):
    """(the packed runner, staged untimed and after one untimed rep; the
    report's packing keys).  Without a mesh the lanes are capped at the
    store's size; with one, n_lanes is batch_size (it must divide by the
    data-parallel degree)."""
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner

    if store.kind != "waveform":
        raise ValueError("the packed Offline runner serves waveform stores")
    if len(store) == 0:
        raise ValueError("the packed Offline runner needs at least one utterance")
    # one lane per utterance at most: a lane with no utterance would idle
    runner = runner or PackedOfflineRunner(
        weights, params, cfg, n_lanes=min(batch_size, len(store)) if mesh is None else batch_size,
        chunk_frames=chunk_frames, batch_size=batch_size, decode_chunk=decode_chunk,
        device=device, mesh=mesh)
    plan = runner.stage(qsl)
    if warmup:
        runner.run_device()  # builds the kernels and pays one-off costs, untimed
    return runner, dict(packing_efficiency=round(plan.packing_efficiency, 4),
                        pack_chunks=plan.n_chunks, chunk_frames=runner.chunk_frames)


def _native_offline_loop(store, cfg, n, n_queries, dispatch, harvest, max_wall_s,
                         max_inflight_cycles, extra) -> RunReport:
    """The native-clock Offline serve loop over whole cycles of the sample
    set: ``dispatch()`` enqueues one cycle and returns its results on the
    device (tensors, with host arrays passed through), ``harvest(*host)``
    turns them, read back, into per-sample token lists in store order.
    Query q is sample q % n; a query completes once its cycle's tokens are
    on the host.  The wall is first issue -> last completion on the native
    loadgen's clock, the bulk token readback included.  Up to
    ``max_inflight_cycles`` cycles are dispatched before the oldest is read
    back."""
    from rnnt_inference_tpu_torch.runtime.native import NativeLoadGen

    n_cycles = -(-n_queries // n)
    sample_lens = store.lengths
    tokens_first_cycle: dict = {}
    completed_audio_samples = 0
    polled = 0
    before = launch_counts()
    lg = NativeLoadGen(n, 1.0, mode="Offline", min_query_count=n_queries)
    t_host0 = time.time()

    def poll_until(q_max: int) -> None:
        # drain the issuer's bounded queue at least past query q_max (ids
        # arrive in order; the issuer blocks while the queue is full)
        nonlocal polled
        while polled <= q_max:
            got = lg.poll(max_n=4096, timeout_us=100000)
            polled += len(got)
            if not got and lg.done_issuing:
                break

    def complete_cycle(cycle: int, results) -> None:
        nonlocal completed_audio_samples
        host = [r.cpu().numpy() if isinstance(r, torch.Tensor) else r
                for r in results]  # the bulk readback, timed
        for i, toks in enumerate(harvest(*host)):
            q = cycle * n + i
            if q >= n_queries:
                continue  # the last cycle's surplus is dead work
            poll_until(q)
            if cycle == 0:
                tokens_first_cycle[i] = toks
            # audio by the completed query's own sample (after a max_wall_s
            # break the completed queries need not be a prefix of the set)
            completed_audio_samples += int(sample_lens[i])
            lg.complete(q)

    try:
        inflight = []  # (cycle, device results)
        for cycle in range(n_cycles):
            if time.time() - t_host0 > max_wall_s:
                break
            inflight.append((cycle, dispatch()))
            while len(inflight) >= max_inflight_cycles:
                complete_cycle(*inflight.pop(0))
        while inflight:
            complete_cycle(*inflight.pop(0))
        rep = lg.report()
    finally:
        lg.close()

    wall = rep["wall_seconds"]
    report = RunReport(
        scenario="Offline",
        samples=rep["completed"],
        wall_seconds=wall,
        samples_per_second=rep["completed"] / wall if wall else 0.0,
        audio_seconds_per_second=completed_audio_samples / cfg.sample_rate / wall if wall else 0.0,
        hypotheses=[seq_to_sen(t, len(t)) for _, t in sorted(tokens_first_cycle.items())],
        extra=dict(
            completed=rep["completed"],
            issued=rep["issued"],
            qps=rep["qps"],
            performance_sample_count=n,
            queries=n_queries,
            cycles=n_cycles,
            timing="native",
            **extra,
        ),
    )
    report.launches = launches_since(before)
    return report


def run_offline_native(
    weights,
    store: SampleStore,
    params: RNNTParams = RNNTParams(),
    cfg: FeaturizerConfig = FeaturizerConfig(),
    batch_size: int = 128,
    split_len: int = -1,
    target_qps: float = 1.0,
    min_query_count: int = 0,
    min_duration_s: float = 0.0,
    samples_per_query: int = 1,
    performance_sample_count: int = 0,
    warmup: bool = True,
    wav_buckets_s=None,
    max_wall_s: float = 700.0,
    max_inflight_cycles: int = 4,
    packed: bool = False,
    chunk_frames: int = 16,
    decode_chunk: int = 128,
    device="cuda",
    mesh=None,
) -> RunReport:
    """Offline performance run with the native mini-loadgen as the one
    timing authority, the clock Server and SingleStream use too (reference:
    loadgen owns all timing, csrc/main.cpp:108-147).

    MLPerf Offline rules:
      - the QSL holds exactly ``performance_sample_count`` samples (0: the
        whole store) and queries cycle over them (query q -> sample q % psc);
      - the query count is max(min_query_count, ceil(target_qps *
        min_duration), samples_per_query, psc) (loadgen sizes its one
        Offline query as target_qps * min_duration);
      - the native issuer issues every query at t=0; a query completes only
        once its tokens are on the host, and the wall is first issue -> last
        completion on the native clock.

    Each cycle serves the whole staged set: bucketed through a DeviceQSL and
    ``OfflineRunner.dispatch_device``, or with packed=True through
    ``PackedOfflineRunner.dispatch``; up to ``max_inflight_cycles`` cycles
    are dispatched before the oldest is read back.  ``wav_buckets_s`` sets
    the QSL's padding ladder (default: runtime/qsl.py's).  Staging and
    warm-up (the kernels' build and one untimed pass) happen before the
    issuer starts (loadgen's untimed LoadSamplesToRam and warm-up).  ``mesh`` (parallel/mesh.py)
    shards each batch's lanes, or the packed lanes, over its data devices;
    the report's ``shard_launches`` holds each shard's kernel launches of
    the last cycle."""
    psc = performance_sample_count or len(store)
    if len(store) > psc:
        store = store.select(np.arange(psc))
    n = len(store)
    n_queries = max(min_query_count, int(np.ceil(target_qps * min_duration_s)),
                    samples_per_query, n)
    if store.kind != "waveform":
        raise ValueError("the native Offline run serves waveform stores")
    qsl = (QuerySampleLibrary(store, cfg, wav_buckets_s=wav_buckets_s) if wav_buckets_s
           else QuerySampleLibrary(store, cfg))
    loop = lambda dispatch, harvest, extra: _native_offline_loop(
        store, cfg, n, n_queries, dispatch, harvest, max_wall_s, max_inflight_cycles, extra)
    if packed:
        prunner, packing = _packed_runner(weights, store, qsl, params, cfg, batch_size, warmup,
                                          None, device, chunk_frames, decode_chunk, mesh)
        report = loop(prunner.dispatch, prunner.harvest, dict(packed=True, **packing))
        runner = prunner
    else:
        runner = OfflineRunner(weights, params, cfg, batch_size, split_len, device, mesh=mesh)
        dqsl = qsl.load_to_device(batch_size, device=runner.device)
        if warmup:
            runner.warmup_device(dqsl)
            runner.run_device(dqsl)  # untimed priming pass
        report = loop(lambda: runner.dispatch_device(dqsl), OfflineRunner.harvest, {})
    if mesh is not None:
        report.extra["shard_launches"] = runner.shard_launches
    return report


def accuracy_log_hypotheses(log_path: str) -> List[str]:
    """The hypotheses of an accuracy log, in qsl_idx order ("" where an
    index has no entry)."""
    with open(log_path) as f:
        results = json.load(f)
    hyps = [""] * len(results)
    for r in results:
        seq = hex_to_tokens(r["data"])
        hyps[r["qsl_idx"]] = seq_to_sen(seq, len(seq))
    return hyps


def eval_accuracy_log(log_path: str, references: List[str]) -> float:
    """Score an accuracy log against reference transcripts."""
    wer, _, _ = word_error_rate(accuracy_log_hypotheses(log_path), references)
    return wer


def run_single_stream_native(
    weights,
    store: SampleStore,
    params: RNNTParams = RNNTParams(),
    cfg: FeaturizerConfig = FeaturizerConfig(),
    min_query_count: int = 0,
    min_duration_s: float = 0.0,
    warmup: bool = True,
    max_wall_s: float = 700.0,
    device="cuda",
) -> RunReport:
    """SingleStream driven by the native mini-loadgen's issue-after-complete
    mode: the next query is issued only once the previous completed, the
    latencies are stamped on the native clock, and the conf's
    min_query_count / min_duration rules are kept by the issuer.  Each
    query runs ``_pipeline_i16`` on one waveform (int16 PCM, as DeviceQSL
    stages it) and reads its tokens back once.  The kernels are built by
    the warm-up, before the issuer starts."""
    from rnnt_inference_tpu_torch.runtime.native import NativeLoadGen
    from rnnt_inference_tpu_torch.runtime.offline import PhaseClock

    qsl = QuerySampleLibrary(store, cfg)
    runner = OfflineRunner(weights, params, cfg, 1, device=device)
    if warmup:
        runner.warmup(qsl, waveform_mode=(store.kind == "waveform"))
    dev = runner.device
    clock = PhaseClock(dev)
    hyps: dict = {}
    audio_s = 0.0
    before = launch_counts()
    lg = NativeLoadGen(len(store), target_qps=0.0, mode="SingleStream",
                       min_query_count=min_query_count, min_duration_s=min_duration_s)
    t_all = time.time()
    try:
        while not lg.drained and time.time() - t_all < max_wall_s:
            for q in lg.poll(max_n=1, timeout_us=100000):
                i = lg.sample_of(q)
                wav, lens, _ = qsl.assemble_waveforms([i])
                with torch.inference_mode():
                    packed = runner._pipeline_i16(
                        torch.from_numpy(to_int16_pcm(wav)).to(dev),
                        torch.from_numpy(lens).to(dev), clock
                    ).cpu().numpy()  # tokens and their count: one readback
                res, res_lens = OfflineRunner._unpack(packed)
                lg.complete(q)
                audio_s += store.samples[i].shape[0] / float(cfg.sample_rate)
                if i not in hyps:
                    hyps[i] = seq_to_sen(res[0, : res_lens[0]].astype(np.int32), int(res_lens[0]))
        rep = lg.report()
    finally:
        lg.close()

    wall = time.time() - t_all
    report = RunReport(
        scenario="SingleStream",
        samples=rep["completed"],
        wall_seconds=wall,
        samples_per_second=rep["completed"] / wall if wall else 0.0,
        audio_seconds_per_second=audio_s / wall if wall else 0.0,
        hypotheses=[hyps[i] for i in sorted(hyps)],
        extra={k: rep[k] for k in ("latency_ms_mean", "latency_ms_p50", "latency_ms_p90",
                                   "latency_ms_p99", "latency_ms_max", "completed", "issued")},
        launches=launches_since(before),
    )
    if any(store.transcripts) and len(hyps) == len(store):
        report.wer, _, _ = word_error_rate([hyps[i] for i in range(len(store))],
                                           store.transcripts)
    return report


def run_single_stream(
    weights,
    store: SampleStore,
    params: RNNTParams = RNNTParams(),
    cfg: FeaturizerConfig = FeaturizerConfig(),
    split_len: int = -1,
    max_samples: Optional[int] = None,
    warmup: bool = True,
    device="cuda",
) -> RunReport:
    """SingleStream scenario: one waveform at a time, the next issued only
    after the previous completed, over the first ``max_samples`` samples
    (all when None); the metric is the 90th-percentile latency."""
    qsl = QuerySampleLibrary(store, cfg)
    runner = OfflineRunner(weights, params, cfg, 1, split_len, device)
    if warmup:
        runner.warmup(qsl, waveform_mode=(store.kind == "waveform"))

    n = min(max_samples or len(store), len(store))
    latencies, hyps = [], []
    t_all = time.time()
    for i in range(n):
        t0 = time.time()
        wav, lens, _ = qsl.assemble_waveforms([i])
        res, res_lens = runner.transcribe(torch.from_numpy(wav), torch.from_numpy(lens))
        res = res.cpu().numpy()
        res_lens = res_lens.cpu().numpy()
        latencies.append((time.time() - t0) * 1e3)
        hyps.append(seq_to_sen(res[0, : res_lens[0]].astype(np.int32), int(res_lens[0])))
    wall = time.time() - t_all

    lat = np.array(latencies)
    audio_s = (
        sum(s.shape[0] for s in store.samples[:n]) / float(cfg.sample_rate)
        if store.kind == "waveform" else 0.0
    )
    report = RunReport(
        scenario="SingleStream",
        samples=n,
        wall_seconds=wall,
        samples_per_second=n / wall,
        audio_seconds_per_second=audio_s / wall,
        hypotheses=hyps,
        extra=dict(
            latency_ms_p50=round(float(np.percentile(lat, 50)), 2),
            latency_ms_p90=round(float(np.percentile(lat, 90)), 2),
            latency_ms_p99=round(float(np.percentile(lat, 99)), 2),
        ),
    )
    if any(store.transcripts):
        report.wer, _, _ = word_error_rate(hyps, store.transcripts[:n])
    return report
