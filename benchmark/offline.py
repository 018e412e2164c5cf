"""The Offline driver (traffic kind "offline"): the program's packed runner,
``runtime/packing.py PackedOfflineRunner``, over a store of the mix's
utterances, closed loop, one whole Offline query a rep.

Set-up: weights, the store made on the device and handed to the runner as
the waveform SampleStore it takes, ``stage``, one untimed rep.  The window
then runs whole reps back to back until ``seconds`` have passed; it ends
when the last rep's tokens are on the host and harvested, so the readback
and ``harvest`` count.  audio_s_per_s = the audio of every rep / the window.

A traced run profiles ``trace_reps`` reps after the untimed one instead, and
records the shapes of the kernel calls they make (``cell.model.recording``;
kernel B's work is counted from the tokens, ``cell.model.work``).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from benchmark import trace as tr_mod
from benchmark import traffic
from benchmark.common import Cell, Run, cell_program, log, sync


def run(cell: Cell, device, seed: int, seconds: float, traced: bool, t_begin: float) -> Run:
    """One run of the cell; ``t_begin`` is the process's start on
    time.perf_counter, from which set-up is counted."""
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.offline import launch_counts, launches_since
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    tr, config = cell.traffic, cell.config
    s_order, s_check = traffic.substreams(seed, 2)
    w32, served, params, cfg = cell_program(cell, device, tr["max_symbols_per_step"])

    lens, wavs = traffic.store(tr["duration"], tr["utterances"], s_order, device)
    store = SampleStore(kind="waveform", samples=wavs, transcripts=[""] * len(wavs))
    qsl = QuerySampleLibrary(store, cfg, wav_buckets_s=tr["wav_buckets_s"])
    runner = PackedOfflineRunner(served, params, cfg, n_lanes=tr["lanes"],
                                 chunk_frames=tr["chunk_frames"], batch_size=tr["lanes"],
                                 decode_chunk=tr["decode_chunk"], device=device)
    t = time.perf_counter()
    runner.stage(qsl)
    log(f"stage: {time.perf_counter() - t:.2f} s; packing efficiency "
        f"{runner.plan.packing_efficiency:.4f}, {runner.plan.n_chunks} chunks")
    t = time.perf_counter()
    runner.run_device()  # the untimed rep
    sync(device)
    log(f"untimed rep: {time.perf_counter() - t:.3f} s")

    out = Run(cell=cell, weights=w32)
    audio_s = float(lens.sum()) / traffic.SAMPLE_RATE
    out.e2e["setup_s"] = time.perf_counter() - t_begin

    results = []
    if not traced:
        t0 = time.perf_counter()
        while True:
            results.append(runner.run_device())
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        out.e2e["audio_s_per_s"] = audio_s * len(results) / window
        log(f"window: {len(results)} reps in {window:.4f} s, {audio_s:.1f} audio-s a rep")
    else:
        before = launch_counts()
        with cell.model.recording() as calls, tr_mod.profiler(torch.device(device)) as prof:
            for _ in range(tr["trace_reps"]):
                with torch.profiler.record_function(tr_mod.SPAN):
                    results.append(runner.run_device())
        out.launches = launches_since(before)
        out.calls = calls
        out.trace = tr_mod.Trace.of(tr_mod.export_events(prof))
        out.phases = [r.phase_seconds for r in results]
    if torch.device(device).type == "cuda":
        out.memory_peak = int(torch.cuda.max_memory_allocated(device))
    tokens: List[np.ndarray] = results[-1].tokens
    n = len(tokens)
    out.attempted, out.failed = n * len(results), 0
    out.work = cell.model.work(config, params, cfg, lens, tokens, len(results))
    log(f"symbols per post-stack frame in the window: "
        f"{out.work['symbols'] / out.work['post_frames']:.4f}")
    syms = [len(t) for t in tokens]
    pick = traffic.check_sample(n, tr["check_utterances"], s_check,
                                [int(np.argmax(lens)), int(np.argmax(syms))])
    out.check_wavs = [wavs[i] for i in pick]
    out.check_tokens = [tokens[i] for i in pick]
    return out
