"""Benchmark/accuracy harness, the mlperf-loadgen-shaped front door
(counterpart of rnnt_inference_tpu/runtime/harness.py: the bucketed Offline
run, host-assembled or device-resident, the sequence-packed Offline run,
SingleStream, and the accuracy log).

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
from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
from rnnt_inference_tpu_torch.utils.labels import seq_to_sen
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
) -> RunReport:
    """Offline scenario: the whole sample set as one query, end-to-end
    throughput.  device_resident=True stages a waveform store in device
    memory untimed and times only the serve loop (run_device), after one
    untimed priming pass.  packed=True serves it through the sequence-packed
    runner (runtime/packing.py, staged untimed, one untimed rep before the
    timed one) on min(batch_size, len(store)) lanes.  ``runner`` replaces the
    default OfflineRunner or PackedOfflineRunner (for example one with
    impl="reference")."""
    qsl = QuerySampleLibrary(store, cfg)
    packing = {}
    if packed:
        result, packing = _run_packed(weights, store, qsl, params, cfg, batch_size, warmup,
                                      runner, device, chunk_frames, decode_chunk)
    else:
        runner = runner or OfflineRunner(weights, params, cfg, batch_size, split_len, device)
        if device_resident and store.kind == "waveform":
            dqsl = qsl.load_to_device(batch_size, device=runner.device)
            if warmup:
                runner.warmup_device(dqsl)
                runner.run_device(dqsl)  # untimed priming pass
            result = runner.run_device(dqsl)
        else:
            if warmup:
                runner.warmup(qsl, waveform_mode=(store.kind == "waveform"))
            result = runner.run(qsl)

    wall = result.wall_seconds
    report = RunReport(
        scenario="Offline",
        samples=len(store),
        wall_seconds=wall,
        samples_per_second=len(store) / wall,
        audio_seconds_per_second=store.audio_seconds / wall,
        extra=dict(
            batches=result.batches,
            reps=1,
            batch_size=batch_size,
            rep_wall_seconds=[round(wall, 3)],
            # the bulk token transfer (device-resident and packed runs,
            # outside wall_seconds)
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


def _run_packed(weights, store, qsl, params, cfg, batch_size, warmup, runner, device,
                chunk_frames, decode_chunk):
    """The timed rep of the packed runner (staged untimed, after one untimed
    rep) and the report's packing keys."""
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner

    if store.kind != "waveform":
        raise ValueError("the packed Offline runner serves waveform stores")
    if len(store) == 0:
        raise ValueError("the packed Offline runner needs at least one utterance")
    # one lane per utterance at most: a lane with no utterance would idle
    runner = runner or PackedOfflineRunner(
        weights, params, cfg, n_lanes=min(batch_size, len(store)), chunk_frames=chunk_frames,
        batch_size=batch_size, decode_chunk=decode_chunk, device=device)
    plan = runner.stage(qsl)
    if warmup:
        runner.run_device()  # builds the kernels and pays one-off costs, untimed
    return runner.run_device(), dict(packing_efficiency=round(plan.packing_efficiency, 4),
                                     pack_chunks=plan.n_chunks,
                                     chunk_frames=runner.chunk_frames)


def eval_accuracy_log(log_path: str, references: List[str]) -> float:
    """Score an accuracy log against reference transcripts."""
    with open(log_path) as f:
        results = json.load(f)
    hyps: List[Optional[str]] = [None] * len(results)
    for r in results:
        seq = hex_to_tokens(r["data"])
        hyps[r["qsl_idx"]] = seq_to_sen(seq, len(seq))
    wer, _, _ = word_error_rate([h or "" for h in hyps], references)
    return wer


def run_single_stream(
    weights,
    store: SampleStore,
    params: RNNTParams = RNNTParams(),
    cfg: FeaturizerConfig = FeaturizerConfig(),
    split_len: int = -1,
    device="cuda",
) -> RunReport:
    """SingleStream scenario: one waveform at a time, the next issued only
    after the previous completed; the metric is the 90th-percentile latency."""
    qsl = QuerySampleLibrary(store, cfg)
    runner = OfflineRunner(weights, params, cfg, 1, split_len, device)
    runner.warmup(qsl, waveform_mode=(store.kind == "waveform"))

    n = len(store)
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
