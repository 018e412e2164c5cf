"""Offline scenario runner: sort -> bucket-batch -> featurize + encode +
decode on the card (counterpart of rnnt_inference_tpu/runtime/offline.py,
bucketed path).

``run`` assembles batches on the host from a waveform or features store;
``run_device`` serves a DeviceQSL staged in device memory and reads every
batch's tokens back in one packed transfer, timed apart from the serve loop.
With a ``mesh`` (parallel/mesh.py) every batch's lanes are cut into one
contiguous shard per data device, the shards run in ``lockstep`` and their
tokens join in lane order.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.models.decoder import drain, greedy_decode_steps
from rnnt_inference_tpu_torch.ops import (
    attention_cuda, cuda_build, decode_cuda, depthwise_cuda, lstm_cuda, lstm_scan_cuda,
    projection_cuda,
)
from rnnt_inference_tpu_torch.ops.features import log_mel_features
from rnnt_inference_tpu_torch.parallel.mesh import join, shard, weight_shardings
from rnnt_inference_tpu_torch.runtime.qsl import DeviceQSL, QuerySampleLibrary


@dataclass
class OfflineResult:
    tokens: List[np.ndarray]  # per requested sample index, in request order
    wall_seconds: float
    batches: int
    # seconds per phase ("features", "encoder", "decode"), summed over
    # batches: CUDA-event time on the card, host-clock time on the CPU
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    # run_device: the packed token readback, outside wall_seconds
    readback_seconds: float = 0.0
    # kernel launches of the timed loop, by wrapper (_KERNELS)
    launches: Dict[str, int] = field(default_factory=dict)
    # with a mesh: the same, per data shard (they sum to ``launches``)
    shard_launches: List[Dict[str, int]] = field(default_factory=list)


# the CUDA kernels a runner can launch: each wrapper counts its launches
_KERNELS = {
    "quant_lstm_layer": lstm_cuda.quant_lstm_layer_cuda,
    "lstm_recurrence": lstm_scan_cuda.lstm_recurrence_cuda,
    "decode_step": decode_cuda.decode_step_cuda,
    "projection": projection_cuda.project_cuda,
    "attention": attention_cuda.rel_attention_cuda,
    "depthwise": depthwise_cuda.depthwise_silu_cuda,
    "attention_stream": attention_cuda.rel_attention_stream_cuda,
    "depthwise_causal": depthwise_cuda.depthwise_causal_cuda,
}


def build_kernels(device: torch.device, impl: Optional[str], extra: Sequence[str] = ()) -> None:
    """Build every kernel a runner can launch (untimed set-up), and the
    ``extra`` ones its model adds: on the card unless impl="reference"."""
    if device.type == "cuda" and impl is None:
        cuda_build.build([lstm_cuda.NAME, lstm_scan_cuda.NAME, decode_cuda.NAME,
                          projection_cuda.NAME, *extra])


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _KERNELS.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


def lockstep_steps(
    steps: Sequence[Generator], devices: Sequence[torch.device],
    shard_launches: Optional[List[Dict[str, int]]] = None,
) -> Generator[None, None, list]:
    """``lockstep`` as a step generator: yields after every round in which
    each live shard advanced once."""
    values = [None] * len(steps)
    live = list(range(len(steps)))
    while live:
        for s in list(live):
            before = launch_counts()
            dev = torch.device(devices[s])
            try:
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    next(steps[s])
            except StopIteration as stop:
                values[s] = stop.value
                live.remove(s)
            if shard_launches is not None:
                for k, n in launches_since(before).items():
                    shard_launches[s][k] = shard_launches[s].get(k, 0) + n
        if live:
            yield
    return values


def lockstep(
    steps: Sequence[Generator], devices: Sequence[torch.device],
    shard_launches: Optional[List[Dict[str, int]]] = None,
) -> list:
    """Run one step generator per data shard (models/decoder.py) to its end,
    advancing each in turn to its next yield under its device's context.  A
    step generator yields just before it reads a finish mask, so in every
    round each shard's launches are enqueued before any shard's mask is
    read, and shards on k cards overlap.  Returns the generators' values in
    shard order; each shard's kernel launches are added to
    ``shard_launches[s]`` when it is given."""
    return drain(lockstep_steps(steps, devices, shard_launches))


class PhaseClock:
    """Time between consecutive marks, charged to the later mark's phase.
    On the card each mark is an event on the current device's stream."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def totals(self) -> Dict[str, float]:
        """Per-phase seconds; on the card, call after a synchronize."""
        out: Dict[str, float] = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if name == "start":  # host batch assembly between batches
                continue
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[name] = out.get(name, 0.0) + dt
        return out


class OfflineRunner:
    def __init__(
        self,
        weights,
        params: RNNTParams = RNNTParams(),
        cfg: FeaturizerConfig = FeaturizerConfig(),
        batch_size: int = 128,
        split_len: int = -1,
        device="cuda",
        impl: Optional[str] = None,
        mesh=None,
    ):
        """impl=None runs the CUDA kernels on the card (the plain twins on
        the CPU); impl="reference" runs the plain twins on the card too.

        mesh: a parallel/mesh.py Mesh.  The weights replicate over its data
        devices and each batch's lanes are cut into dp contiguous shards
        (batch_size % dp == 0), which run in ``lockstep``; the runner's
        device, where results join, is then the mesh's first data device."""
        if mesh is not None:
            dp = mesh.shape["data"]
            if batch_size % dp:
                raise ValueError(f"batch_size {batch_size} not divisible by data-parallel "
                                 f"degree {dp}")
            device = mesh.data_devices[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OfflineRunner(device='cuda') but CUDA is not available")
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.split_len = split_len
        self.impl = impl
        self.weights = weights.to(self.device)
        self.mesh = mesh
        self._shard_weights = None if mesh is None else weight_shardings(mesh, self.weights)
        self.reset_shard_launches()

    def _decode_steps(self, weights, feats, lens, mark):
        return greedy_decode_steps(weights, feats, lens, self.params, self.split_len, self.impl,
                                   mark=mark)

    def _pipeline_steps(self, weights, wav, lens, mark):
        feats, feat_lens = log_mel_features(wav, lens, self.cfg)
        mark("features")
        return (yield from self._decode_steps(weights, feats, feat_lens, mark))

    def _sharded(self, make_steps, clock: PhaseClock, *batch):
        """One batch through ``make_steps(weights, *tensors, mark)``: on the
        runner's device, or with a mesh cut into lane shards (``batch``
        holds (tensor, lane axis) pairs) that run in lockstep and join in
        lane order on the runner's device.  The first shard keeps the
        phase clock."""
        if self.mesh is None:
            return drain(make_steps(self.weights, *(t for t, _ in batch), clock.mark))
        parts = zip(*(shard(self.mesh, t, axis) for t, axis in batch))
        marks = [clock.mark] + [lambda _name: None] * (self.mesh.shape["data"] - 1)
        outs = lockstep([make_steps(w, *p, m) for w, p, m in zip(self._shard_weights, parts, marks)],
                        self.mesh.data_devices, self.shard_launches)
        return tuple(join([o[k] for o in outs], 0, self.device) for k in range(2))

    def reset_shard_launches(self) -> None:
        """With a mesh, ``shard_launches`` counts each shard's kernel
        launches from here on (a run resets it as it begins)."""
        self.shard_launches: List[Dict[str, int]] = (
            [{} for _ in range(self.mesh.shape["data"])] if self.mesh else [])

    def _decode(self, feats: torch.Tensor, lens: torch.Tensor, clock: PhaseClock):
        return self._sharded(self._decode_steps, clock, (feats, 1), (lens, 0))

    def _pipeline(self, wav: torch.Tensor, lens: torch.Tensor, clock: PhaseClock):
        clock.mark("start")
        return self._sharded(self._pipeline_steps, clock, (wav, 0), (lens, 0))

    def _pipeline_i16(
        self, wav_i16: torch.Tensor, lens: torch.Tensor, clock: PhaseClock
    ) -> torch.Tensor:
        """int16 PCM in, one int8 buffer out: each row is the tokens
        followed by the token count as two bytes (low, high)."""
        res, res_lens = self._pipeline(wav_i16.float() * (1.0 / 32768.0), lens, clock)
        lo = (res_lens & 0xFF).to(torch.int8)
        hi = (res_lens >> 8).to(torch.int8)
        return torch.cat([res, lo[:, None], hi[:, None]], dim=1)

    def transcribe(self, wav: torch.Tensor, lens: torch.Tensor):
        """One batch of waveforms {N, S} f32 -> (res {N, max_res_len} int8,
        res_lens {N} int32) on the runner's device."""
        with torch.inference_mode():
            return self._pipeline(
                wav.to(self.device), lens.to(self.device), PhaseClock(self.device)
            )

    @staticmethod
    def _unpack(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N, cap+2) int8 -> (res {N, cap} int8, res_lens {N} int32)."""
        res = packed[:, :-2]
        lens = packed[:, -2].astype(np.uint8).astype(np.int32) + (
            packed[:, -1].astype(np.int32) << 8
        )
        return res, lens

    def warmup(self, qsl: QuerySampleLibrary, waveform_mode: bool = True) -> float:
        """Build every kernel the runner can launch and run one silent batch
        of the shortest bucket (untimed set-up): the waveform pipeline, or
        the decode alone for a features store.  Returns its seconds."""
        t0 = time.time()
        build_kernels(self.device, self.impl)
        B, dev = self.batch_size, self.device
        with torch.inference_mode():
            clock = PhaseClock(dev)
            if not waveform_mode:
                T = qsl.feat_buckets[0]
                feats = torch.zeros((T, B, self.cfg.out_feat), device=dev)
                self._decode(feats, torch.full((B,), T, device=dev), clock)[1].cpu()
            else:
                S = qsl.wav_buckets[0]
                lens = torch.full((B,), S, dtype=torch.int32, device=dev)
                self._pipeline(torch.zeros((B, S), device=dev), lens, clock)[1].cpu()
        return time.time() - t0

    def warmup_device(self, dqsl: DeviceQSL) -> float:
        """Build the kernels and run one batch of each shape in a DeviceQSL
        (untimed).  Returns its seconds."""
        t0 = time.time()
        build_kernels(self.device, self.impl)
        seen = set()
        with torch.inference_mode():
            for wav, lens, _ in dqsl.batches():
                if tuple(wav.shape) in seen:
                    continue
                seen.add(tuple(wav.shape))
                self._pipeline_i16(wav, lens, PhaseClock(self.device))[:1, -2:].cpu()
        return time.time() - t0

    def dispatch_device(
        self, dqsl: DeviceQSL, clock: Optional[PhaseClock] = None
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """Enqueue every batch of a device-resident QSL and return (the
        packed token rows of all batches on the device, each row's sample
        index, -1 for padding), with no token readback (``harvest`` takes
        both)."""
        clock = clock or PhaseClock(self.device)
        self.reset_shard_launches()
        pending, row_indices = [], []
        with torch.inference_mode():
            for wav, lens, row_index in dqsl.batches():
                pending.append(self._pipeline_i16(wav, lens, clock))
                row_indices.append(row_index)
            return torch.cat(pending, dim=0), np.concatenate(row_indices)

    @classmethod
    def harvest(cls, packed: np.ndarray, row_index: np.ndarray) -> List[np.ndarray]:
        """Each sample's tokens from ``dispatch_device``'s rows, read back,
        in sample-index order."""
        results: dict = {}
        res_all, lens_all = cls._unpack(packed)
        for r, i in enumerate(row_index):
            if i >= 0:
                results[int(i)] = res_all[r, : lens_all[r]].astype(np.int32)
        return [results[i] for i in sorted(results)]

    def run_device(self, dqsl: DeviceQSL) -> OfflineResult:
        """The timed Offline loop over a device-resident QSL
        (``dispatch_device``).  wall_seconds covers dispatch and all device
        work of every batch (ended by a synchronize); the one packed token
        readback of the whole run is timed apart as readback_seconds."""
        clock = PhaseClock(self.device)
        before = launch_counts()
        t0 = time.time()
        packed, row_index = self.dispatch_device(dqsl, clock)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        launches = launches_since(before)

        t1 = time.time()
        packed_all = packed.cpu().numpy()
        readback = time.time() - t1
        return OfflineResult(
            tokens=self.harvest(packed_all, row_index),
            wall_seconds=wall,
            batches=len(dqsl),
            phase_seconds=clock.totals(),
            readback_seconds=readback,
            launches=launches,
            shard_launches=self.shard_launches,
        )

    def run(
        self, qsl: QuerySampleLibrary, indices: Optional[Sequence[int]] = None
    ) -> OfflineResult:
        """Host-assembled batches from a waveform store (the whole pipeline)
        or a features store (encoder and decode)."""
        if indices is None:
            indices = np.arange(len(qsl))
        waveform_mode = qsl.store.kind == "waveform"
        order = qsl.sort_desc(indices)
        clock = PhaseClock(self.device)
        self.reset_shard_launches()
        results: dict = {}
        before = launch_counts()
        t0 = time.time()
        n_batches = 0
        with torch.inference_mode():
            for start in range(0, len(order), self.batch_size):
                batch_idx = order[start : start + self.batch_size]
                if waveform_mode:
                    wav, lens, _ = qsl.assemble_waveforms(batch_idx, pad_n=self.batch_size)
                    res, res_lens = self._pipeline(
                        torch.from_numpy(wav).to(self.device),
                        torch.from_numpy(lens).to(self.device),
                        clock,
                    )
                else:
                    feats, lens, _ = qsl.assemble_features(batch_idx, pad_n=self.batch_size)
                    clock.mark("start")
                    res, res_lens = self._decode(
                        torch.from_numpy(feats).to(self.device),
                        torch.from_numpy(lens).to(self.device),
                        clock,
                    )
                res = res.cpu().numpy()
                res_lens = res_lens.cpu().numpy()
                for r, i in enumerate(batch_idx):
                    results[int(i)] = res[r, : res_lens[r]].astype(np.int32)
                n_batches += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        return OfflineResult(
            tokens=[results[int(i)] for i in indices],
            wall_seconds=wall,
            batches=n_batches,
            phase_seconds=clock.totals(),
            launches=launches_since(before),
            shard_launches=self.shard_launches,
        )
