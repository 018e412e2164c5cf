"""Sequence-packed Offline runner (counterpart of
rnnt_inference_tpu/runtime/packing.py).

Instead of padding every utterance to a wav bucket, packing lays the
utterances end to end along time in ``n_lanes`` timelines on a
``chunk_frames`` grain (longest first onto the least-filled lane), so the
only padding left is each utterance's last partial chunk.  One timed rep
runs three phases on the device:

  A. features: each staged wav-bucket batch is featurized (log_mel_features)
     into a flat (rows, 240) buffer; one row gather then builds the packed
     (T_pack, n_lanes, 240) buffer (pad positions gather a zero row).
  B. encoder: the architecture's encoder phase (runtime/encode_phase.py),
     chosen once from the params.  The RNN-T's is a host loop over the C
     chunks, one ``transcription`` per chunk (on the int8 path five
     kernel-A launches), the encoder state zeroed on the lanes where an
     utterance starts (``resets``).
  C. decode: the encoder outputs are compacted (chunk-tail pad frames
     gathered away) into gapless per-lane timelines and decoded in
     ``decode_chunk``-frame pieces by greedy_decode_chunk_packed, whose
     kernel B resets a lane's prediction state where it advances into an
     utterance's first frame and writes a PACK_BOUNDARY marker.  An
     utterance that starts exactly at a piece's first frame is reset here,
     between pieces, as the JAX runner does.

With ConformerParams (models/conformer.py) phase B encodes whole
utterances instead, from the flat buffer into one varlen buffer of the
whole rep; compaction reads each utterance's encoder frames out of it, and
phase C runs as above.  ``chunk_frames`` stays the packing grain.

The tokens equal a standalone decode of each utterance: the masked resets
give each utterance a fresh state, compaction feeds the decode the same
frames in the same order, and each utterance keeps at most max_res_len
tokens (the standalone decode's truncation), enforced by the per-utterance
budget.  ``harvest`` splits each lane's tokens at the markers.

The host side of a rep is timed by spans (utils/profiler.py):
rnnt.offline.features, .encode (with .encode_chunk per chunk, or for the
Conformer .subsample per group and .conformer_layer per block), .decode
(with .decode_piece per piece), then the tail, .sync, .readback and
.harvest.

With a ``mesh`` (parallel/mesh.py) the lane axis of every table (the pack
gather table, chunk lengths, resets, compaction tables) is cut into one
contiguous shard per data device; the flat feature buffer is replicated on
each device for the gather (each staged batch is featurized on one device
and copied to the others).  Phases B and C run per shard in ``lockstep``
and the token buffers join in lane order.  The pack plan, the result
capacity and the budget gate stay global, so each lane decodes exactly as
it does unsharded.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.models.decoder import (
    PACK_BOUNDARY,
    drain,
    decode_state,
    greedy_decode_chunk_packed_steps,
    masked_reset_decode,
)
from rnnt_inference_tpu_torch.ops import decode_cuda
from rnnt_inference_tpu_torch.ops.features import log_mel_features
from rnnt_inference_tpu_torch.parallel.mesh import join, lane_bounds, weight_shardings
from rnnt_inference_tpu_torch.runtime.offline import (
    OfflineResult,
    PhaseClock,
    build_kernels,
    launch_counts,
    launches_since,
    lockstep,
)
from rnnt_inference_tpu_torch.runtime import encode_phase
from rnnt_inference_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class PackPlan:
    """Host-side packing layout.

    entries: per sample (position_in_indices, lane, chunk0, n_frames): the
    sample's feature frames occupy packed frames [chunk0*P, chunk0*P + F).
    chunk_lens[c, l]: valid feature frames of lane l in chunk c (0 = idle).
    resets[c, l]: lane l starts a new utterance at chunk c.
    """

    n_lanes: int
    chunk_frames: int
    n_chunks: int
    entries: List[Tuple[int, int, int, int]]
    chunk_lens: np.ndarray  # (C, N) int32
    resets: np.ndarray  # (C, N) bool

    @property
    def total_frames(self) -> int:
        return self.n_chunks * self.chunk_frames * self.n_lanes

    @property
    def packing_efficiency(self) -> float:
        return float(self.chunk_lens.sum()) / max(self.total_frames, 1)


def make_pack_plan(feat_lens: np.ndarray, n_lanes: int, chunk_frames: int) -> PackPlan:
    """Longest-first greedy bin-pack of utterances into n_lanes timelines:
    the longest remaining utterance goes to the least-filled lane (ties to
    the lower lane), so lane fills stay within one utterance of each other."""
    feat_lens = np.asarray(feat_lens, np.int64)
    P = int(chunk_frames)
    order = np.argsort(-feat_lens, kind="stable")
    chunks_needed = -(-feat_lens // P)
    heap = [(0, l) for l in range(n_lanes)]
    heapq.heapify(heap)
    entries: List[Tuple[int, int, int, int]] = []
    for i in order:
        if feat_lens[i] <= 0:
            continue
        fill, l = heapq.heappop(heap)
        entries.append((int(i), l, int(fill), int(feat_lens[i])))
        heapq.heappush(heap, (fill + int(chunks_needed[i]), l))
    C = max(max(f for f, _ in heap), 1)

    chunk_lens = np.zeros((C, n_lanes), np.int32)
    resets = np.zeros((C, n_lanes), bool)
    for _i, l, c0, F in entries:
        nc = int(-(-F // P))
        resets[c0, l] = True
        chunk_lens[c0 : c0 + nc, l] = P
        chunk_lens[c0 + nc - 1, l] = F - (nc - 1) * P
    return PackPlan(n_lanes=n_lanes, chunk_frames=P, n_chunks=C, entries=entries,
                    chunk_lens=chunk_lens, resets=resets)


class PackedOfflineRunner:
    """Offline serving over a packed feature buffer (module docstring)."""

    def __init__(
        self,
        weights,
        params: RNNTParams = RNNTParams(),
        cfg: FeaturizerConfig = FeaturizerConfig(),
        n_lanes: int = 1024,
        chunk_frames: int = 16,
        batch_size: int = 1024,
        decode_chunk: int = 128,
        device="cuda",
        impl: Optional[str] = None,
        mesh=None,
    ):
        """impl=None runs the CUDA kernels on the card (the plain twins on
        the CPU); impl="reference" runs the plain twins on the card too.
        mesh: a parallel/mesh.py Mesh whose data devices each take a
        contiguous n_lanes / dp lanes (n_lanes % dp == 0; module
        docstring); the runner's device is then its first data device."""
        # f in the joint's input type is bit-exact: the decode's hoisted
        # fproj product casts f to it anyway
        self._f_dtype = weights.joint.w1_trans.dtype
        self._encoder = encode_phase.for_params(params, weights, chunk_frames, impl,
                                                self._f_dtype, mesh)
        if chunk_frames % self._encoder.grain:
            raise ValueError(f"chunk_frames {chunk_frames} must be a multiple of the encoder's "
                             f"time reduction {self._encoder.grain}")
        if mesh is not None:
            dp = mesh.shape["data"]
            if n_lanes % dp:
                raise ValueError(f"n_lanes {n_lanes} not divisible by data-parallel degree {dp}")
            device = mesh.data_devices[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PackedOfflineRunner(device='cuda') but CUDA is not available")
        self.params = params
        self.cfg = cfg
        self.n_lanes = n_lanes
        self.chunk_frames = chunk_frames
        self.batch_size = batch_size
        self.decode_chunk = decode_chunk
        self.impl = impl
        self.weights = weights.to(self.device)
        self.mesh = mesh
        self._shard_weights = [self.weights] if mesh is None else weight_shardings(
            mesh, self.weights)
        self._shard_devices = [self.device] if mesh is None else mesh.data_devices
        self.plan: Optional[PackPlan] = None
        self._staged = None  # [(wav_i16 {g, S}, lens {g}, flat base row)]
        self._shards: List[dict] = []  # per data shard: its lanes' device tables
        self.shard_launches: List[dict] = []  # with a mesh: per shard, last dispatch
        self._pred_dtype = weights.pred_rnn[0].w_ih.dtype

    # -- untimed staging --------------------------------------------------

    def stage(self, qsl, indices=None) -> PackPlan:
        """Stage the waveforms in device memory (DeviceQSL) and build the
        packing plan, the pack gather table and the compaction tables.
        Raises ValueError when there are fewer utterances than lanes (a lane
        would idle through the whole rep)."""
        cfg, dev = self.cfg, self.device
        P = self.chunk_frames
        idx_arr = np.arange(len(qsl)) if indices is None else np.asarray(indices)
        if len(idx_arr) < self.n_lanes:
            raise ValueError(f"{len(idx_arr)} utterances for {self.n_lanes} lanes: a lane would "
                             "idle; use at most as many lanes as utterances")
        wav_cap = qsl.wav_buckets[-1]
        wav_lens = np.array([min(qsl.store.samples[i].shape[0], wav_cap) for i in idx_arr],
                            np.int64)
        feat_lens = np.array([cfg.out_frames(int(s)) for s in wav_lens], np.int64)
        self.plan = plan = make_pack_plan(feat_lens, self.n_lanes, P)
        enc = self._encoder
        enc_lens = enc.encoded_len(feat_lens)
        enc.layout(feat_lens, enc_lens)

        # per-lane gapless timelines: src_idx gathers each utterance's
        # encoder frames out of the encoder output
        lane_entries: List[List[Tuple[int, int, int]]] = [[] for _ in range(self.n_lanes)]
        for pos, lane, c0, F in plan.entries:
            lane_entries[lane].append((c0, pos, F))
        lane_srcs, lane_starts = [], []
        self._lane_order: List[List[int]] = []  # sample positions per lane
        for lane in range(self.n_lanes):
            srcs, starts, order = [], [], []
            for c0, pos, F in sorted(lane_entries[lane]):
                F2 = int(enc_lens[pos])
                srcs.append(enc.rows(pos, c0, F2))
                s = np.zeros((F2,), bool)
                s[0] = True
                starts.append(s)
                order.append(pos)
            lane_srcs.append(np.concatenate(srcs))
            lane_starts.append(np.concatenate(starts))
            self._lane_order.append(order)
        lane_f_lens = np.array([len(s) for s in lane_srcs], np.int32)
        T2c = max(int(lane_f_lens.max()), 1)
        src_idx = np.zeros((T2c, self.n_lanes), np.int64)
        starts_arr = np.zeros((T2c, self.n_lanes), bool)
        for lane in range(self.n_lanes):
            L = lane_f_lens[lane]
            src_idx[:L, lane] = lane_srcs[lane]
            starts_arr[:L, lane] = lane_starts[lane]

        # result capacity: each utterance keeps at most min(frames * cap,
        # max_res_len) tokens (the per-utterance budget enforces the
        # standalone decode's truncation), plus its boundary marker; the
        # budget gate is switched off (0) where no utterance can exceed it
        cap = self.params.max_symbols_per_step
        budget = self.params.max_res_len
        lane_need, budget_binds = 1, False
        for lane in range(self.n_lanes):
            need = 1
            for _c0, pos, _F in lane_entries[lane]:
                F2 = int(enc_lens[pos])
                budget_binds |= F2 * cap > budget
                need += min(F2 * cap, budget) + 1
            lane_need = max(lane_need, need)
        self._utt_budget = int(budget) if budget_binds else 0
        # rounded up to a multiple of 128, as the JAX runner sizes it
        self._params_pack = dataclasses.replace(
            self.params, max_res_len=-(-lane_need // 128) * 128)

        # sample -> (lane, first packed frame) for the pack gather table
        dest0 = {int(idx_arr[pos]): (lane, c0 * P) for pos, lane, c0, _F in plan.entries}
        by_sample = dict(zip(map(int, idx_arr), feat_lens))
        dqsl = qsl.load_to_device(self.batch_size, idx_arr, device=dev)
        # flat feature buffer: a staged batch's (T_b, g, 240) features land
        # at rows base + t g + r; pack_src[t, lane] is the flat row of packed
        # frame t, and pad positions point at the zero row after the last.
        # One buffer per distinct device; batch b is featurized on the
        # (b mod k)-th of the k distinct devices
        flat_devs = list(dict.fromkeys(self._shard_devices))
        pack_src = np.full((plan.n_chunks * P, self.n_lanes), -1, np.int64)
        pos_of = {int(i): pos for pos, i in enumerate(idx_arr)}
        flat_rows = {}  # sample position -> the flat rows of its features
        staged, base = [], 0
        for b, (wav, lens, row_index) in enumerate(dqsl.batches()):
            g, S = wav.shape
            for r, i in enumerate(row_index):
                if i < 0:
                    continue
                lane, f0 = dest0[int(i)]
                F = int(by_sample[int(i)])
                flat_rows[pos_of[int(i)]] = base + np.arange(F, dtype=np.int64) * g + r
                pack_src[f0 : f0 + F, lane] = flat_rows[pos_of[int(i)]]
            on = flat_devs[b % len(flat_devs)]
            staged.append((wav.to(on), lens.to(on), base))
            base += cfg.out_frames(S) * g
        pack_src[pack_src < 0] = base  # the zero row, never written
        enc.stage(flat_rows, base, dev)
        self._staged = staged
        self._flats = {d: torch.zeros((base + 1, cfg.out_feat), dtype=torch.float32, device=d)
                       for d in flat_devs}
        self._shards = []
        for (lo, hi), d in zip(lane_bounds(self.mesh, self.n_lanes) if self.mesh else
                               [(0, self.n_lanes)], self._shard_devices):
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., lo:hi])).to(d)
            self._shards.append(dict(
                device=d, chunk_lens=t(plan.chunk_lens), resets=t(plan.resets),
                src_idx=t(src_idx), starts=t(starts_arr), lane_f_lens=t(lane_f_lens),
                pack_src=t(pack_src)))
        for d in flat_devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)  # staging completes untimed
        return plan

    # -- the timed rep ----------------------------------------------------

    def _features(self) -> List[torch.Tensor]:
        """Phase A: every staged batch featurized into the flat buffer of
        each distinct device, then each shard's phase B input from its
        device's buffer (the encoder phase's ``inputs``)."""
        for wav, lens, base in self._staged:
            feats, _ = log_mel_features(wav.float() * (1.0 / 32768.0), lens, self.cfg)
            rows = feats.reshape(-1, feats.shape[-1])  # row t g + r
            for flat in self._flats.values():
                flat[base : base + rows.shape[0]] = rows
        return self._encoder.inputs(self._flats, self._shards)

    def _decode_steps(self, sh: dict, weights, f_all: torch.Tensor):
        """Phase C on one shard's lanes: compaction, then the packed decode
        in decode_chunk-frame pieces.  Returns (res {N_shard, R} of the
        token type, res_idx {N_shard} int32)."""
        dev, pp = sh["device"], self._params_pack
        src, starts, lane_f_lens = sh["src_idx"], sh["starts"], sh["lane_f_lens"]
        N = src.shape[1]
        f_packed = self._encoder.compact(f_all, src)
        T2c = f_packed.shape[0]
        DC = min(self.decode_chunk, T2c)
        n_dc = -(-T2c // DC)
        st = decode_state(self._encoder.init_state(N, pp, self._encoder.dtype, dev), N, pp,
                          self._pred_dtype, dev)
        rb = torch.full((N,), -1, dtype=torch.int32, device=dev)
        lanes = torch.arange(N, device=dev)
        dw = decode_cuda.decode_weights(weights)
        for k in range(n_dc):
            with span("rnnt.offline.decode_piece"):
                off = k * DC
                f_c = f_packed[off : off + DC]
                starts_c = starts[off : off + DC]
                if f_c.shape[0] < DC:  # the last piece, padded: its pad frames are never visited
                    pad = DC - f_c.shape[0]
                    f_c = torch.cat([f_c, f_c.new_zeros((pad,) + f_c.shape[1:])])
                    starts_c = torch.cat([starts_c, starts_c.new_zeros((pad, N))])
                lens_c = torch.clamp(lane_f_lens - off, 0, DC)
                if off > 0:
                    # an utterance that starts at the piece's first frame is not
                    # entered inside the piece: reset it and write its marker here
                    bmask = starts_c[0] & (off < lane_f_lens)
                    st = masked_reset_decode(st, bmask, pp, keep_res=True)
                    st.res_idx = st.res_idx + bmask.int()
                    keep = bmask & (st.res_idx < pp.max_res_len)
                    st.res[lanes[keep], st.res_idx[keep].long()] = PACK_BOUNDARY
                    rb = torch.where(bmask, st.res_idx, rb)
                st, rb = yield from greedy_decode_chunk_packed_steps(
                    weights, st, f_c, lens_c, pp, starts_c, rb, self._utt_budget, self.impl, dw=dw)
        return st.res, st.res_idx

    def _shard_steps(self, sh: dict, weights, packed: torch.Tensor, mark):
        """Phases B and C of one shard, from its packed features."""
        with span("rnnt.offline.encode"):
            f_all = yield from self._encoder.steps(sh, weights, packed, mark)
        mark("encoder")
        with span("rnnt.offline.decode"):
            out = yield from self._decode_steps(sh, weights, f_all)
        mark("decode")
        return out

    def dispatch(self, clock: Optional[PhaseClock] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one whole rep (phases A, B, C) over the staged set and
        return the device tensors ``harvest`` takes, (res {N, R} of the token
        type, res_idx {N} int32), with no token readback.  The decode's host loop
        still reads one finish mask per kernel-B launch, so this returns
        only once the last decode launch has been enqueued."""
        if self._staged is None:
            raise RuntimeError("call stage() first")
        clock = clock or PhaseClock(self.device)
        with torch.inference_mode():
            clock.mark("start")
            with span("rnnt.offline.features"):
                packed = self._features()
            clock.mark("features")
            if self.mesh is None:
                return drain(self._shard_steps(self._shards[0], self.weights, packed[0],
                                               clock.mark))
            # the first shard keeps the phase clock
            marks = [clock.mark] + [lambda _name: None] * (len(self._shards) - 1)
            self.shard_launches = [{} for _ in self._shards]
            outs = lockstep([self._shard_steps(*a) for a in
                             zip(self._shards, self._shard_weights, packed, marks)],
                            self._shard_devices, self.shard_launches)
            return tuple(join([o[k] for o in outs], 0, self.device) for k in range(2))

    def run_device(self) -> OfflineResult:
        """One timed rep (``dispatch``).  wall_seconds covers dispatch and
        all device work (ended by a synchronize); the token readback is
        timed apart as readback_seconds."""
        build_kernels(self.device, self.impl, self._encoder.kernels)
        clock = PhaseClock(self.device)
        before = launch_counts()
        t0 = time.time()
        res, res_idx = self.dispatch(clock)
        with span("rnnt.offline.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        launches = launches_since(before)

        t1 = time.time()
        with span("rnnt.offline.readback"):
            res_np, idx_np = res.cpu().numpy(), res_idx.cpu().numpy()
        readback = time.time() - t1
        with span("rnnt.offline.harvest"):
            tokens = self.harvest(res_np, idx_np)
        return OfflineResult(
            tokens=tokens,
            wall_seconds=wall,
            batches=len(self._staged) + 1,
            phase_seconds=clock.totals(),
            readback_seconds=readback,
            launches=launches,
            shard_launches=self.shard_launches,
        )

    def harvest(self, res: np.ndarray, res_idx: np.ndarray) -> List[np.ndarray]:
        """Split each lane's tokens at the PACK_BOUNDARY markers into
        per-utterance sequences, in the lane's order.  Returns the tokens in
        sample-position order (the order of the staged indices)."""
        out: dict = {}
        for lane, order in enumerate(self._lane_order):
            toks = res[lane, : int(res_idx[lane]) + 1].astype(np.int32)
            segs = np.split(toks, np.flatnonzero(toks == PACK_BOUNDARY))
            segs = [segs[0]] + [s[1:] for s in segs[1:]]  # drop the markers
            if len(segs) != max(len(order), 1):
                raise RuntimeError(f"lane {lane}: {len(segs)} segments for {len(order)} samples")
            for pos, piece in zip(order, segs):
                out[pos] = piece[: self.params.max_res_len]  # the standalone decode's cap
        return [out[i] for i in sorted(out)]
