"""Server scenario: slot-based dynamic batching with device-resident state
(counterpart of rnnt_inference_tpu/runtime/server.py).

A fixed number of slots holds the utterances in flight: a feature buffer F
{T_max, slots, 240}, each slot's length and offset, and the carried encoder
and decoder state of every slot.  New arrivals are featurized and placed
into free slots (their state reset), and each streaming step encodes and
decodes the next ``split_len`` frames of every active slot at the slot's
own offset.  A slot whose frames are used up is finished: it stays inert
(its window is empty, so its tokens do not change) until the host extracts
its tokens and frees it.

The step is decode_chunk, the streaming unit of the Offline path, so Server
and Offline give the same tokens.  On the card a step runs kernel A (the
int8 encoder) and kernel B (the decode) as the Offline runner does, with
the symbol loop as one kernel-B launch per chunk and no host read
(models/decoder.py ``steps_per_check=None``): neither a step nor an insert
waits for the card, so ``ServerRunner.step_async`` enqueues a dispatch and
returns its finish mask still in flight (``FinishMask``), and the
scheduler (runtime/scheduler.py) reads the masks back later.

``server_multi_step_dp`` runs the steps on a slot-sharded state: the slot
axis cut over a mesh's data devices (parallel/mesh.py
``server_state_sharding``), the shards in lockstep, each with its own
masked resets, offsets and ``res_idx``.

The streaming encoder is the architecture's.  The RNN-T's LSTM carries its
state in the decode state's ``enc``; NeMo's cache-aware streaming
FastConformer (models/fastconformer.py) serves from a ``StreamServerState``,
whose slots carry per-layer caches besides (the K/V ring of the attention's
last chunks and the causal depthwise convolution's last rows).  Its step
encodes one chunk of C encoder frames a slot (split_len = 8 C feature
frames, one chunk a step: kernels E, F's streaming form and G's causal form)
and decodes it on kernel B; an insert zeroes the inserted slots'
convolution caches on the device (the ring is masked by the slot's chunk
index, which the insert's offset reset starts again at 0).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import ConformerParams, FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.models import fastconformer
from rnnt_inference_tpu_torch.models import rnnt as model
from rnnt_inference_tpu_torch.models.decoder import (
    DecodeState,
    drained,
    greedy_decode_chunk_steps,
    init_decode_state,
    masked_reset_decode,
)
from rnnt_inference_tpu_torch.ops import attention_cuda, decode_cuda, depthwise_cuda
from rnnt_inference_tpu_torch.ops.features import log_mel_features
from rnnt_inference_tpu_torch.parallel.mesh import (
    join,
    join_server_state,
    server_state_sharding,
)
from rnnt_inference_tpu_torch.runtime.offline import build_kernels, lockstep
from rnnt_inference_tpu_torch.runtime.qsl import DEFAULT_WAV_BUCKETS_S
from rnnt_inference_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class ServerState:
    """The slot batch, on the device."""

    F: torch.Tensor  # {T_max, N, C} feature buffer
    F_lens: torch.Tensor  # {N} int32 frames per slot (0 = empty slot)
    offsets: torch.Tensor  # {N} int32 frames already consumed
    active: torch.Tensor  # {N} bool slot occupied and unfinished
    decode: DecodeState  # carried encoder + decoder state per slot


@dataclasses.dataclass
class StreamServerState(ServerState):
    """The slot batch of the streaming FastConformer: F holds mel frames, a
    slot's offset is its chunk index times split_len, and ``stream`` its
    per-layer caches (models/fastconformer.py StreamState)."""

    stream: fastconformer.StreamState = None


def init_server_state(
    slots: int,
    max_frames: int,
    params: RNNTParams = RNNTParams(),
    cfg: FeaturizerConfig = FeaturizerConfig(),
    enc_dtype=torch.float32,
    pred_dtype=torch.float32,
    device="cuda",
) -> ServerState:
    return ServerState(
        F=torch.zeros((max_frames, slots, cfg.out_feat), dtype=torch.float32, device=device),
        F_lens=torch.zeros((slots,), dtype=torch.int32, device=device),
        offsets=torch.zeros((slots,), dtype=torch.int32, device=device),
        active=torch.zeros((slots,), dtype=torch.bool, device=device),
        decode=init_decode_state(slots, params, enc_dtype, pred_dtype, device),
    )


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the card: on a card it
    is copied through pinned memory, which stays allocated until the copy
    has run (a pageable copy would synchronize the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def server_insert(
    state: ServerState,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    slot_ids,
    params: RNNTParams = RNNTParams(),
) -> ServerState:
    """Place K new samples into free slots: feats {T_new, K, C} (T_new <=
    T_max), feat_lens {K} (0: no sample in that column), slot_ids {K} on
    the host (unique; an id past the last slot drops its column, as JAX's
    scatter with mode="drop").  Writes their features (zeros past T_new),
    resets the slots' decode state and activates them.  F, F_lens, offsets
    and active are updated in place (F is the largest array of the state).
    Nothing here waits for the card: the columns are chosen on the host,
    and a column with feat_lens 0 is masked out on the device."""
    F = state.F
    N, dev = F.shape[1], F.device
    ids = torch.as_tensor(slot_ids).cpu().long()
    cols = torch.nonzero(ids < N).flatten()
    if not len(cols):
        return state
    sel = host_to_device(ids[cols].numpy(), dev)
    cols = host_to_device(cols.numpy(), dev)
    valid = feat_lens.to(dev).index_select(0, cols) > 0
    new = torch.zeros((F.shape[0], len(cols), F.shape[2]), dtype=F.dtype, device=dev)
    new[: feats.shape[0]] = feats.to(dev).index_select(1, cols)
    F.index_copy_(1, sel, torch.where(valid[None, :, None], new, F.index_select(1, sel)))
    lens = feat_lens.to(dev).index_select(0, cols).int()
    state.F_lens.index_copy_(0, sel, torch.where(valid, lens, state.F_lens.index_select(0, sel)))
    state.offsets.index_copy_(0, sel, state.offsets.index_select(0, sel).masked_fill(valid, 0))
    state.active.index_copy_(0, sel, state.active.index_select(0, sel) | valid)
    reset = torch.zeros_like(state.active).index_copy_(0, sel, valid)
    if isinstance(state, StreamServerState):
        with span("rnnt.server.cache_reset"):
            fastconformer.reset_slots(state.stream, sel, valid)
    return dataclasses.replace(
        state, decode=masked_reset_decode(state.decode, reset, params, keep_res=False))


def server_step_steps(
    weights,
    state: ServerState,
    split_len: int,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
    dw: Optional[decode_cuda.DecodeWeights] = None,
) -> Tuple[ServerState, torch.Tensor]:
    """One streaming step: each slot's next split_len-frame window at its own
    offset, encoded and decoded, offsets advanced.  Returns (state',
    finished {N} bool: the slots that have just completed).  The host's
    enqueue of the two halves is timed by the spans rnnt.server.encode (the
    window and the encoder) and rnnt.server.decode (the symbol loop and the
    finish mask)."""
    if isinstance(state, StreamServerState):
        return (yield from _stream_step_steps(weights, state, split_len, params, impl, dw))
    Tmax, N, C = state.F.shape
    dev = state.F.device
    with span("rnnt.server.encode"):
        t_idx = (state.offsets[None, :]
                 + torch.arange(split_len, device=dev, dtype=torch.int32)[:, None])
        t_idx = torch.clamp(t_idx, max=Tmax - 1).long()
        window = torch.gather(state.F, 0, t_idx[:, :, None].expand(-1, -1, C))  # {split, N, C}
        remaining = torch.clamp(state.F_lens - state.offsets, min=0)
        w_lens = torch.clamp(remaining, max=split_len) * state.active.int()
        f, enc = model.transcription(weights, window, w_lens, state.decode.enc, params, impl)
    with span("rnnt.server.decode"):
        f_lens = -(-w_lens // params.stack_time_factor)
        decode = yield from greedy_decode_chunk_steps(
            weights, dataclasses.replace(state.decode, enc=enc), f, f_lens, params, impl,
            steps_per_check=None, dw=dw)
        offsets = state.offsets + w_lens
        finished = state.active & (offsets >= state.F_lens)
    return ServerState(F=state.F, F_lens=state.F_lens, offsets=offsets,
                       active=state.active & ~finished, decode=decode), finished


def _stream_step_steps(weights, state: StreamServerState, split_len: int, params, impl, dw):
    """``server_step_steps`` of the streaming FastConformer: each active
    slot's next chunk (its window of mel frames gathered at its offset) through
    the encoder against its caches (span rnnt.server.stream_encode; each
    block rnnt.server.stream_layer), then decoded; a slot finishes with the
    chunk that holds its last encoder frame."""
    C = params.chunk_frames
    with span("rnnt.server.encode"), span("rnnt.server.stream_encode"):
        frames = state.F_lens * state.active.int()  # an idle slot reads no frames
        chunk = torch.div(state.offsets, split_len, rounding_mode="floor")
        enc_len = fastconformer.encoded_len(frames, params)
        win = fastconformer.gather_window(state.F, state.offsets - fastconformer.LEAD, frames,
                                          params)
        x, stream = fastconformer.encode_chunk(weights, state.stream, win, chunk, frames,
                                               enc_len, params, impl,
                                               layer_span="rnnt.server.stream_layer")
    with span("rnnt.server.decode"):
        f_lens = torch.clamp(enc_len - chunk * C, min=0, max=C)
        decode = yield from greedy_decode_chunk_steps(
            weights, state.decode, x.transpose(0, 1).contiguous(), f_lens, params, impl,
            steps_per_check=None, dw=dw)
        offsets = state.offsets + split_len * state.active.int()
        finished = state.active & ((chunk + 1) * C >= enc_len)
    return dataclasses.replace(state, offsets=offsets, active=state.active & ~finished,
                               decode=decode, stream=stream), finished


def server_multi_step_steps(
    weights,
    state: ServerState,
    split_len: int,
    k: int,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
    dw: Optional[decode_cuda.DecodeWeights] = None,
) -> Tuple[ServerState, torch.Tensor]:
    """k streaming steps; the returned mask is the OR of the k finish masks
    (finished slots stay inert until the host extracts them)."""
    fin_acc = torch.zeros_like(state.active)
    for _ in range(k):
        state, fin = yield from server_step_steps(weights, state, split_len, params, impl, dw)
        fin_acc = fin_acc | fin
    return state, fin_acc


server_step = drained(server_step_steps)
server_multi_step = drained(server_multi_step_steps)


def server_multi_step_dp(
    mesh,
    shard_weights: list,
    state: ServerState,
    split_len: int,
    k: int,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
    shard_launches: Optional[List[dict]] = None,
) -> Tuple[ServerState, torch.Tensor]:
    """``server_multi_step`` on the slot-sharded state: ``state`` cut along
    its slot axis over the mesh's data devices, k steps per shard in
    lockstep on ``shard_weights[s]``, then joined in slot order on the
    state's device.  ``shard_weights`` is ``weight_shardings(mesh,
    weights)``, made once by the caller, so a serving loop replicates the
    weights (and builds each replica's kernel operands) once and not per
    call.  Each shard's kernel launches are added to ``shard_launches[s]``
    when it is given."""
    if len(shard_weights) != mesh.shape["data"]:
        raise ValueError(f"{len(shard_weights)} weight shards for data-parallel degree "
                         f"{mesh.shape['data']}: pass weight_shardings(mesh, weights)")
    shards = server_state_sharding(mesh, state)
    steps = [server_multi_step_steps(w, s, split_len, k, params, impl)
             for w, s in zip(shard_weights, shards)]
    outs = lockstep(steps, mesh.data_devices, shard_launches)
    dev = state.F.device
    return (join_server_state([o[0] for o in outs], dev),
            join([o[1] for o in outs], 0, dev))


class FinishMask:
    """The finish mask of a dispatch, on its way to the host (the device
    array JAX's ``step_async`` returns).  On a card the mask is copied into
    pinned host memory behind the dispatch's launches and an event is
    recorded after the copy: ``cpu()`` waits for that event alone, so the
    oldest of several masks in flight is read without waiting for the
    dispatches enqueued after it, as a tensor's ``.cpu()`` would."""

    def __init__(self, mask: torch.Tensor):
        self._event = None
        self._host = mask
        if mask.is_cuda:
            with torch.cuda.device(mask.device):
                self._host = torch.empty(mask.shape, dtype=mask.dtype, pin_memory=True)
                self._host.copy_(mask, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()

    def cpu(self) -> torch.Tensor:
        """The mask on the host, once its dispatch has run."""
        if self._event is not None:
            self._event.synchronize()
        return self._host


class ServerRunner:
    """The host side of the slot pipeline: refill free slots from the
    arrival queue, run streaming steps, extract finished slots."""

    def __init__(
        self,
        weights,
        params: RNNTParams = RNNTParams(),
        cfg: FeaturizerConfig = FeaturizerConfig(),
        slots: int = 128,
        split_len: int = 24,
        max_frames: Optional[int] = None,
        insert_batch: int = 8,
        steps_per_dispatch: int = 4,
        device="cuda",
        impl: Optional[str] = None,
    ):
        """impl=None runs the CUDA kernels on the card (the plain twins on
        the CPU); impl="reference" runs the plain twins on the card too.
        Serves the RNN-T and the cache-aware streaming FastConformer (whose
        split_len is one chunk's feature frames); a full-context
        Conformer's params are refused."""
        conformer = isinstance(params, ConformerParams)
        if conformer and not params.streaming:
            raise ValueError("ServerRunner streams each utterance in split_len pieces through "
                             "state its encoder carries; the full-context Conformer attends "
                             "over whole utterances: serve it with runtime/packing.py "
                             "PackedOfflineRunner")
        if conformer:
            fastconformer.check_params(params)
            if split_len != params.subsampling_factor * params.chunk_frames:
                raise ValueError(f"the streaming FastConformer steps one chunk of "
                                 f"{params.chunk_frames} encoder frames a slot: split_len must "
                                 f"be {params.subsampling_factor * params.chunk_frames}, got "
                                 f"{split_len}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServerRunner(device='cuda') but CUDA is not available")
        self.weights = weights.to(self.device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.split_len = split_len
        self.max_frames = max_frames or cfg.out_frames(int(15.0 * cfg.sample_rate))
        # a multiple of split_len: no window straddles the buffer's end
        self.max_frames = -(-self.max_frames // split_len) * split_len
        self.insert_batch = insert_batch
        self.steps_per_dispatch = steps_per_dispatch
        self.impl = impl
        self.wav_buckets = tuple(int(s * cfg.sample_rate) for s in sorted(DEFAULT_WAV_BUCKETS_S))
        if conformer:
            state = init_server_state(slots, self.max_frames, params, cfg, weights.dtype,
                                      weights.dtype, self.device)
            self.state = StreamServerState(
                **{f.name: getattr(state, f.name) for f in dataclasses.fields(state)},
                stream=fastconformer.init_stream_state(slots, params, weights.dtype,
                                                       self.device))
            self._kernels = (attention_cuda.NAME, depthwise_cuda.NAME)
        else:
            self.state = init_server_state(
                slots, self.max_frames, params, cfg, weights.pre_rnn[0].w_ih.dtype,
                weights.pred_rnn[0].w_ih.dtype, self.device)
            self._kernels = ()
        self.free_slots = list(range(slots))
        self.slot_sample: dict = {}  # slot -> sample id
        self._dw = decode_cuda.decode_weights(self.weights)

    def _wav_bucket(self, s: int) -> int:
        for b in self.wav_buckets:
            if b >= s:
                return b
        return self.wav_buckets[-1]

    def warmup(self) -> float:
        """Build the kernels and stream one silent sample of the shortest
        wav bucket through a slot (untimed; eager PyTorch compiles nothing
        per shape, so one bucket is enough).  Returns its seconds."""
        t0 = time.time()
        build_kernels(self.device, self.impl, self._kernels)
        self.insert_samples([np.zeros(self.wav_buckets[0], np.float32)], [-1])
        while self.n_active:
            finished = self.step()
            if len(finished):
                self.extract(finished)
        return time.time() - t0

    def insert_samples(self, wavs: List[np.ndarray], sample_ids: List[int]) -> None:
        """Featurize up to insert_batch new samples (padded to a wav bucket)
        and place them in free slots."""
        if len(wavs) > len(self.free_slots) or len(wavs) > self.insert_batch:
            raise ValueError(f"{len(wavs)} samples for {len(self.free_slots)} free slots "
                             f"(insert_batch {self.insert_batch})")
        K = self.insert_batch
        S = self._wav_bucket(max(int(w.shape[0]) for w in wavs))
        wav = np.zeros((K, S), np.float32)
        lens = np.zeros((K,), np.int32)
        for r, w in enumerate(wavs):
            wav[r, : w.shape[0]] = w[:S]
            lens[r] = min(w.shape[0], S)
        with torch.inference_mode():
            feats, feat_lens = log_mel_features(
                host_to_device(wav, self.device), host_to_device(lens, self.device), self.cfg)
            # bucket padding can featurize past the slot buffer: crop (the
            # true lengths come from the waveform lengths)
            feats = feats[: self.max_frames]
            feat_lens = torch.clamp(feat_lens, max=self.max_frames)
            feat_lens[len(wavs):] = 0
            slot_ids = np.full((K,), self.slots, np.int64)
            for r in range(len(wavs)):
                slot = self.free_slots.pop(0)
                slot_ids[r] = slot
                self.slot_sample[slot] = sample_ids[r]
            self.state = server_insert(self.state, feats, feat_lens,
                                       torch.from_numpy(slot_ids), self.params)

    def step(self) -> np.ndarray:
        """One dispatch of steps_per_dispatch streaming steps; returns the
        indices of the slots that have just finished (waits for the
        dispatch)."""
        return np.nonzero(self.step_async().cpu().numpy())[0]

    def step_async(self) -> FinishMask:
        """Enqueue one dispatch of steps_per_dispatch streaming steps and
        return its finish mask (the OR over the steps) without waiting for
        the card.  A slot that has finished stays inert (its windows are
        empty, so its tokens do not change) until ``extract`` frees it, so
        a caller may read the masks of several dispatches later."""
        with torch.inference_mode():
            self.state, finished = server_multi_step(
                self.weights, self.state, self.split_len, self.steps_per_dispatch, self.params,
                self.impl, self._dw)
            return FinishMask(finished)

    def extract(self, finished_slots) -> List[Tuple[int, np.ndarray]]:
        """The tokens of finished slots, which are freed.  They are read
        from the newest state, so this waits for every dispatch enqueued."""
        idx = torch.as_tensor(np.asarray(finished_slots, np.int64), device=self.device)
        res = self.state.decode.res[idx].cpu().numpy()
        res_lens = np.minimum(self.state.decode.res_idx[idx].cpu().numpy() + 1,
                              self.params.max_res_len)
        out = []
        for k, slot in enumerate(finished_slots):
            sample_id = self.slot_sample.pop(int(slot))
            out.append((sample_id, res[k, : res_lens[k]].astype(np.int32)))
            self.free_slots.append(int(slot))
        return out

    @property
    def n_active(self) -> int:
        return self.slots - len(self.free_slots)
