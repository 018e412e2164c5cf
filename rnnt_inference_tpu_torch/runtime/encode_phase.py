"""Phase B of the packed Offline runner (runtime/packing.py): the encoder,
one class per architecture, chosen once from the params by ``for_params``.
The runner calls every one the same way:

  grain            the encoder's time reduction; ``chunk_frames`` must be a
                   multiple of it
  kernels          the kernels it launches beyond the runner's own
                   (runtime/offline.py build_kernels builds them in set-up)
  init_state       the encoder state a decode carries between chunks, or
                   None (the packed runner's models/decoder.py
                   decode_state)
  dtype            the encoder's weight type (the decode state's init)
  encoded_len      each utterance's encoder frames, from its feature frames
  layout           (untimed) where each utterance's encoder frames will lie
  rows             the rows of the output that hold one utterance's frames,
                   read by the compaction table
  stage            (untimed) the tables that need the flat feature buffer's
                   rows
  inputs           phase A's flat buffers -> each shard's phase B input
  steps            phase B of one shard, a step generator (yield after each
                   layer's or chunk's work) returning the encoder output
  compact          that output -> each lane's gapless (T, N, H) frames

LSTMPhase is the RNN-T's: a host loop over the packed feature buffer's C
chunks, one ``transcription`` per chunk (on the int8 path five kernel-A
launches), the encoder state zeroed on the lanes where an utterance starts
(``resets``); its output is (C P2, N, H), and utterance frames are found by
chunk and lane.

ConformerPhase encodes whole utterances (models/conformer.py): each group
of utterances (longest first, up to SUBSAMPLE_FRAMES padded feature
frames) is gathered from the flat buffer and subsampled, its rows landing
in one varlen buffer of the whole rep (``conformer.varlen_layout``); then
the blocks run over all of it, one call each (kernels E, F and G).  Its
output is (rows, H), and utterance frames are found by their varlen row.
It runs on one device (no mesh).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import ConformerParams, RNNTParams
from rnnt_inference_tpu_torch.models import conformer
from rnnt_inference_tpu_torch.models import rnnt as model
from rnnt_inference_tpu_torch.ops import attention_cuda, depthwise_cuda
from rnnt_inference_tpu_torch.ops.attention_cuda import Segments
from rnnt_inference_tpu_torch.utils.profiler import span

# padded feature frames a Conformer subsampling group may hold: its first
# convolution's output is 41 KB per 20 ms of audio in bf16, 5.4 GB here
SUBSAMPLE_FRAMES = 1 << 18


class LSTMPhase:
    """The RNN-T's chunked LSTM encoder over the packed lanes (module
    docstring)."""

    kernels = ()

    @staticmethod
    def init_state(batch: int, params: RNNTParams, dtype, device) -> model.EncoderState:
        return model.init_encoder_state(batch, params, dtype, device)

    def __init__(self, params: RNNTParams, weights, chunk_frames: int, impl, f_dtype, mesh=None):
        self.params, self.chunk_frames = params, chunk_frames
        self.impl, self.f_dtype = impl, f_dtype
        self.grain = params.stack_time_factor
        self.dtype = weights.pre_rnn[0].w_ih.dtype

    def encoded_len(self, feat_lens: np.ndarray) -> np.ndarray:
        return -(-feat_lens // self.grain)

    def layout(self, feat_lens: np.ndarray, enc_lens: np.ndarray) -> None:
        pass

    def rows(self, pos: int, c0: int, n: int) -> np.ndarray:
        return c0 * (self.chunk_frames // self.grain) + np.arange(n, dtype=np.int64)

    def stage(self, flat_rows: Dict[int, np.ndarray], zero_row: int, device) -> None:
        pass

    def inputs(self, flats: dict, shards: List[dict]) -> List[torch.Tensor]:
        """Each shard's row gather of its lanes' packed features (C P,
        N_shard, 240) from its device's flat buffer."""
        return [flats[sh["device"]][sh["pack_src"]] for sh in shards]

    def steps(self, sh: dict, weights, packed: torch.Tensor, mark):
        """The encoder over the C chunks of one shard's lanes, its state
        zeroed on the lanes where an utterance starts; a step (yield) after
        each chunk.  Returns (C P2, N_shard, H) in f's type."""
        P = self.chunk_frames
        C, N = packed.shape[0] // P, packed.shape[1]
        xc = packed.reshape(C, P, N, packed.shape[-1])
        est = self.init_state(N, self.params, self.dtype, sh["device"])
        outs = []
        for c in range(C):
            with span("rnnt.offline.encode_chunk"):
                est = model.masked_reset(est, sh["resets"][c])
                f_c, est = model.transcription(weights, xc[c], sh["chunk_lens"][c], est,
                                               self.params, self.impl)
                outs.append(f_c.to(self.f_dtype))
            yield
        return torch.cat(outs)

    def compact(self, f_all: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        return torch.gather(f_all, 0, src[:, :, None].expand(-1, -1, f_all.shape[-1]))


class ConformerPhase:
    """The Conformer over whole utterances in one varlen buffer (module
    docstring)."""

    kernels = (attention_cuda.NAME, depthwise_cuda.NAME)

    @staticmethod
    def init_state(batch: int, params: ConformerParams, dtype, device) -> None:
        return None  # each utterance is encoded whole: nothing carries over

    def __init__(self, params: ConformerParams, weights, chunk_frames: int, impl, f_dtype,
                 mesh=None):
        if mesh is not None:
            raise ValueError("the Conformer runs on one device: no mesh")
        if params.streaming:
            raise ValueError("the streaming FastConformer runs on the Server's slots "
                             "(runtime/server.py ServerRunner), chunk by chunk with its caches")
        self.params, self.impl, self.f_dtype = params, impl, f_dtype
        self.grain = params.subsampling_factor
        self.dtype = weights.dtype

    def encoded_len(self, feat_lens: np.ndarray) -> np.ndarray:
        return np.array([self.params.encoded_len(int(f)) for f in feat_lens], np.int64)

    def layout(self, feat_lens: np.ndarray, enc_lens: np.ndarray) -> None:
        """The varlen buffer holds the utterances longest first, the order of
        the subsampling groups."""
        self._feat_lens, self._enc_lens = feat_lens, enc_lens
        self._order = np.argsort(-feat_lens, kind="stable")
        self._starts, self._rows = conformer.varlen_layout(enc_lens[self._order])
        self._start = np.empty_like(self._starts)
        self._start[self._order] = self._starts

    def rows(self, pos: int, c0: int, n: int) -> np.ndarray:
        return self._start[pos] + np.arange(n, dtype=np.int64)

    def stage(self, flat_rows: Dict[int, np.ndarray], zero_row: int, device) -> None:
        """Per subsampling group (runs of the order, up to SUBSAMPLE_FRAMES
        padded frames) the flat-buffer row of each (utterance, frame) (the
        zero row past its length), its frame counts and the varlen rows its
        encoder frames land on; the varlen segments and gap rows of the
        whole rep."""
        order, starts, feat_lens, enc_lens = (self._order, self._starts, self._feat_lens,
                                              self._enc_lens)
        self._device = device
        groups, g0 = [], 0
        while g0 < len(order):
            T = int(feat_lens[order[g0]])
            g1 = g0 + max(1, min(len(order) - g0, SUBSAMPLE_FRAMES // max(T, 1)))
            members = order[g0:g1]
            src = np.full((len(members), T), zero_row, np.int64)
            dest = []
            for r, pos in enumerate(members):
                src[r, : int(feat_lens[pos])] = flat_rows[int(pos)]
                dest.append(starts[g0 + r] + np.arange(enc_lens[pos], dtype=np.int64))
            groups.append(dict(src=torch.from_numpy(src).to(device),
                               lens=torch.from_numpy(feat_lens[members]).to(device),
                               dest=torch.from_numpy(np.concatenate(dest)).to(device)))
            g0 = g1
        self._groups = groups
        self._seg = Segments.of(starts, enc_lens[order], device)
        self._gaps = conformer.gap_mask(starts, enc_lens[order], self._rows, device)

    def inputs(self, flats: dict, shards: List[dict]) -> List[torch.Tensor]:
        """The flat buffer itself: the groups gather from it."""
        return [flats[self._device]]

    def steps(self, sh: dict, weights, flat: torch.Tensor, mark):
        """Each group's features gathered from the flat buffer and subsampled
        into the rep's varlen buffer (a mark "subsample" after each), then
        the blocks over all of it, a step (yield) after each.  Returns
        (rows, d_model) in f's type."""
        x = torch.zeros((self._rows, self.params.d_model), dtype=torch.float32,
                        device=self._device)
        for g in self._groups:
            with span("rnnt.offline.subsample"):
                x[g["dest"]] = conformer.subsample(weights, flat[g["src"]], g["lens"],
                                                   self.params, self.impl)
            mark("subsample")
        pe = conformer.positions(self._seg.t_max, self.params, self._device, weights.dtype)
        for b in weights.blocks:
            with span("rnnt.offline.conformer_layer"):
                x = conformer.block(b, x, pe, self._seg, self._gaps, self.params, self.impl)
            yield
        return x.to(self.f_dtype)

    def compact(self, f_all: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        return f_all[src]


def for_params(params, weights, chunk_frames: int, impl, f_dtype, mesh=None):
    """The encoder phase of ``params``' architecture."""
    cls = ConformerPhase if isinstance(params, ConformerParams) else LSTMPhase
    return cls(params, weights, chunk_frames, impl, f_dtype, mesh)
