"""Batched greedy transducer decode (counterpart of
rnnt_inference_tpu/models/decoder.py): the bucketed decode, and the packed
one of the sequence-packed Offline runner (greedy_decode_chunk_packed).

Mask algebra (per lane, per iteration):
  update_g = (symbol != BLANK) & (symbols_added != max_symbols_per_step) & ~finish
      -> emit: append symbol, commit prediction state, keep time
  update_f = ~update_g & ~finish
      -> advance time; finish |= time >= f_lens; clamp time to eos;
         reset symbols_added

The symbol loop is a host loop.  Each trip runs up to K iterations (on
CUDA tensors one launch of kernel B, which leaves early once every lane has
finished; so does the plain twin on CPU tensors) and then reads
``finish.all()`` once.
Every update of an iteration is finish-gated, so iterations applied to
lanes that have already finished change nothing, and the tokens are the
same at any K.  The cap ``it < max_iters`` is checked for every iteration,
not once per trip.  ``steps_per_check=None`` makes the loop one trip of
``max_iters`` iterations with no host read before or after it (the Server
step, runtime/server.py): the same state, and nothing the host waits for.

Each loop is written once, as a step generator (``*_steps``) that yields
just before it reads a finish mask; the plain functions run one to its end
(``drain``).  A data-parallel runner advances one generator per shard in
turn (runtime/offline.py ``lockstep``), so every shard's launch is enqueued
before any shard's mask is read.

Packed mode (runtime/packing.py): a lane's timeline holds several
utterances back to back.  Advancing into an utterance's first frame
(``starts``) resets the lane's prediction state to what a standalone decode
begins with and writes a PACK_BOUNDARY marker into res, and each utterance
keeps at most ``utt_budget`` tokens (0: no gate).  Kernel B runs this
algebra inside its K-iteration launch (ops/decode_cuda.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Generator, Optional, Tuple

import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import rnnt as model
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.ops import projection_cuda

# iterations between two host reads of finish.all(): one kernel-B launch
# each; chip_smoke.py's symbol_loop_by_k times the choice (PERF.md)
DEFAULT_STEPS_PER_CHECK = 64

# utterance-boundary marker in packed res buffers (tokens 0..V-1, -1 pads)
PACK_BOUNDARY = dc.PACK_BOUNDARY


@dataclasses.dataclass
class DecodeState:
    """Everything carried across streaming chunks."""

    enc: Optional[model.EncoderState]  # None for an encoder that carries no state
    res: torch.Tensor  # (N, max_res_len) dc.token_dtype(num_labels), -1 padded
    res_idx: torch.Tensor  # (N,) int32, -1 = empty
    pre_g: torch.Tensor  # (N,) int32 last emitted symbol, SOS initially
    hg: torch.Tensor  # (PRED_L, N, P)
    cg: torch.Tensor  # (PRED_L, N, P) f32


def decode_state(
    enc: Optional[model.EncoderState],
    batch: int,
    params: RNNTParams = RNNTParams(),
    pred_dtype=torch.float32,
    device="cuda",
) -> DecodeState:
    """The state a decode of ``batch`` lanes starts from, carrying the
    encoder state ``enc`` (None for an encoder that carries none; the
    packed runner passes its phase's, runtime/encode_phase.py init_state)."""
    P = params.pred_hidden_size
    L = params.pred_num_layers
    return DecodeState(
        enc=enc,
        res=torch.full((batch, params.max_res_len), -1, dtype=dc.token_dtype(params.num_labels),
                       device=device),
        res_idx=torch.full((batch,), -1, dtype=torch.int32, device=device),
        pre_g=torch.full((batch,), params.SOS, dtype=torch.int32, device=device),
        hg=torch.zeros((L, batch, P), dtype=pred_dtype, device=device),
        cg=torch.zeros((L, batch, P), dtype=torch.float32, device=device),
    )


def init_decode_state(
    batch: int,
    params: RNNTParams = RNNTParams(),
    enc_dtype=torch.float32,
    pred_dtype=torch.float32,
    device="cuda",
) -> DecodeState:
    """``decode_state`` with the LSTM encoder's zero state (models/rnnt.py)
    where params have an LSTM encoder; params without one (the Conformer's,
    which sees each utterance whole) carry none."""
    enc = (model.init_encoder_state(batch, params, enc_dtype, device)
           if hasattr(params, "trans_hidden_size") else None)
    return decode_state(enc, batch, params, pred_dtype, device)


def masked_reset_decode(
    state: DecodeState,
    mask: torch.Tensor,
    params: RNNTParams = RNNTParams(),
    keep_res: bool = False,
) -> DecodeState:
    """Zero the encoder and decoder state of the lanes where mask (N,) is
    True, with pre_g SOS.  keep_res=True leaves the token buffer and its
    cursor as they are (the packed runner, whose lanes accumulate the tokens
    of consecutive utterances); keep_res=False clears them (Server slots)."""
    m1 = mask[None, :, None]
    z = lambda a: a.masked_fill(m1, 0)
    res, res_idx = state.res, state.res_idx
    if not keep_res:
        res = res.masked_fill(mask[:, None], -1)
        res_idx = res_idx.masked_fill(mask, -1)
    return DecodeState(
        enc=None if state.enc is None else model.masked_reset(state.enc, mask),
        res=res,
        res_idx=res_idx,
        pre_g=state.pre_g.masked_fill(mask, params.SOS),
        hg=z(state.hg),
        cg=z(state.cg),
    )


def drain(steps: Generator):
    """Run a step generator to its end, with no autograd, and return its
    value.  (A step generator opens no context of its own: one left open
    across a yield would leak into the other shards' turns.)"""
    with torch.no_grad():
        while True:
            try:
                next(steps)
            except StopIteration as stop:
                return stop.value


def drained(steps_fn):
    """The plain function of a step generator function: same arguments,
    run to its end (``drain``)."""

    @functools.wraps(steps_fn)
    def run(*args, **kwargs):
        return drain(steps_fn(*args, **kwargs))

    return run


def greedy_decode_chunk_steps(
    weights,
    state: DecodeState,
    f: torch.Tensor,
    f_lens: torch.Tensor,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
    steps_per_check: Optional[int] = DEFAULT_STEPS_PER_CHECK,
    dw: Optional[dc.DecodeWeights] = None,
) -> Generator[None, None, DecodeState]:
    """Run the symbol loop over one encoded chunk.
    f: {T2, N, 1024}, f_lens: {N} valid post-stack frames.  A host read of
    finish.all() every ``steps_per_check`` iterations, or none (None)."""
    return (yield from _symbol_loop(weights, state, f, f_lens, params, impl, steps_per_check,
                                    dw, {}))


def greedy_decode_chunk_packed_steps(
    weights,
    state: DecodeState,
    f: torch.Tensor,
    f_lens: torch.Tensor,
    params: RNNTParams,
    starts: torch.Tensor,
    res_base: torch.Tensor,
    utt_budget: int,
    impl: Optional[str] = None,
    steps_per_check: Optional[int] = DEFAULT_STEPS_PER_CHECK,
    dw: Optional[dc.DecodeWeights] = None,
) -> Generator[None, None, Tuple[DecodeState, torch.Tensor]]:
    """The packed symbol loop over one piece of the lanes' timelines.
    starts {T2, N} bool marks utterance-start frames, res_base {N} each
    lane's marker position of its current utterance (-1 before the first),
    utt_budget the tokens an utterance keeps (0: no gate).  Returns
    (state', res_base')."""
    rb = res_base.to(device=f.device, dtype=torch.int32).clone()
    packed = dict(starts=starts.to(device=f.device, dtype=torch.bool).contiguous(),
                  res_base=rb, utt_budget=utt_budget)
    state = yield from _symbol_loop(weights, state, f, f_lens, params, impl, steps_per_check,
                                    dw, packed)
    return state, rb


def _symbol_loop(weights, state, f, f_lens, params, impl, steps_per_check, dw, packed):
    T2, N, _ = f.shape
    dev = f.device
    jw = weights.joint
    # the joint's transcription projection, hoisted out of the symbol loop
    fproj = projection_cuda.project(f.to(jw.w1_trans.dtype), jw.w1_trans, impl=impl)  # (T2, N, J)
    dw = dw if dw is not None else dc.decode_weights(weights)
    f_lens = f_lens.to(device=dev, dtype=torch.int32)

    lanes = torch.zeros((dc.N_LANE_ROWS, N), dtype=torch.int32, device=dev)
    lanes[dc.PRE_G] = state.pre_g
    lanes[dc.RES_IDX] = state.res_idx
    lanes[dc.FINISH] = (f_lens == 0).int()
    lanes[dc.F_LENS] = f_lens
    lanes[dc.EOS] = torch.clamp(f_lens - 1, min=0)
    hg, cg, res = state.hg.clone(), state.cg.clone(), state.res.clone()

    max_iters = T2 * (params.max_symbols_per_step + 1) + 1
    if steps_per_check is None:  # one launch of every iteration the chunk may take
        dc.decode_step(fproj, lanes, hg, cg, res, dw, params, max_iters, impl, **packed)
    else:
        it = 0
        while it < max_iters:
            yield  # the other shards enqueue their launches before this read
            if bool(lanes[dc.FINISH].all()):
                break
            steps = min(steps_per_check, max_iters - it)
            dc.decode_step(fproj, lanes, hg, cg, res, dw, params, steps, impl, **packed)
            it += steps
    return DecodeState(
        enc=state.enc,
        res=res,
        res_idx=lanes[dc.RES_IDX].clone(),
        pre_g=lanes[dc.PRE_G].clone(),
        hg=hg,
        cg=cg,
    )


def decode_chunk_steps(
    weights,
    state: DecodeState,
    x: torch.Tensor,
    x_lens: torch.Tensor,
    params: RNNTParams = RNNTParams(),
    impl: Optional[str] = None,
    steps_per_check: Optional[int] = DEFAULT_STEPS_PER_CHECK,
    dw: Optional[dc.DecodeWeights] = None,
    mark: Optional[Callable[[str], None]] = None,
) -> Generator[None, None, DecodeState]:
    """Encode one feature chunk and decode it.  ``mark(phase)`` is called
    after the encoder and after the symbol loop (phase timing)."""
    f, enc = model.transcription(weights, x, x_lens, state.enc, params, impl)
    if mark is not None:
        mark("encoder")
    f_lens = -(-x_lens // params.stack_time_factor)
    state = dataclasses.replace(state, enc=enc)
    out = yield from greedy_decode_chunk_steps(weights, state, f, f_lens, params, impl,
                                               steps_per_check, dw)
    if mark is not None:
        mark("decode")
    return out


def greedy_decode_steps(
    weights,
    x: torch.Tensor,
    x_lens: torch.Tensor,
    params: RNNTParams = RNNTParams(),
    split_len: int = -1,
    impl: Optional[str] = None,
    steps_per_check: Optional[int] = DEFAULT_STEPS_PER_CHECK,
    mark: Optional[Callable[[str], None]] = None,
) -> Generator[None, None, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-utterance batched greedy decode.

    x: {T, N, 240} features, x_lens: {N} valid frames.  split_len > 0
    streams the encoder in fixed chunks carrying the LSTM state.
    Returns (res {N, max_res_len} int8 -1-padded, res_lens {N} int32).
    """
    T, N, C = x.shape
    dev = x.device
    enc_dtype = weights.pre_rnn[0].w_ih.dtype
    pred_dtype = weights.pred_rnn[0].w_ih.dtype
    state = init_decode_state(N, params, enc_dtype, pred_dtype, dev)
    x_lens = x_lens.to(device=dev, dtype=torch.int32)
    dw = dc.decode_weights(weights)
    if split_len == -1:
        state = yield from decode_chunk_steps(weights, state, x, x_lens, params, impl,
                                              steps_per_check, dw, mark)
    else:
        n_chunks = -(-T // split_len)
        xc = torch.cat([x, x.new_zeros((n_chunks * split_len - T, N, C))])
        for k in range(n_chunks):
            start = k * split_len
            chunk_lens = torch.clamp(x_lens - start, 0, split_len)
            state = yield from decode_chunk_steps(
                weights, state, xc[start : start + split_len], chunk_lens,
                params, impl, steps_per_check, dw, mark,
            )
    # res_idx counts emissions dropped past the buffer too: clamp the length
    return state.res, torch.clamp(state.res_idx + 1, max=params.max_res_len)


greedy_decode_chunk = drained(greedy_decode_chunk_steps)
greedy_decode_chunk_packed = drained(greedy_decode_chunk_packed_steps)
decode_chunk = drained(decode_chunk_steps)
greedy_decode = drained(greedy_decode_steps)
