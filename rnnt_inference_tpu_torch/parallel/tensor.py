"""Tensor parallelism: greedy decode with the LSTMs and the joint split over
the "model" axis of a ("data", "model") mesh.  It has no JAX namesake: in
the JAX package GSPMD partitions greedy_decode from the shardings of
parallel/mesh.py weight_shardings; here plain rank steps do the work.

Each data shard (a contiguous slice of the lanes, parallel/mesh.py) runs
on its k model ranks, each holding the weight slice of parallel/mesh.py
``rank_weights``: H/k encoder units, P/k prediction units and J/k joint
columns.  State per rank: the recurrent h of every layer at full width
(equal on every rank), c of its own units only (it never leaves the
rank), and its own copy of the lane state, tokens and res_idx.

  - Encoder (models/rnnt.py transcription): for each layer and each step,
    every rank computes h_t of its units and stores it into every rank's
    full-width h (ops/lstm_int8.py quant_lstm_layer_tp: the int8
    recurrence exchanges in_scale-quantized int8 h through a ping-pong
    (2, N, H) buffer, and y_t, of its own scale, goes to every rank's
    full-width y in the same step; ops/lstm.py lstm_layer_tp: the float
    h is y).  The float path's projection x.W_ih is each rank's product on
    its columns.  stack_time runs on every rank's full y.
  - Decoder (models/decoder.py _symbol_loop): fproj and eproj are each
    rank's products on its joint columns and prediction units; every
    iteration exchanges layer 0's h', layer 1's h' and z, then every rank
    runs the logits, the argmax and the lane algebra for all lanes on its
    own lane state (ops/decode_cuda.py decode_step_tp).  finish.all() is
    read from model rank 0, once per ``steps_per_check`` iterations;
    results are read from model rank 0.

Every step is a plain rank step (ops/lstm_int8.py quant_lstm_rank_step,
ops/lstm.py lstm_rank_step, ops/decode_cuda.py decode_step_tp_reference),
with torch.cat of the slices as the exchange.  The host issues the steps
in order, and PyTorch's copies between devices order each exchange across
cards.  Kernels A, B and C serve one card's whole grid and have no rank
mode (a rank's share of their grid ran 6-12x slower per step than the one
card's whole step), so on the card the "model" axis runs only with
impl="reference", which asks for the plain steps there (and for kernel
E's twin in the ranks' projections); impl=None raises on CUDA tensors.
On the CPU it is the parity path that the tests hold against the JAX
package's tensor parallelism.

Fake-quant weights are replicated whole (as in JAX): every rank would
compute the same, so each data shard runs the one-device decode on its
model rank 0.  The Offline runners and the Server never split over
"model".
"""

from __future__ import annotations

import dataclasses
from typing import Generator, List, Optional, Sequence, Tuple

import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import rnnt as model
from rnnt_inference_tpu_torch.models.decoder import (
    DEFAULT_STEPS_PER_CHECK,
    DecodeState,
    drained,
    greedy_decode_steps,
)
from rnnt_inference_tpu_torch.models.quant import FakeQuantRNNTWeights, QuantRNNTWeights
from rnnt_inference_tpu_torch.ops import decode_cuda as dc
from rnnt_inference_tpu_torch.ops import projection_cuda
from rnnt_inference_tpu_torch.ops.lstm import lstm_stack_tp, stack_time
from rnnt_inference_tpu_torch.ops.lstm_int8 import quant_lstm_stack_tp
from rnnt_inference_tpu_torch.parallel.mesh import Mesh, batch_sharding, join, lens_sharding
from rnnt_inference_tpu_torch.runtime.offline import lockstep_steps


def init_tp_states(ranks: Sequence, batch: int, params: RNNTParams,
                   devices: Sequence) -> List[DecodeState]:
    """Each model rank's starting DecodeState: h full width, c of its
    units (H/k, P/k), its own token buffer and lane vectors."""
    k = len(ranks)
    H, P = params.trans_hidden_size, params.pred_hidden_size
    enc_dt, pred_dt = ranks[0].pre_rnn[0].w_ih.dtype, ranks[0].pred_rnn[0].w_ih.dtype
    out = []
    for d in devices:
        z = lambda L, w, dt: torch.zeros((L, batch, w), dtype=dt, device=d)
        out.append(DecodeState(
            enc=model.EncoderState(
                pre_h=z(params.pre_num_layers, H, enc_dt),
                pre_c=z(params.pre_num_layers, H // k, torch.float32),
                post_h=z(params.post_num_layers, H, enc_dt),
                post_c=z(params.post_num_layers, H // k, torch.float32)),
            res=torch.full((batch, params.max_res_len), -1, dtype=torch.int8, device=d),
            res_idx=torch.full((batch,), -1, dtype=torch.int32, device=d),
            pre_g=torch.full((batch,), params.SOS, dtype=torch.int32, device=d),
            hg=z(params.pred_num_layers, P, pred_dt),
            cg=z(params.pred_num_layers, P // k, torch.float32)))
    return out


def transcription_tp(ranks: Sequence, x: Sequence[torch.Tensor], x_lens: Sequence[torch.Tensor],
                     enc: Sequence[model.EncoderState], params: RNNTParams,
                     impl: Optional[str] = None):
    """models/rnnt.py transcription on k model ranks (lists per rank, x[r]
    and x_lens[r] each rank's copy of the chunk).  Returns (f per rank,
    {T2, N, H} full width and equal on every rank; the carried states)."""
    if isinstance(ranks[0], QuantRNNTWeights):
        stack = lambda layers, y, h, c, last: quant_lstm_stack_tp(layers, y, h, c, last, impl)
    else:
        stack = lambda layers, y, h, c, last: lstm_stack_tp(layers, y, h, c, impl)
    y, pre_h, pre_c = stack([w.pre_rnn for w in ranks], x, [e.pre_h for e in enc],
                            [e.pre_c for e in enc], False)
    y = [stack_time(yr, lr, params.stack_time_factor) for yr, lr in zip(y, x_lens)]
    f, post_h, post_c = stack([w.post_rnn for w in ranks], y, [e.post_h for e in enc],
                              [e.post_c for e in enc], True)
    return f, [model.EncoderState(pre_h=a, pre_c=b, post_h=c, post_c=d)
               for a, b, c, d in zip(pre_h, pre_c, post_h, post_c)]


def _symbol_loop_tp(ranks, dws, states, f, f_lens, params, impl, steps_per_check):
    """models/decoder.py _symbol_loop on k model ranks; returns the ranks'
    states and lane arrays."""
    fproj = [projection_cuda.project(fr.to(w.joint.w1_trans.dtype), w.joint.w1_trans, impl=impl)
             for fr, w in zip(f, ranks)]  # (T2, N, J/k): the rank's joint columns
    T2, N = f[0].shape[:2]
    lanes = []
    for st, fl in zip(states, f_lens):
        ln = torch.zeros((dc.N_LANE_ROWS, N), dtype=torch.int32, device=fl.device)
        ln[dc.PRE_G] = st.pre_g
        ln[dc.RES_IDX] = st.res_idx
        ln[dc.FINISH] = (fl == 0).int()
        ln[dc.F_LENS] = fl
        ln[dc.EOS] = torch.clamp(fl - 1, min=0)
        lanes.append(ln)
    hg = [st.hg.clone() for st in states]
    cg = [st.cg.clone() for st in states]
    res = [st.res.clone() for st in states]
    max_iters = T2 * (params.max_symbols_per_step + 1) + 1
    it = 0
    while it < max_iters:
        yield  # the other shards enqueue their launches before this read
        if bool(lanes[0][dc.FINISH].all()):
            break
        steps = min(steps_per_check, max_iters - it)
        dc.decode_step_tp(fproj, lanes, hg, cg, res, dws, params, steps, impl)
        it += steps
    return [DecodeState(enc=st.enc, res=res[r], res_idx=lanes[r][dc.RES_IDX].clone(),
                        pre_g=lanes[r][dc.PRE_G].clone(), hg=hg[r], cg=cg[r])
            for r, st in enumerate(states)], lanes


def greedy_decode_rank_steps(
    ranks: Sequence, devices: Sequence, x: torch.Tensor, x_lens: torch.Tensor,
    params: RNNTParams = RNNTParams(), split_len: int = -1, impl: Optional[str] = None,
    steps_per_check: int = DEFAULT_STEPS_PER_CHECK, rank_states: Optional[list] = None,
) -> Generator[None, None, Tuple[torch.Tensor, torch.Tensor]]:
    """One data shard's greedy decode on its model ranks (``ranks``: the
    rank weights, ``devices``: their devices), a step generator as
    models/decoder.py greedy_decode_steps; x {T, N, 240} and x_lens {N} on
    any device.  Returns model rank 0's (res, res_lens) on its device.
    ``rank_states`` gets each rank's final {"state", "lanes"} appended as
    one list."""
    if isinstance(ranks[0], FakeQuantRNNTWeights):  # replicated: rank 0 does the work
        dev = torch.device(devices[0])
        return (yield from greedy_decode_steps(ranks[0], x.to(dev), x_lens.to(dev), params,
                                               split_len, impl, steps_per_check))
    T, N, C = x.shape
    xs = [x.to(d) for d in devices]
    ls = [x_lens.to(device=d, dtype=torch.int32) for d in devices]
    states = init_tp_states(ranks, N, params, devices)
    dws = [dc.decode_weights(w) for w in ranks]
    if split_len == -1:
        chunks = [(xs, ls)]
    else:
        n = -(-T // split_len)
        xs = [torch.cat([xr, xr.new_zeros((n * split_len - T, N, C))]) for xr in xs]
        chunks = [([xr[k * split_len:(k + 1) * split_len] for xr in xs],
                   [torch.clamp(lr - k * split_len, 0, split_len) for lr in ls])
                  for k in range(n)]
    lanes = None
    for xc, lc in chunks:
        f, enc = transcription_tp(ranks, xc, lc, [st.enc for st in states], params, impl)
        states = [dataclasses.replace(st, enc=e) for st, e in zip(states, enc)]
        f_lens = [-(-lr // params.stack_time_factor) for lr in lc]
        states, lanes = yield from _symbol_loop_tp(ranks, dws, states, f, f_lens, params, impl,
                                                   steps_per_check)
    if rank_states is not None:
        rank_states.append([{"state": st, "lanes": ln} for st, ln in zip(states, lanes)])
    # res_idx counts emissions dropped past the buffer too: clamp the length
    return states[0].res, torch.clamp(states[0].res_idx + 1, max=params.max_res_len)


def greedy_decode_tp_steps(
    mesh: Mesh, weights_by_rank: Sequence[Sequence], x: torch.Tensor, x_lens: torch.Tensor,
    params: RNNTParams = RNNTParams(), split_len: int = -1, impl: Optional[str] = None,
    steps_per_check: int = DEFAULT_STEPS_PER_CHECK, rank_states: Optional[list] = None,
) -> Generator[None, None, Tuple[torch.Tensor, torch.Tensor]]:
    """Tensor-parallel greedy decode over a ("data", "model") mesh, a step
    generator: the batch axis cut over "data" (parallel/mesh.py), each data
    shard decoded on its model ranks (``greedy_decode_rank_steps``), the
    shards advanced in lockstep (runtime/offline.py lockstep_steps).
    ``weights_by_rank`` is ``weight_shardings(mesh, w,
    tensor_parallel=True)``.  Returns (res {N, max_res_len} int8 -1-padded,
    res_lens {N} int32) joined on x's device, as models/decoder.py
    greedy_decode."""
    shards = [greedy_decode_rank_steps(weights_by_rank[s], mesh.model_devices(s), xs, ls,
                                       params, split_len, impl, steps_per_check, rank_states)
              for s, (xs, ls) in enumerate(zip(batch_sharding(mesh, x),
                                               lens_sharding(mesh, x_lens)))]
    outs = yield from lockstep_steps(shards, mesh.data_devices)
    return tuple(join([o[i] for o in outs], 0, x.device) for i in range(2))


greedy_decode_tp = drained(greedy_decode_tp_steps)
