"""Kernel B: the greedy-decode symbol loop in CUDA C++ (csrc/decode_step.cu),
and its plain PyTorch twin (one iteration).

Replaces rnnt_inference_tpu/ops/decode_pallas.py::_decode_step_kernel, with
the fproj gather and the token write folded in.  Both versions update the
decode state in place:
  lanes (8, N) int32: rows PRE_G, TIME, SYMADD, RES_IDX, FINISH, F_LENS,
        EOS (read only) and SYMBOL (the step's argmax, written);
  hg (L, N, P) in the weight dtype, cg (L, N, P) f32, res (N, R) tokens of
  ``token_dtype(V)`` (int8 up to 127 labels, int16 above).
Packed mode (``starts`` given, the sequence-packed Offline runner) adds
  starts (T2, N) bool: the first frame of each utterance on a lane's
        timeline; advancing into one resets the lane's prediction state
        (pre_g SOS, h and c zero), moves res_idx on and writes
        PACK_BOUNDARY there;
  res_base (N,) int32: the marker position of each lane's current
        utterance, updated in place;
  utt_budget: an emission writes and advances res_idx only while res_idx <
        res_base + utt_budget (0: no gate); each lane writes at most once
        per iteration, a token or a marker
(the algebra of rnnt_inference_tpu/models/decoder.py
_greedy_decode_chunk_xla with starts).

Both multiply in the weight dtype and accumulate every dot product in f32,
as the TPU kernel does (preferred_element_type=f32); the kernel sums in its
own fixed order and the twin in the matmul library's, so they agree to f32
rounding.  ``decode_step`` is the wrapper: CPU tensors take the twin, CUDA
tensors launch the kernel (the twin only for impl="reference").  One
launch runs up to ``steps`` iterations as one cooperative grid that keeps
the weights in its blocks' shared memory (``plan``, ``kernel_operands``)
and leaves early once every lane has finished.
``decode_step_cuda.launches`` counts kernel launches.  Two instantiations:
the MLPerf RNN-T's (two prediction layers, V <= 32, W2 whole in every
block; ``plan``, ``kernel_operands``) and the wide-vocabulary one (one bf16
layer, any V: W2's labels split VB to a block and a grid-wide first
maximum; ``plan_wide``, ``kernel_operands_wide``), chosen by the number of
layers.

Tensor parallelism (parallel/tensor.py; bucketed mode): ``decode_step_tp``
runs iterations on the k model ranks of a data shard, one list entry per
rank, each holding the weight slice of P/k prediction units and J/k joint
columns (parallel/mesh.py rank_weights): fproj (T2, N, J/k) its columns,
hg (L, N, P) full width and equal on every rank, cg (L, N, P/k) its
units', and its own copies of lanes and res, which every rank updates
alike.  An iteration exchanges layer 0's h', layer 1's h' and the joint's
z: each rank computes its slice and every rank gets all of it; then every
rank runs the logits (z.W2 in full, W2 replicated), the argmax and the
lane algebra for all lanes.  It runs the plain rank step,
``decode_step_tp_reference``, with the exchanges as torch.cat of the
slices.  The kernel serves one card's whole grid and has no rank mode, so
on CUDA tensors ``decode_step_tp`` runs only when impl="reference" asks
for the plain steps (it raises otherwise).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.ops import cuda_build, projection_cuda
from rnnt_inference_tpu_torch.ops.lstm import dot_f32

NAME = "decode_step"
# the utterance-boundary marker of packed res buffers (tokens are 0..V-1, -1 pads)
PACK_BOUNDARY = -2


def token_dtype(num_labels: int) -> torch.dtype:
    """The token buffer's type: int8 up to 127 labels (the MLPerf RNN-T's
    29), int16 above (the Conformer's 1,025)."""
    return torch.int8 if num_labels <= 127 else torch.int16
PRE_G, TIME, SYMADD, RES_IDX, FINISH, F_LENS, EOS, SYMBOL = range(8)
N_LANE_ROWS = 8


@dataclasses.dataclass
class DecodeWeights:
    """Prediction net + joint in the kernel's operand layout."""

    embed: torch.Tensor  # (V-1, P)
    w_ih: torch.Tensor  # (L, P, 4P)
    w_hh: torch.Tensor  # (L, P, 4P)
    b: torch.Tensor  # (L, 4P) f32
    w1p: torch.Tensor  # (P, J)
    b1: torch.Tensor  # (J,) f32
    w2: torch.Tensor  # (J, V)
    b2: torch.Tensor  # (V,) f32


def decode_weights(weights) -> DecodeWeights:
    """Stack the prediction layers of RNNTWeights / QuantRNNTWeights; kept
    with ``weights`` and made again if one of its tensors changes."""
    jw = weights.joint
    tensors = [weights.embed, jw.w1_pred, jw.b1, jw.w2, jw.b2] + [
        t for l in weights.pred_rnn for t in (l.w_ih, l.w_hh, l.b)]

    def build() -> DecodeWeights:
        dt = weights.embed.dtype
        c = lambda t: t.contiguous()
        return DecodeWeights(
            embed=c(weights.embed),
            w_ih=c(torch.stack([l.w_ih for l in weights.pred_rnn]).to(dt)),
            w_hh=c(torch.stack([l.w_hh for l in weights.pred_rnn]).to(dt)),
            b=c(torch.stack([l.b for l in weights.pred_rnn]).float()),
            w1p=c(jw.w1_pred.to(dt)),
            b1=c(jw.b1.float()),
            w2=c(jw.w2.to(dt)),
            b2=c(jw.b2.float()),
        )

    return cuda_build.cached_operands(weights, "decode_weights", tensors, build)


def decode_logits_reference(
    fproj: torch.Tensor,
    lanes: torch.Tensor,
    hg: torch.Tensor,
    cg: torch.Tensor,
    dw: DecodeWeights,
    params: RNNTParams,
):
    """The twin's products for one iteration: (logits (N, V) f32, h' (L, N,
    P) in the weight dtype, c' (L, N, P) f32) of every lane, from pre_g,
    the committed h and c and fproj at each lane's time."""
    wdt = dw.embed.dtype
    pre_g = lanes[PRE_G]
    fi = fproj[lanes[TIME].long(), torch.arange(lanes.shape[1], device=lanes.device)]  # (N, J)
    sos = pre_g == params.SOS
    y = dw.embed[torch.where(sos, 0, pre_g).long()].masked_fill(sos[:, None], 0)
    hs, cs = [], []
    for l in range(hg.shape[0]):
        xw = dot_f32(y, dw.w_ih[l]) + dw.b[l]
        gates = xw + dot_f32(hg[l], dw.w_hh[l])
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * cg[l] + torch.sigmoid(i) * torch.tanh(g)
        y = (torch.sigmoid(o) * torch.tanh(c_new)).to(wdt)
        hs.append(y)
        cs.append(c_new)
    z = torch.clamp(fi + dot_f32(y, dw.w1p) + dw.b1, min=0.0).to(wdt)
    return dot_f32(z, dw.w2) + dw.b2, torch.stack(hs), torch.stack(cs)


def decode_step_reference(
    fproj: torch.Tensor,
    lanes: torch.Tensor,
    hg: torch.Tensor,
    cg: torch.Tensor,
    res: torch.Tensor,
    dw: DecodeWeights,
    params: RNNTParams,
    starts: Optional[torch.Tensor] = None,
    res_base: Optional[torch.Tensor] = None,
    utt_budget: int = 0,
) -> None:
    """One decode iteration in plain PyTorch (kernel B's twin), in place;
    packed mode where ``starts`` is given."""
    logits, h_new, c_new = decode_logits_reference(fproj, lanes, hg, cg, dw, params)
    _apply_iteration(lanes, hg, cg, res, logits, h_new, c_new, params, starts, res_base,
                     utt_budget)


def _apply_iteration(lanes, hg, cg, res, logits, h_new, c_new, params: RNNTParams,
                     starts=None, res_base=None, utt_budget: int = 0) -> None:
    """The lane algebra of one iteration given its logits and new h, c, in
    place (hg and h_new full width; cg and c_new the units the caller
    holds)."""
    N = lanes.shape[1]
    R = res.shape[1]
    pre_g, time_idx, symadd, res_idx = lanes[PRE_G], lanes[TIME], lanes[SYMADD], lanes[RES_IDX]
    finish = lanes[FINISH] != 0
    ar = torch.arange(N, device=lanes.device)
    symbols = torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum

    update_g = (symbols != params.BLANK) & (symadd != params.max_symbols_per_step) & ~finish
    adv = update_g
    if starts is not None and utt_budget > 0:
        adv = update_g & (res_idx < res_base + utt_budget)
    new_res_idx = res_idx + adv.int()
    write_idx = torch.where(adv, new_res_idx, R)
    new_symadd = symadd + update_g.int()
    new_pre_g = torch.where(update_g, symbols, pre_g)
    update_f = ~update_g & ~finish
    new_time = time_idx + update_f.int()
    new_finish = finish | (new_time >= lanes[F_LENS])
    new_time = torch.minimum(new_time, lanes[EOS])
    new_symadd = torch.where(update_f, 0, new_symadd)
    val = symbols
    if starts is not None:  # advanced into the first frame of an utterance
        entering = update_f & ~new_finish & (new_time > time_idx) & starts[new_time.long(), ar]
        new_pre_g = torch.where(entering, params.SOS, new_pre_g)
        new_res_idx = new_res_idx + entering.int()
        write_idx = torch.where(entering, new_res_idx, write_idx)
        val = torch.where(entering, PACK_BOUNDARY, symbols)
        res_base.copy_(torch.where(entering, new_res_idx, res_base))
        hg.masked_fill_(entering[None, :, None], 0)
        cg.masked_fill_(entering[None, :, None], 0)

    keep = (write_idx >= 0) & (write_idx < R)
    res[ar[keep], write_idx[keep].long()] = val[keep].to(res.dtype)
    sel = update_g[None, :, None]
    hg.copy_(torch.where(sel, h_new, hg))
    cg.copy_(torch.where(sel, c_new, cg))
    lanes[PRE_G] = new_pre_g
    lanes[TIME] = new_time
    lanes[SYMADD] = new_symadd
    lanes[RES_IDX] = new_res_idx
    lanes[FINISH] = new_finish.int()
    lanes[SYMBOL] = symbols


def decode_step_tp_reference(fproj, lanes, hg, cg, res, dw, params: RNNTParams) -> None:
    """One decode iteration on the k model ranks of a data shard, in
    plain PyTorch, in place (lists per rank, as
    ``decode_step_tp``): each rank computes layer 0's, layer 1's and the
    joint's slices on its weights, every rank getting all of each by a
    torch.cat of the slices; then each applies the logits of the full z to
    its own lane state."""
    k = len(lanes)
    devs = [t.device for t in lanes]
    wdt = dw[0].embed.dtype
    gather = lambda parts: [torch.cat([t.to(d) for t in parts], dim=-1) for d in devs]
    ys = []
    for r in range(k):
        pre_g = lanes[r][PRE_G]
        sos = pre_g == params.SOS
        ys.append(dw[r].embed[torch.where(sos, 0, pre_g).long()].masked_fill(sos[:, None], 0))
    hs, cs = [[] for _ in range(k)], [[] for _ in range(k)]
    for l in range(hg[0].shape[0]):
        parts = []
        for r in range(k):
            xw = dot_f32(ys[r], dw[r].w_ih[l]) + dw[r].b[l]
            i, f, g, o = (xw + dot_f32(hg[r][l], dw[r].w_hh[l])).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * cg[r][l] + torch.sigmoid(i) * torch.tanh(g)
            parts.append((torch.sigmoid(o) * torch.tanh(c_new)).to(wdt))
            cs[r].append(c_new)
        ys = gather(parts)
        for r in range(k):
            hs[r].append(ys[r])
    zs = []
    for r in range(k):
        N = lanes[r].shape[1]
        fi = fproj[r][lanes[r][TIME].long(), torch.arange(N, device=devs[r])]
        zs.append(torch.clamp(fi + dot_f32(ys[r], dw[r].w1p) + dw[r].b1, min=0.0).to(wdt))
    z = gather(zs)
    for r in range(k):
        _apply_iteration(lanes[r], hg[r], cg[r], res[r], dot_f32(z[r], dw[r].w2) + dw[r].b2,
                         torch.stack(hs[r]), torch.stack(cs[r]), params)


UJ = 8  # joint columns per block
VP = 32  # labels padded: W2's columns in the kernel's operand
UP = 4  # prediction units per block the kernel is built for


@functools.lru_cache(maxsize=64)
def plan(P: int, J: int, V: int, N: int, L: int, dtype: torch.dtype, sms: int):
    """(UP, least shared bytes per block) for kernel B on a card with ``sms``
    SMs: P / UP prediction blocks and J / UJ joint blocks, one to an SM (the
    staging ring then takes the rest of shared memory).  Raises ValueError
    for a shape the kernel cannot take."""
    if L != 2:
        raise ValueError(f"kernel B runs two prediction layers, got {L}")
    if P <= 0 or J <= 0 or P % 64 or J % 64:
        raise ValueError(f"kernel B needs P and J multiples of 64, got P={P} J={J}")
    if not 1 <= V <= VP:
        raise ValueError(f"kernel B takes 1..{VP} labels, got V={V}")
    for what, blocks in (("P", P // UP), ("J", J // UJ)):
        if blocks > sms:
            raise ValueError(f"kernel B: {what} needs {blocks} blocks, the card has {sms} SMs")
    mt = cuda_build.rows(dtype)[0]
    es = 2 if dtype == torch.bfloat16 else 4
    smem = (P * (8 * UP + UJ + 4 * UP) * es + cuda_build.ring_min_bytes(dtype)
            + (J * VP * es if dtype == torch.bfloat16 else 0)  # W2 in shared memory
            + (mt * VP + V * UP * 4) * 4 + 4 * N * UP * 4 + 3 * -(-N // 4) * 16)
    if smem > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(
            f"kernel B: N={N} lanes need {smem} bytes of shared memory per block, "
            f"more than {cuda_build.SMEM_PER_BLOCK}"
        )
    return UP, smem


def _gates(w: torch.Tensor, UP: int) -> torch.Tensor:
    """(K, 4P) gate columns -> (P/UP, K, UP, 4): block, input, unit, gate."""
    K, G = w.shape
    return w.reshape(K, 4, G // 4 // UP, UP).permute(2, 0, 3, 1)


def _joint_columns(UP: int, dtype: torch.dtype) -> torch.Tensor:
    """Order of the joint pass's UJ + 4UP columns over [W1p's UJ | W_hh[1]'s
    4u + g]: bf16 the UJ joint columns (n-tile 0), then the units in
    cuda_build.gate_columns order; f32 lane 4m + q's 2 + UP columns, its
    joint columns 2q, 2q + 1 and then the gates of its units."""
    if dtype == torch.bfloat16:
        return torch.cat([torch.arange(UJ), UJ + cuda_build.gate_columns(UP, dtype)])
    sl = UP // 4
    return torch.tensor([2 * q + x if x < 2 else UJ + 4 * (q * sl + (x - 2) // 4) + (x - 2) % 4
                         for q in range(4) for x in range(2 + UP)])


def kernel_operands(dw: DecodeWeights, UP: int):
    """(whh, w1, w2, wout, eproj), the weights in kernel B's per-block order
    (two prediction layers):
      whh {P/UP, 2, P, 4UP}: block b's W_hh columns (gate g of unit b UP +
          u) per layer, in cuda_build.gate_columns order (the launch's first
          h.W_hh);
      w1 {P/UP, P, 8UP}: layer 1's pass on y = layer 0's h': W_ih[1]'s and
          W_hh[0]'s columns of the block's units, as 2UP units (layer 1's,
          then layer 0's) in gate_columns order;
      w2 {nb, P, UJ + 4UP}, nb = max(P/UP, J/UJ): the joint's pass on
          y = layer 1's h': W1p's columns b UJ .. and W_hh[1]'s of the
          block's units (zeros where the block has none), in _joint_columns
          order;
      wout {J, VP}: W2 padded with zero columns;
    in bf16 each then in mma fragment order (cuda_build.b_fragments).
    eproj {P/UP, V, UP, 4} f32: layer 0's input gates for every embedding
    row, embed . W_ih[0] + b[0] (f32 sums; kernel E on the card), and in row V-1
    those of SOS's zero embedding, b[0]."""
    L, P, G = dw.w_ih.shape
    J, V = dw.w2.shape
    dt, dev = dw.w2.dtype, dw.w2.device
    nbp, nbj = G // 4 // UP, dw.w1p.shape[1] // UJ
    nb = max(nbp, nbj)
    order = lambda U: cuda_build.gate_columns(U, dt).to(dev)
    whh = torch.stack([_gates(dw.w_hh[l], UP) for l in range(L)], dim=1).reshape(
        nbp, L, P, 4 * UP)[..., order(UP)]
    w1 = torch.cat([_gates(dw.w_ih[1], UP), _gates(dw.w_hh[0], UP)], dim=2).reshape(
        nbp, P, 8 * UP)[..., order(2 * UP)]
    w2 = w1.new_zeros((nb, P, UJ + 4 * UP))
    w2[:nbj, :, :UJ] = dw.w1p.reshape(P, nbj, UJ).permute(1, 0, 2)
    w2[:nbp, :, UJ:] = _gates(dw.w_hh[1], UP).reshape(nbp, P, 4 * UP)
    w2 = w2[..., _joint_columns(UP, dt).to(dev)]
    wout = torch.cat([dw.w2, dw.w2.new_zeros((J, VP - V))], dim=1)
    ops = (whh, w1, w2, wout)
    if dt == torch.bfloat16:
        ops = tuple(cuda_build.b_fragments(t) for t in ops)
    eproj = torch.cat([projection_cuda.project(dw.embed, dw.w_ih[0]) + dw.b[0],
                       dw.b[0][None]])  # (V, 4P)
    eproj = eproj.reshape(V, 4, nbp, UP).permute(2, 0, 3, 1)
    return tuple(t.contiguous() for t in ops + (eproj,))


def _gates_inverse(w: torch.Tensor) -> torch.Tensor:
    """(P/UP, K, UP, 4) -> the (K, 4P) gate columns (``_gates``' inverse)."""
    nbp, K, U, _ = w.shape
    return w.permute(1, 3, 0, 2).reshape(K, 4 * nbp * U)


def kernel_operands_inverse(ops, V: int):
    """(w_ih1, w_hh, w1p, w2) back from ``kernel_operands``: W_ih[1] {P, 4P}
    from w1, W_hh {2, P, 4P} from whh, W1p and W2 from w2 and wout.  Layer
    0's W_ih reaches the kernel only as eproj's sums."""
    whh, w1, w2, wout = ops[:4]
    if whh.dtype == torch.bfloat16:
        whh, w1, w2, wout = (cuda_build.b_fragments_inverse(t) for t in (whh, w1, w2, wout))
    nbp, L, P, NC = whh.shape
    UP = NC // 4
    unorder = lambda U: torch.argsort(cuda_build.gate_columns(U, whh.dtype)).to(whh.device)
    whh = whh[..., unorder(UP)].reshape(nbp, L, P, UP, 4)
    w_hh = torch.stack([_gates_inverse(whh[:, l]) for l in range(L)])
    w_ih1 = _gates_inverse(w1[..., unorder(2 * UP)].reshape(nbp, P, 2 * UP, 4)[:, :, :UP])
    w2 = w2[..., torch.argsort(_joint_columns(UP, w2.dtype)).to(w2.device)]
    J = wout.shape[0]
    w1p = w2[: J // UJ, :, :UJ].permute(1, 0, 2).reshape(P, J)
    return w_ih1, w_hh, w1p, wout[:, :V]


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_decode_steps.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_decode_steps.argtypes = [i, i, i] + [p] * 22 + [i] * 9 + [p]
        lib.rnnt_decode_steps.restype = ctypes.c_int
        lib.rnnt_decode_steps_wide.argtypes = [i, i] + [p] * 22 + [i] * 9 + [p]
        lib.rnnt_decode_steps_wide.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _scratch(dev: torch.device, stream: int, N: int, P: int, J: int, L: int,
             wdt: torch.dtype):
    """Kernel B's scratch for one stream and shape, made once and reused by
    every launch (the kernel zeroes each ``alive`` slot before it counts
    into it): the data pointers of h.W_hh of the committed h (keep) and of
    each iteration's h' (spec), hn, hc, z, upd and alive."""
    keep = torch.empty((2, P // UP, L, N, UP, 4), dtype=torch.float32, device=dev)
    hn = torch.empty((2, L, N, P), dtype=wdt, device=dev)
    hc = torch.empty_like(hn)
    z = torch.empty((N, J), dtype=wdt, device=dev)
    upd = torch.empty((2, N), dtype=torch.int32, device=dev)
    alive = torch.empty((2,), dtype=torch.int32, device=dev)
    tensors = (keep, hn, hc, z, upd, alive)
    return tensors, [keep[0].data_ptr(), keep[1].data_ptr()] + [t.data_ptr() for t in tensors[1:]]


def _operands(dw: DecodeWeights, P: int, J: int, V: int, L: int):
    """``kernel_operands`` of ``dw``, made once per weight set (and again if
    one of its tensors changes), after checking that dw fits the state."""

    def build():
        wdt = dw.embed.dtype
        for name, t, dt, shape in [
            ("embed", dw.embed, wdt, (V - 1, P)),
            ("w_ih", dw.w_ih, wdt, (L, P, 4 * P)),
            ("w_hh", dw.w_hh, wdt, (L, P, 4 * P)),
            ("b", dw.b, torch.float32, (L, 4 * P)),
            ("w1p", dw.w1p, wdt, (P, J)),
            ("b1", dw.b1, torch.float32, (J,)),
            ("w2", dw.w2, wdt, (J, V)),
            ("b2", dw.b2, torch.float32, (V,)),
        ]:
            cuda_build.require(t, f"decode_step_cuda {name}", dt, shape)
        return kernel_operands(dw, UP)

    tensors = (dw.embed, dw.w_ih, dw.w_hh, dw.b, dw.w1p, dw.b1, dw.w2, dw.b2)
    return cuda_build.cached_operands(dw, f"{NAME}/P{P}J{J}V{V}L{L}", tensors, build)


UP_WIDE = 8  # prediction units per block of the wide instantiation
VB = 16  # labels per block of the wide instantiation


@functools.lru_cache(maxsize=64)
def plan_wide(P: int, J: int, V: int, N: int, L: int, dtype: torch.dtype, sms: int) -> int:
    """Shared bytes per block (less the staging ring) of kernel B's
    wide-vocabulary instantiation (one prediction layer, bf16, any V) on a
    card with ``sms`` SMs: max(P / UP_WIDE, J / UJ, ceil(V / VB)) blocks,
    one to an SM.  Raises ValueError for a shape it cannot take."""
    if L != 1 or dtype != torch.bfloat16:
        raise ValueError(f"kernel B's wide instantiation runs one bf16 prediction layer, got "
                         f"{L} layers of {dtype}")
    if P <= 0 or J <= 0 or P % 64 or J % 64 or V < 1:
        raise ValueError(f"kernel B needs P and J multiples of 64, got P={P} J={J} V={V}")
    blocks = max(P // UP_WIDE, J // UJ, -(-V // VB))
    if blocks > sms:
        raise ValueError(f"kernel B: {blocks} blocks, the card has {sms} SMs")
    smem = (P * (UJ + 4 * UP_WIDE) + J * VB) * 2 + 2 * N * UP_WIDE * 4 + 3 * -(-N // 4) * 16
    if smem + cuda_build.ring_min_bytes(dtype) > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(f"kernel B: N={N} lanes need {smem} bytes of shared memory per block "
                         f"and a ring, more than {cuda_build.SMEM_PER_BLOCK}")
    return smem


def kernel_operands_wide(dw: DecodeWeights):
    """(whh, wj, wout, eproj), the weights of a one-layer prediction net in
    the wide instantiation's per-block order, UP = UP_WIDE:
      whh {P/UP, P, 4UP}: block b's W_hh columns (the launch's first h.W_hh);
      wj {nb, P, UJ + 4UP}, nb = max(P/UP, J/UJ): the joint's pass on y = h':
          W1p's columns b UJ .. and W_hh's of the block's units, in
          _joint_columns order;
      wout {ceil(V/VB), J, VB}: W2's label columns b VB .., zeros past V;
    each in mma fragment order; eproj {P/UP, V, UP, 4} f32 as for the
    two-layer kernel (embed . W_ih + b, row V-1 SOS's: b)."""
    L, P, G = dw.w_ih.shape
    J, V = dw.w2.shape
    dt, dev = dw.w2.dtype, dw.w2.device
    UP = UP_WIDE
    nbp, nbj, nbv = G // 4 // UP, J // UJ, -(-V // VB)
    nb = max(nbp, nbj)
    whh = _gates(dw.w_hh[0], UP).reshape(nbp, P, 4 * UP)[..., cuda_build.gate_columns(UP, dt).to(dev)]
    wj = whh.new_zeros((nb, P, UJ + 4 * UP))
    wj[:nbj, :, :UJ] = dw.w1p.reshape(P, nbj, UJ).permute(1, 0, 2)
    wj[:nbp, :, UJ:] = _gates(dw.w_hh[0], UP).reshape(nbp, P, 4 * UP)
    wj = wj[..., _joint_columns(UP, dt).to(dev)]
    wout = torch.cat([dw.w2, dw.w2.new_zeros((J, nbv * VB - V))], dim=1)
    wout = wout.reshape(J, nbv, VB).permute(1, 0, 2)
    eproj = torch.cat([projection_cuda.project(dw.embed, dw.w_ih[0]) + dw.b[0],
                       dw.b[0][None]])  # (V, 4P)
    eproj = eproj.reshape(V, 4, nbp, UP).permute(2, 0, 3, 1)
    return tuple(cuda_build.b_fragments(t).contiguous() for t in (whh, wj, wout)) + (
        eproj.contiguous(),)


@functools.lru_cache(maxsize=16)
def _scratch_wide(dev: torch.device, stream: int, N: int, P: int, J: int, V: int):
    """The wide instantiation's scratch for one stream and shape, made once:
    the data pointers of keep, spec, hn, hc, z, best, arg, upd, alive."""
    nb = max(P // UP_WIDE, J // UJ, -(-V // VB))
    f32 = dict(dtype=torch.float32, device=dev)
    tensors = (torch.empty((nb, N, UP_WIDE, 4), **f32), torch.empty((nb, N, UP_WIDE, 4), **f32),
               torch.empty((2, N, P), dtype=torch.bfloat16, device=dev),
               torch.empty((2, N, P), dtype=torch.bfloat16, device=dev),
               torch.empty((N, J), dtype=torch.bfloat16, device=dev),
               torch.empty((-(-V // VB), N), **f32),
               torch.empty((-(-V // VB), N), dtype=torch.int32, device=dev),
               torch.empty((2, N), dtype=torch.int32, device=dev),
               torch.empty((2,), dtype=torch.int32, device=dev))
    return tensors, [t.data_ptr() for t in tensors]


def _decode_wide(fproj, lanes, hg, cg, res, dw, params, steps, starts, res_base, utt_budget):
    """``decode_step_cuda`` for one prediction layer: the wide instantiation."""
    T2, N, J = fproj.shape
    L, _, P = hg.shape
    V, R = dw.w2.shape[1], res.shape[1]
    dev = lanes.device
    plan_wide(P, J, V, N, L, dw.embed.dtype, cuda_build.sm_count(dev))

    def build():
        for name, t, dt, shape in [
            ("embed", dw.embed, torch.bfloat16, (V - 1, P)),
            ("w_ih", dw.w_ih, torch.bfloat16, (1, P, 4 * P)),
            ("w_hh", dw.w_hh, torch.bfloat16, (1, P, 4 * P)),
            ("b", dw.b, torch.float32, (1, 4 * P)),
            ("w1p", dw.w1p, torch.bfloat16, (P, J)),
            ("b1", dw.b1, torch.float32, (J,)),
            ("w2", dw.w2, torch.bfloat16, (J, V)),
            ("b2", dw.b2, torch.float32, (V,)),
        ]:
            cuda_build.require(t, f"decode_step_cuda {name}", dt, shape)
        return kernel_operands_wide(dw)

    tensors = (dw.embed, dw.w_ih, dw.w_hh, dw.b, dw.w1p, dw.b1, dw.w2, dw.b2)
    whh, wj, wout, eproj = cuda_build.cached_operands(dw, f"{NAME}/wide/P{P}J{J}V{V}", tensors,
                                                      build)
    if whh.device != dev:
        raise ValueError(f"kernel B: weights on {whh.device}, state on {dev}")
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        _, scratch = _scratch_wide(dev, stream, N, P, J, V)
        err = lib.rnnt_decode_steps_wide(
            int(res.dtype == torch.int16), steps, fproj.data_ptr(), lanes.data_ptr(),
            hg.data_ptr(), cg.data_ptr(), res.data_ptr(), whh.data_ptr(), wj.data_ptr(),
            dw.b1.data_ptr(), wout.data_ptr(), dw.b2.data_ptr(), eproj.data_ptr(), *scratch,
            None if starts is None else starts.data_ptr(),
            None if starts is None else res_base.data_ptr(),
            N, P, J, V, R, params.BLANK, params.SOS, params.max_symbols_per_step, utt_budget,
            stream,
        )
    cuda_build.check(lib, err, "decode_step kernel (wide)")


def decode_step_cuda(
    fproj: torch.Tensor,
    lanes: torch.Tensor,
    hg: torch.Tensor,
    cg: torch.Tensor,
    res: torch.Tensor,
    dw: DecodeWeights,
    params: RNNTParams,
    steps: int = 1,
    starts: Optional[torch.Tensor] = None,
    res_base: Optional[torch.Tensor] = None,
    utt_budget: int = 0,
) -> None:
    """Up to ``steps`` decode iterations on the card, in place, in one
    launch that stops early once every lane has finished (the iterations it
    skips would change nothing); packed mode where ``starts`` is given.  A
    refused cooperative launch raises."""
    T2, N, J = fproj.shape
    L, _, P = hg.shape
    V = dw.w2.shape[1]
    R = res.shape[1]
    wdt = dw.embed.dtype
    if wdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel B takes bf16 or f32 weights, got {wdt}")
    for name, t, dt, shape in [
        ("fproj", fproj, torch.float32, (T2, N, J)),
        ("lanes", lanes, torch.int32, (N_LANE_ROWS, N)),
        ("hg", hg, wdt, (L, N, P)),
        ("cg", cg, torch.float32, (L, N, P)),
        ("res", res, token_dtype(V), (N, R)),
    ] + ([] if starts is None else [
        ("starts", starts, torch.bool, (T2, N)),
        ("res_base", res_base, torch.int32, (N,)),
    ]):
        cuda_build.require(t, f"decode_step_cuda {name}", dt, shape)
    if utt_budget < 0:
        raise ValueError(f"kernel B: utt_budget must be >= 0, got {utt_budget}")
    if hg.data_ptr() % 16:
        raise ValueError("kernel B copies hg rows in 16-byte pieces: align it")
    if steps <= 0:
        return
    if L == 1:
        _decode_wide(fproj, lanes, hg, cg, res, dw, params, steps, starts, res_base, utt_budget)
        decode_step_cuda.launches += 1
        return
    dev = lanes.device
    plan(P, J, V, N, L, wdt, cuda_build.sm_count(dev))
    whh, w1, w2, wout, eproj = _operands(dw, P, J, V, L)
    if whh.device != dev:
        raise ValueError(f"kernel B: weights on {whh.device}, state on {dev}")
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        _, scratch = _scratch(dev, stream, N, P, J, L, wdt)
        err = lib.rnnt_decode_steps(
            int(wdt == torch.bfloat16), UP, steps, fproj.data_ptr(), lanes.data_ptr(),
            hg.data_ptr(), cg.data_ptr(), res.data_ptr(), whh.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), dw.b.data_ptr(), dw.b1.data_ptr(), wout.data_ptr(), dw.b2.data_ptr(),
            eproj.data_ptr(), *scratch,
            None if starts is None else starts.data_ptr(),
            None if starts is None else res_base.data_ptr(),
            N, P, J, V, R, params.BLANK, params.SOS, params.max_symbols_per_step, utt_budget,
            stream,
        )
    cuda_build.check(lib, err, "decode_step kernel")
    decode_step_cuda.launches += 1


decode_step_cuda.launches = 0


def decode_step(
    fproj: torch.Tensor,
    lanes: torch.Tensor,
    hg: torch.Tensor,
    cg: torch.Tensor,
    res: torch.Tensor,
    dw: DecodeWeights,
    params: RNNTParams,
    steps: int = 1,
    impl: Optional[str] = None,
    starts: Optional[torch.Tensor] = None,
    res_base: Optional[torch.Tensor] = None,
    utt_budget: int = 0,
) -> None:
    """Kernel B's wrapper: ``steps`` iterations, the CUDA kernel for CUDA
    tensors (one launch, which stops early once every lane has finished),
    the plain twin for CPU tensors or when impl="reference"; packed mode
    where ``starts`` is given.  On CPU tensors the twin stops where the
    kernel would (the iterations left would change nothing, and reading
    the finish row there waits for no card); on the card it runs all
    ``steps`` and reads nothing back."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    packed = dict(starts=starts, res_base=res_base, utt_budget=utt_budget)
    if impl == "reference" or not lanes.is_cuda:
        for _ in range(steps):
            decode_step_reference(fproj, lanes, hg, cg, res, dw, params, **packed)
            if not lanes.is_cuda and bool(lanes[FINISH].all()):
                break
        return
    decode_step_cuda(fproj, lanes, hg, cg, res, dw, params, steps, **packed)


def decode_step_tp(fproj, lanes, hg, cg, res, dw, params: RNNTParams, steps: int = 1,
                   impl: Optional[str] = None) -> None:
    """Kernel B's tensor-parallel counterpart (module docstring): ``steps``
    iterations of the plain rank step on the k model ranks of a data
    shard, one list entry per rank.  CUDA tensors need impl="reference"
    (ops/cuda_build.py plain_impl)."""
    cuda_build.plain_impl(impl, lanes[0], "decode_step_tp")
    for _ in range(steps):
        decode_step_tp_reference(fproj, lanes, hg, cg, res, dw, params)
