"""Kernel F: relative-position multi-head attention over many utterances of
different lengths in one launch, in CUDA C++ (csrc/rel_attention.cu), and
its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package has no attention.  It was added
for the Conformer encoder (models/conformer.py), whose self-attention is
NeMo's RelPositionMultiHeadAttention with untied biases: for the queries q,
keys k and values v of one head of one utterance (T rows each),

    score[i, j] = ((q_i + u) . k_j + (q_i + v_b) . p(i - j)) / sqrt(d)
    out_i       = sum_j softmax_j(score[i, :]) v_j

where p(r) is row t_max - 1 - r of ``pos``, the projected sinusoidal
positions of relative positions t_max - 1 down to -(t_max - 1) (2 t_max - 1
rows, shared by every utterance of the launch).  This is NeMo's
``rel_shift`` written out.

Layout: q, k and v are row views (R, H d) of the varlen rows of the group
(each utterance's rows contiguous, from ``Segments.starts``), bf16, any row
stride that keeps rows on 16-byte boundaries (slices of one fused qkv
product); u and v_b are (H, d) f32; the output (R, H d) bf16 holds zeros
on rows no utterance owns.  Numerics, both versions: q + u and q + v_b are
formed in f32 and rounded to bf16, the products are summed in f32, the
softmax runs in f32, the output is rounded once to bf16.  The kernel keeps
an online softmax (flash attention: the T x T scores never reach memory)
and rounds its unnormalized probabilities to bf16 for the product with v,
so the two agree to those roundings (chip_smoke.py and
tests/test_torch_conformer_cuda.py state the tolerance).

What bounds it on an H100: per head and utterance 6 T^2 d operations (the
three products) against (4 T + 2 T) d bytes, about T / 2 operations a
byte, below the card's ridge (295) at the Conformer's T <= 376: its reads
of q, k, v and the band of p, while the tensor cores idle.  The design
(csrc/rel_attention.cu states it whole): a block of 4 warps takes one
(query tile of 64 rows, head, utterance) and walks the utterance's key
tiles of 64 rows (nothing past its length is computed), the next tile's
loads in flight during this one's mma.sync products; the 127 rows of p a
(query tile, key tile) pair needs overlap the next pair's by half, so p is
staged in a ring of 64-row chunks, one new chunk a tile; each warp's
(q + v_b) . p product over its 80 band rows goes to shared memory and is
read back at column j - i + 15 (the skew of ``rel_shift``).

``rel_attention`` is the wrapper: CUDA tensors launch the kernel
(``rel_attention_cuda``, counted in its ``launches``; runtime/offline.py
launch_counts' "attention"), CPU tensors or impl="reference" take the twin
``rel_attention_reference``.  The kernel is built on its first launch.

The streaming form (``rel_attention_stream``, kernel ``rel_attention_stream``
in the same source; launch_counts' "attention_stream") serves NeMo's
cache-aware FastConformer (models/fastconformer.py) under its
chunked-limited mask: each of N slots brings one chunk of C query rows, and
its keys and values are the K and V rows of its last R chunks (this one
and R - 1 before it), held per slot in a ring of R chunk places
(N, R, C, 2 H d) that the step wrote this chunk into before the call
(place ``pos``; the chunk m - (R - 1) chunks back lies at place (pos - (R -
1) + m) mod R).  Query row i of slot chunk c sees key r of the chunk c - (R
- 1) + m iff that chunk is not before the utterance (c - (R - 1) + m >= 0)
and the key's frame is inside it (its frame index below the slot's encoder
length); relative positions run from R C - 1 down to -(C - 1), the (R + 1) C
- 1 rows of ``band``, shared by every slot: the pair's position row is C -
1 - i + m C + r.  A row with no key it may see (a slot with no frames)
reads zeros.  The design (csrc/rel_attention.cu): one warp per (slot,
head), its C query rows one m16 tile, the R chunks' keys and values and the
band staged once by cp.async (keys that may not be seen zero-filled), the
band product over the warp's 16 rows into shared memory and read at the
pair's position row, every score of a row in registers (at most R 16 of
them), so the softmax is taken whole and not online.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rnnt_inference_tpu_torch.ops import cuda_build
from rnnt_inference_tpu_torch.utils.profiler import record_call

NAME = "rel_attention"


@dataclasses.dataclass
class Segments:
    """Where each utterance's rows lie in a varlen buffer: starts and lens
    (B,) int32 on the device, and the lengths on the host (the grid and the
    recorder read them); t_max the longest, the band of ``pos``."""

    starts: torch.Tensor
    lens: torch.Tensor
    lens_host: np.ndarray
    t_max: int

    @classmethod
    def of(cls, starts: np.ndarray, lens: np.ndarray, device) -> "Segments":
        lens = np.asarray(lens, np.int64)
        to = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
        return cls(starts=to(starts), lens=to(lens), lens_host=lens,
                   t_max=int(lens.max()) if len(lens) else 0)


def relative_positions(t_max: int, d_model: int, device=None) -> torch.Tensor:
    """NeMo's RelPositionalEncoding table for relative positions t_max - 1
    down to -(t_max - 1): (2 t_max - 1, d_model) f32, sin at even columns
    and cos at odd ones of r / 10000^(2k / d_model)."""
    r = torch.arange(t_max - 1, -t_max, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((2 * t_max - 1, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(r * div)
    pe[:, 1::2] = torch.cos(r * div)
    return pe


def rel_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            u: torch.Tensor, vb: torch.Tensor, pos: torch.Tensor,
                            segs: Segments) -> torch.Tensor:
    """Kernel F's plain twin, one utterance at a time (module docstring)."""
    H, d = u.shape
    R = q.shape[0]
    out = torch.zeros((R, H * d), dtype=q.dtype, device=q.device)
    tm = segs.t_max
    starts = segs.starts.cpu().numpy()
    for s, T in zip(starts, segs.lens_host):
        s, T = int(s), int(T)
        if T == 0:
            continue
        heads = lambda t: t[s : s + T].float().reshape(T, H, d).transpose(0, 1)  # (H, T, d)
        qh, kh, vh = heads(q), heads(k), heads(v)
        qu = (qh + u[:, None, :].float()).to(q.dtype).float()
        qv = (qh + vb[:, None, :].float()).to(q.dtype).float()
        # p(i - j) is row tm - 1 - i + j of pos
        i = torch.arange(T, device=q.device)
        rows = (tm - 1 - i[:, None] + i[None, :]).reshape(-1)
        ph = pos[rows].float().reshape(T, T, H, d).permute(2, 0, 1, 3)  # (H, T, T, d)
        score = (qu @ kh.transpose(1, 2) + (qv[:, :, None, :] * ph).sum(-1)) / math.sqrt(d)
        attn = torch.softmax(score, dim=-1)
        out[s : s + T] = (attn @ vh).transpose(0, 1).reshape(T, H * d).to(q.dtype)
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_rel_attention.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnnt_rel_attention.argtypes = [p] * 9 + [ll] * 5 + [i] * 4 + [p]
        lib.rnnt_rel_attention.restype = ctypes.c_int
    return lib


def rel_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                       vb: torch.Tensor, pos: torch.Tensor, segs: Segments) -> torch.Tensor:
    """Kernel F on the card: one launch over every utterance of ``segs`` and
    every head.  A shape, type, layout or device it cannot take raises."""
    H, d = u.shape
    R = q.shape[0]
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"kernel F: {name} must be a bf16 CUDA matrix with unit column "
                             f"stride, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.shape[1] != H * d:
            raise ValueError(f"kernel F: {name} has {t.shape[1]} columns, want {H * d}")
        if t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError(f"kernel F: {name}'s rows must lie on 16-byte boundaries "
                             f"(row stride {t.stride(0)})")
        if t.device != q.device:
            raise ValueError(f"kernel F: {name} on {t.device}, q on {q.device}")
    if k.shape[0] != R or v.shape[0] != R or pos.shape[0] != 2 * segs.t_max - 1:
        raise ValueError(f"kernel F: rows q {R}, k {k.shape[0]}, v {v.shape[0]}, pos "
                         f"{pos.shape[0]} (want 2 t_max - 1 = {2 * segs.t_max - 1})")
    if d != 64:
        raise ValueError(f"kernel F takes heads of 64 (the Conformer's), got {d}")
    u32, vb32 = u.float().contiguous(), vb.float().contiguous()
    out = torch.zeros((R, H * d), dtype=torch.bfloat16, device=q.device)
    B = len(segs.lens_host)
    if B == 0 or segs.t_max == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):  # the C side launches on the current device
        err = lib.rnnt_rel_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), u32.data_ptr(),
            vb32.data_ptr(), out.data_ptr(), segs.starts.data_ptr(), segs.lens.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), pos.stride(0), out.stride(0), B, H, d,
            segs.t_max, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, "kernel F (rel_attention)")
    rel_attention_cuda.launches += 1
    return out


rel_attention_cuda.launches = 0


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                  vb: torch.Tensor, pos: torch.Tensor, segs: Segments,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Kernel F's wrapper: the kernel for CUDA tensors, the plain twin for
    CPU tensors or when impl="reference"."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "reference" or not q.is_cuda:
        return rel_attention_reference(q, k, v, u, vb, pos, segs)
    return rel_attention_cuda(q, k, v, u, vb, pos, segs)


# -- the streaming form -----------------------------------------------------

STREAM_TILE = 16  # rows a chunk's keys, values and queries take in the kernel
STREAM_MAX_RING = 6  # chunks the kernel's ring may hold
STREAM_BAND_ROWS = 112  # band rows the kernel stages


def stream_positions(ring: int, chunk: int, d_model: int, device=None) -> torch.Tensor:
    """NeMo's sinusoids of the relative positions ring chunk - 1 down to
    -(chunk - 1): ((ring + 1) chunk - 1, d_model) f32, the band of the
    streaming form."""
    r = torch.arange(ring * chunk - 1, -chunk, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((r.shape[0], d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(r * div)
    pe[:, 1::2] = torch.cos(r * div)
    return pe


def stream_keys(chunk: torch.Tensor, enc_len: torch.Tensor, ring: int, c_rows: int):
    """(N, ring c_rows) bool: key r of ring chunk m of each slot may be seen
    (its chunk is not before the utterance and its frame is inside it)."""
    cc = chunk.long()[:, None] - (ring - 1) + torch.arange(ring, device=chunk.device)
    j = cc[:, :, None] * c_rows + torch.arange(c_rows, device=chunk.device)
    ok = (cc[:, :, None] >= 0) & (j < enc_len.long()[:, None, None])
    return ok.reshape(len(chunk), ring * c_rows)


def rel_attention_stream_reference(q: torch.Tensor, kv: torch.Tensor, band: torch.Tensor,
                                   u: torch.Tensor, vb: torch.Tensor, chunk: torch.Tensor,
                                   enc_len: torch.Tensor, pos: int) -> torch.Tensor:
    """The streaming form's plain twin (module docstring): q (N C, H d), kv
    (N, R, C, 2 H d), band ((R + 1) C - 1, H d), u and vb (H, d), chunk and
    enc_len (N,), pos the ring place of this chunk -> (N C, H d) in q's
    type.  Numerics as kernel F's twin."""
    N, R, C, _ = kv.shape
    H, d = u.shape
    D = H * d
    order = [(pos - (R - 1) + m) % R for m in range(R)]
    ok = stream_keys(chunk, enc_len, R, C)  # (N, R C)
    rows = lambda t: t.float().masked_fill(~ok[:, :, None], 0.0).reshape(N, R * C, H, d)
    k = rows(kv[:, order, :, :D].reshape(N, R * C, D)).transpose(1, 2)  # (N, H, R C, d)
    v = rows(kv[:, order, :, D:].reshape(N, R * C, D)).transpose(1, 2)
    qh = q.float().reshape(N, C, H, d).transpose(1, 2)  # (N, H, C, d)
    qu = (qh + u.float()[None, :, None, :]).to(q.dtype).float()
    qv = (qh + vb.float()[None, :, None, :]).to(q.dtype).float()
    bh = band.float().reshape(-1, H, d).transpose(0, 1)  # (H, B, d)
    i = torch.arange(C, device=q.device)
    kk = torch.arange(R * C, device=q.device)
    prow = (C - 1 - i[:, None] + kk[None, :]).expand(N, H, C, R * C)
    bd = torch.gather(qv @ bh.transpose(1, 2)[None], 3, prow)
    score = ((qu @ k.transpose(2, 3) + bd) / math.sqrt(d)).masked_fill(
        ~ok[:, None, None, :], -math.inf)
    attn = torch.softmax(score, dim=-1).nan_to_num(0.0)  # a row with no key reads zeros
    return (attn @ v).transpose(1, 2).reshape(N * C, D).to(q.dtype)


def _lib_stream() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_rel_attention_stream.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnnt_rel_attention_stream.argtypes = [p] * 8 + [ll] * 3 + [i] * 6 + [p]
        lib.rnnt_rel_attention_stream.restype = ctypes.c_int
    return lib


def rel_attention_stream_cuda(q: torch.Tensor, kv: torch.Tensor, band: torch.Tensor,
                              u: torch.Tensor, vb: torch.Tensor, chunk: torch.Tensor,
                              enc_len: torch.Tensor, pos: int) -> torch.Tensor:
    """The streaming form on the card: one launch over every slot and head.
    A shape, type, layout or device it cannot take raises.  While a torch
    profiler runs, the call is recorded with the slots' chunk indices and
    encoder lengths (utils/profiler.py ``REGISTRY.calls``)."""
    N, R, C, twoD = kv.shape
    H, d = u.shape
    D = H * d
    for name, t in (("q", q), ("kv", kv), ("band", band)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"kernel F (streaming): {name} must be bf16 CUDA with unit "
                             f"column stride, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"kernel F (streaming): {name} on {t.device} at a 16-byte "
                             f"boundary, q on {q.device}")
    if (d != 64 or twoD != 2 * D or q.dim() != 2 or q.shape != (N * C, D) or q.stride(0) % 8
            or not kv.is_contiguous() or band.dim() != 2 or band.shape != ((R + 1) * C - 1, D)
            or band.stride(0) % 8 or not 1 <= C <= STREAM_TILE or not 1 <= R <= STREAM_MAX_RING
            or band.shape[0] > STREAM_BAND_ROWS or not 0 <= pos < R):
        raise ValueError(f"kernel F (streaming) takes heads of 64, chunks of at most "
                         f"{STREAM_TILE} rows and rings of at most {STREAM_MAX_RING}: q "
                         f"{tuple(q.shape)}, kv {tuple(kv.shape)}, band {tuple(band.shape)}, "
                         f"u {tuple(u.shape)}, pos {pos}")
    for name, t in (("chunk", chunk), ("enc_len", enc_len)):
        if t.dtype != torch.int32 or t.shape != (N,) or t.device != q.device:
            raise ValueError(f"kernel F (streaming): {name} must be ({N},) int32 on {q.device}")
    u32, vb32 = u.float().contiguous(), vb.float().contiguous()
    out = torch.empty((N * C, D), dtype=torch.bfloat16, device=q.device)
    if N == 0:
        return out
    chunk, enc_len = chunk.contiguous(), enc_len.contiguous()
    lib = _lib_stream()
    with torch.cuda.device(q.device):  # the C side launches on the current device
        err = lib.rnnt_rel_attention_stream(
            q.data_ptr(), kv.data_ptr(), band.data_ptr(), u32.data_ptr(), vb32.data_ptr(),
            chunk.data_ptr(), enc_len.data_ptr(), out.data_ptr(), q.stride(0), band.stride(0),
            out.stride(0), N, H, d, C, R, pos, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, "kernel F (rel_attention_stream)")
    rel_attention_stream_cuda.launches += 1
    record_call("kernel_f_stream", rel_attention_stream_cuda.launches, chunk=chunk,
                enc_len=enc_len, chunk_rows=C, ring=R, heads=H, d_head=d,
                band_rows=band.shape[0])
    return out


rel_attention_stream_cuda.launches = 0


def rel_attention_stream(q: torch.Tensor, kv: torch.Tensor, band: torch.Tensor,
                         u: torch.Tensor, vb: torch.Tensor, chunk: torch.Tensor,
                         enc_len: torch.Tensor, pos: int,
                         impl: Optional[str] = None) -> torch.Tensor:
    """The streaming form's wrapper: the kernel for CUDA tensors, the plain
    twin for CPU tensors or when impl="reference"."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "reference" or not q.is_cuda:
        return rel_attention_stream_reference(q, kv, band, u, vb, chunk, enc_len, pos)
    return rel_attention_stream_cuda(q, kv, band, u, vb, chunk, enc_len, pos)
