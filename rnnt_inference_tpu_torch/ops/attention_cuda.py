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
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rnnt_inference_tpu_torch.ops import cuda_build

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
