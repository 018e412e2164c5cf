"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/torch_kernels/lib<name>-<hash>.so`` at the repository
root (the hash is of the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds).  ``compile_libs`` is the
one build step, also for the native loadgen's g++ build
(runtime/native.py).
Nothing is compiled when a module is imported.  A failed build raises.

Flags: ``sm_90a`` (Hopper), no fast math, and ``--fmad=false`` so that the
float epilogues round exactly like their plain PyTorch twins.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "log": nvcc's output} for builds of this process
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def hashed_lib_path(stem: str, sources: Sequence[Path], flags: Sequence[str],
                    build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/lib<stem>-<hash>.so``, the hash of the sources' bytes and
    the flags: an edited source, header or flag builds a new library."""
    src = b"".join(f.read_bytes() for f in sources)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return build_dir / f"lib{stem}-{digest}.so"


def _lib_path(name: str) -> Path:
    return hashed_lib_path(name, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS)


def compile_libs(jobs: Dict[str, Tuple[Sequence[str], Path, Path]]) -> Dict[str, dict]:
    """Run each job ``name -> (compiler and flags, source, output)``, one
    process per job, all started together.  Each writes a temporary file of
    its own (the process id in its name) that is renamed onto the output
    only when the compiler succeeds, so processes that build the same
    library at once never load a partial file.  Records each job's seconds
    and compiler output in BUILD_INFO; raises with the output of every job
    that failed."""
    procs = {}
    t0 = time.time()
    for name, (compiler, src, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [*compiler, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.time() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} ({jobs[name][0][0]} exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return BUILD_INFO


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile the named CUDA sources that are not built yet, one nvcc
    process per source, all started together.  Raises if any build fails."""
    return compile_libs({
        name: ([nvcc_path(), *NVCC_FLAGS], CSRC / f"{name}.cu", _lib_path(name))
        for name in names if not _lib_path(name).exists()
    })


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.rnnt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rnnt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (or a refused launch)."""
    if err != 0:
        msg = lib.rnnt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err}: {msg}")


def plain_impl(impl, t: torch.Tensor, what: str) -> None:
    """Validate ``impl`` for ``what``, an op that has no kernel (the
    tensor-parallel rank steps): None or "reference", and on CUDA tensors
    "reference" only, so that the card runs a plain version only when it is
    asked for."""
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl is None and t.is_cuda:
        raise ValueError(f"{what} has no CUDA kernel: impl='reference' runs its plain "
                         f"version on the card")


def require(t, name: str, dtype, shape) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)}"
        )


# (name, id(owner)) ->(weakref to the owner, stamp of its tensors, operands)
_OPERANDS: Dict[tuple, tuple] = {}


def _stamp(tensors: Sequence) -> tuple:
    """Which tensors these are and how often each was changed in place
    (inference-mode tensors keep no such count)."""
    return tuple((weakref.ref(t), None if t.is_inference() else t._version) for t in tensors)


def cached_operands(owner, name: str, tensors: Sequence, build: Callable[[], object]):
    """``build()``, the kernel-layout operands made from ``owner``'s
    ``tensors``: made on the first call and kept until ``owner`` is freed;
    made again if one of the tensors is replaced or changed in place."""
    key, stamp = (name, id(owner)), _stamp(tensors)
    hit = _OPERANDS.get(key)
    if hit is not None and hit[0]() is owner and all(
        ra() is rb() and va == vb for (ra, va), (rb, vb) in zip(hit[1], stamp)
    ):
        return hit[2]
    operands = build()

    def forget(ref, k=key, registry=_OPERANDS):  # bound now: gone at interpreter exit
        if registry.get(k, (None,))[0] is ref:
            del registry[k]

    _OPERANDS[key] = (weakref.ref(owner, forget), stamp, operands)
    return operands


# shared memory one block may use on an H100 (sm_90)
SMEM_PER_BLOCK = 232448


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of the card: the most blocks a persistent
    kernel (one block per SM, all co-resident) may launch."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# csrc/hopper.cuh's pass engine, mirrored for shared-memory planning
NSTAGE = 2


def rows(dtype: torch.dtype):
    """(MT, PAD, RMAX) of csrc/hopper.cuh Rows: lane rows per m-tile, row
    padding in elements, lane rows per pass."""
    return {torch.bfloat16: (16, 8, 128), torch.int8: (16, 16, 128)}.get(dtype, (32, 4, 64))


def ring_min_bytes(dtype: torch.dtype) -> int:
    """The least staging ring a pass may be given (csrc/hopper.cuh ring_min);
    a kernel's ring takes whatever shared memory its other arrays leave."""
    _, pad, rmax = rows(dtype)
    return NSTAGE * rmax * (64 + pad) * dtype.itemsize


def gate_columns(U: int, dtype: torch.dtype) -> torch.Tensor:
    """The order of a block's 4U gate columns: local column c holds unit u,
    gate g at index 4u + g of perm[c].  bf16 and int8 (mma products): c =
    8 (2 (u // 4) + g // 2) + 2 (u % 4) + g % 2, so lane 4g' + t of an mma C
    fragment holds all four gates of unit 4i + t in n-tiles 2i, 2i + 1; f32:
    c = 4u + g, so lane 4m + q of fma_rows32 holds units q U/4 ..
    (csrc/hopper.cuh)."""
    perm = torch.empty(4 * U, dtype=torch.long)
    for u in range(U):
        for g in range(4):
            c = (4 * u + g if dtype == torch.float32
                 else 8 * (2 * (u // 4) + g // 2) + 2 * (u % 4) + g % 2)
            perm[c] = 4 * u + g
    return perm


def b_fragments(w: torch.Tensor) -> torch.Tensor:
    """bf16, int8 or f32 (tf32 pieces) operand B {..., K, NC} in mma.sync
    fragment order, a k-step of KS = 32 bytes of inputs (bf16 m16n8k16: KS
    = 16; int8 m16n8k32: KS = 32; tf32 m16n8k8: KS = 8): {..., K/KS, NC/8,
    32, KS/4}, where for k-step s and n-tile j lane 4g + t holds B[KS s +
    (KS/8) t + (0 .. KS/8 - 1) + (0, KS/2), 8j + g]: bf16 rows 16s + 2t +
    (0, 1, 8, 9), int8 rows 32s + 4t + (0..3, 16..19), tf32 rows 8s + t +
    (0, 4) (csrc/hopper.cuh)."""
    *lead, K, NC = w.shape
    ks = 32 // w.element_size()
    d = len(lead)
    # k = KS s + (KS/2) hh + (KS/8) t + p, n = 8j + g
    f = w.reshape(*lead, K // ks, 2, 4, ks // 8, NC // 8, 8)
    f = f.permute(*range(d), d, d + 4, d + 5, d + 2, d + 1, d + 3)  # s, j, g, t, hh, p
    return f.reshape(*lead, K // ks, NC // 8, 32, ks // 4).contiguous()


def b_fragments_inverse(f: torch.Tensor) -> torch.Tensor:
    """The plain {..., K, NC} operand back from ``b_fragments``."""
    *lead, KS, NT, _, E = f.shape
    d = len(lead)
    w = f.reshape(*lead, KS, NT, 8, 4, 2, E // 2)  # s, j, g, t, hh, p
    w = w.permute(*range(d), d, d + 4, d + 3, d + 5, d + 1, d + 2)  # s, hh, t, p, j, g
    return w.reshape(*lead, KS * 4 * E, NT * 8).contiguous()


def block_columns(w: torch.Tensor, U: int, kmajor: bool = False) -> torch.Tensor:
    """Gate columns {K, 4H} (gate g of unit j at column g H + j) in the
    per-block order of the persistent LSTM kernels: block b's columns, gate
    g of unit b U + u, in ``gate_columns`` order, {H / U, K, 4U}; for bf16
    and int8 then in mma fragment order (``b_fragments``), or with
    ``kmajor`` each column a row of K inputs, {H / U, 4U, K} (the rows TMA
    and wgmma read)."""
    K, G = w.shape
    w = w.reshape(K, 4, G // 4 // U, U).permute(2, 0, 3, 1).reshape(G // 4 // U, K, 4 * U)
    w = w[..., gate_columns(U, w.dtype).to(w.device)]
    if kmajor:
        return w.transpose(1, 2).contiguous()
    return w.contiguous() if w.dtype == torch.float32 else b_fragments(w)


def block_columns_inverse(op: torch.Tensor, H: int, U: int, kmajor: bool = False) -> torch.Tensor:
    """The {K, 4H} gate columns back from ``block_columns``."""
    if kmajor:
        w = op.transpose(1, 2)
    else:
        w = op if op.dtype == torch.float32 else b_fragments_inverse(op)
    w = w[..., torch.argsort(gate_columns(U, op.dtype)).to(w.device)]
    K = w.shape[1]
    return w.reshape(H // U, K, U, 4).permute(1, 3, 0, 2).reshape(K, 4 * H)
