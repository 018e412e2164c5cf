"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/torch_kernels/lib<name>-<hash>.so`` at the repository
root (the hash is of the source and flags, so an edited source rebuilds).
Nothing is compiled when a module is imported.  A failed build raises.

Flags: ``sm_90a`` (Hopper), no fast math, and ``--fmad=false`` so that the
float epilogues round exactly like their plain PyTorch twins.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, Sequence

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


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile the named sources that are not built yet, one nvcc process
    per source, all started together.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.time() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_INFO


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

    def forget(ref, k=key):
        if _OPERANDS.get(k, (None,))[0] is ref:
            del _OPERANDS[k]

    _OPERANDS[key] = (weakref.ref(owner, forget), stamp, operands)
    return operands
