"""ctypes bindings for the benchmark's load generator (loadgen.cpp), and its
substitution for the program's native loadgen.

The library is built with g++ on first use into build/benchmark/ of the
checkout, under a name that carries a hash of its source and flags, so a
later run finds it built.

``LoadGen`` offers the interface that the program's
``runtime/scheduler.py run_server_native`` drives (poll, complete,
pending, done_issuing, drained, report, close); ``serving_from`` puts it in
place of the program's ``runtime/native.py NativeLoadGen`` for the length
of a ``with`` block.  run_server_native imports that name inside the
function, so the substitution needs no edit of the program.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("loadgen.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "benchmark"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded library, compiled first if this source and these flags
    have not been built into BUILD_DIR yet (raises with g++'s output)."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libbench_loadgen-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.bl_create.restype = ctypes.c_void_p
    lib.bl_create.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.bl_destroy.argtypes = [ctypes.c_void_p]
    lib.bl_destroy.restype = None
    lib.bl_poll.restype = ctypes.c_int
    lib.bl_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                            ctypes.c_int64]
    lib.bl_complete.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bl_complete.restype = None
    for name in ("bl_issued", "bl_completed", "bl_pending", "bl_done_issuing"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.bl_now.restype = ctypes.c_double
    lib.bl_now.argtypes = [ctypes.c_void_p]
    lib.bl_stamps.restype = None
    lib.bl_stamps.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


class LoadGen:
    """Issues query q at ``schedule[q]`` seconds after it is made; query q
    carries store utterance ``order[q]``."""

    _h = None  # the C handle; None once closed

    def __init__(self, schedule: np.ndarray, order: np.ndarray):
        self._lib = library()
        self._sched = np.ascontiguousarray(schedule, np.float64)
        self.order = np.asarray(order, np.int64)
        self.n = len(self._sched)
        self._polled = 0
        self.deferred: List[int] = []
        self._stamps: Optional[np.ndarray] = None
        self.closed_at = 0.0  # seconds on the loadgen's clock when it was closed
        self._h = self._lib.bl_create(
            self.n, self._sched.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        # the loadgen clock's zero on time.perf_counter (to within the call's return)
        self.t0_perf = time.perf_counter()

    def sample_of(self, query_id: int) -> int:
        return int(self.order[query_id])

    def poll(self, max_n: int = 64, timeout_us: int = 1000) -> List[int]:
        buf = (ctypes.c_int64 * max_n)()
        k = self._lib.bl_poll(self._h, buf, max_n, timeout_us)
        ids = [int(buf[i]) for i in range(k)]
        if ids:
            self._polled = ids[-1] + 1
        return ids

    def complete(self, query_id: int) -> None:
        if not 0 <= query_id < self._polled:  # the C side indexes unchecked
            raise ValueError(f"query {query_id} was not polled ({self._polled} polled)")
        self._lib.bl_complete(self._h, query_id)

    def mark_deferred(self, query_id: int) -> None:
        """Deferred queries stay in the percentiles: recorded only."""
        self.deferred.append(query_id)

    @property
    def completed(self) -> int:
        return int(self._lib.bl_completed(self._h))

    @property
    def issued(self) -> int:
        return int(self._lib.bl_issued(self._h))

    @property
    def pending(self) -> int:
        return int(self._lib.bl_pending(self._h))

    @property
    def done_issuing(self) -> bool:
        return bool(self._lib.bl_done_issuing(self._h))

    @property
    def drained(self) -> bool:
        return self.done_issuing and self.completed >= self.issued

    def now(self) -> float:
        return float(self._lib.bl_now(self._h))

    def stamps(self) -> np.ndarray:
        """(3, n) seconds: scheduled, issued (-1: not issued), completed (-1:
        not completed)."""
        if self._stamps is None:
            out = np.empty(3 * self.n, np.float64)
            self._lib.bl_stamps(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            return out.reshape(3, self.n)
        return self._stamps

    def report(self) -> dict:
        s = self.stamps()
        return dict(issued=self.issued, completed=self.completed,
                    wall_seconds=float(s[2].max()) if self.n else 0.0)

    def close(self) -> None:
        """Stop the issuer, keeping the stamps."""
        if self._h:
            self._stamps = self.stamps()
            self.closed_at = self.now()
            self._lib.bl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


@contextlib.contextmanager
def serving_from(schedule: np.ndarray, order: np.ndarray):
    """Within the block, the program's run_server_native issues from a
    ``LoadGen(schedule, order)``; yields a list that receives it."""
    from rnnt_inference_tpu_torch.runtime import native

    made: List[LoadGen] = []

    class Substitute(LoadGen):
        def __init__(self, n_samples, target_qps, mode="Server", seed=0, min_query_count=0,
                     min_duration_s=0.0):
            if mode != "Server":
                raise ValueError(f"the benchmark's loadgen issues Server traffic, not {mode}")
            super().__init__(schedule, order)
            made.append(self)

    saved = native.NativeLoadGen
    native.NativeLoadGen = Substitute
    try:
        yield made
    finally:
        native.NativeLoadGen = saved
