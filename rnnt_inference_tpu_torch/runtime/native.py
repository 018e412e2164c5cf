"""ctypes bindings for the native mini-loadgen (counterpart of
rnnt_inference_tpu/runtime/native.py).

The port keeps its own copy of the C++ source, ``csrc/rnnt_loadgen.cpp``
(plain C ABI, no pybind11).  It is compiled with g++ on first use into
``build/torch_kernels/librnnt_loadgen-<hash>.so`` at the repository root
(the hash is of the source and the flags; ops/cuda_build.py compile_libs,
the build step of the CUDA kernels).  Nothing is built at import.  A failed
build raises with the compiler's output: a --native_loadgen run never goes
on without the native clock.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

from rnnt_inference_tpu_torch.ops import cuda_build

SRC = cuda_build.CSRC / "rnnt_loadgen.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_lib(src: Path = SRC, build_dir: Path = cuda_build.BUILD_DIR) -> Path:
    """The loadgen library compiled from ``src`` into ``build_dir`` (built
    there unless a library of the same source and flags is there already).
    Raises RuntimeError with g++'s output when the build fails."""
    out = cuda_build.hashed_lib_path("rnnt_loadgen", [src], GXX_FLAGS, build_dir)
    if not out.exists():
        cuda_build.compile_libs({"rnnt_loadgen": (["g++", *GXX_FLAGS], src, out)})
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lg_create.restype = ctypes.c_void_p
    lib.lg_create.argtypes = [ctypes.c_int64, ctypes.c_double, ctypes.c_int, ctypes.c_uint64,
                              ctypes.c_int64, ctypes.c_double]
    lib.lg_destroy.argtypes = [ctypes.c_void_p]
    lib.lg_destroy.restype = None
    lib.lg_poll.restype = ctypes.c_int
    lib.lg_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                            ctypes.c_int64]
    for name in ("lg_complete", "lg_mark_deferred"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        fn.restype = None
    for name in ("lg_completed", "lg_issued", "lg_pending", "lg_done_issuing", "lg_n_samples"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.lg_report.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.lg_report.restype = None
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded loadgen library, built first if needed (raises if the
    build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build_lib(SRC))))
        return _lib


class NativeLoadGen:
    """Native issue thread + latency recorder.

    mode: "Server" (Poisson at target_qps), "Offline" (all at t=0), or
    "SingleStream" (issue-after-complete).  Queries loop over the sample set:
    query q refers to sample q % n_samples (``sample_of``).  The issuer honors
    min_query_count AND min_duration together, like loadgen's rules.
    """

    MODES = {"Server": 0, "Offline": 1, "SingleStream": 2}
    _h = None  # the C handle; None once closed

    def __init__(
        self,
        n_samples: int,
        target_qps: float,
        mode: str = "Server",
        seed: int = 0,
        min_query_count: int = 0,
        min_duration_s: float = 0.0,
    ):
        self._lib = get_lib()
        self._h = self._lib.lg_create(n_samples, target_qps, self.MODES[mode], seed,
                                      min_query_count, min_duration_s)
        self.n = n_samples
        self._polled = 0  # ids below this were polled

    def sample_of(self, query_id: int) -> int:
        return query_id % self.n

    def poll(self, max_n: int = 64, timeout_us: int = 1000) -> List[int]:
        """Pull up to max_n pending query ids, waiting at most timeout_us
        for the first."""
        buf = (ctypes.c_int64 * max_n)()
        k = self._lib.lg_poll(self._h, buf, max_n, timeout_us)
        ids = [int(buf[i]) for i in range(k)]
        if ids:  # ids arrive in issue order
            self._polled = ids[-1] + 1
        return ids

    def _polled_query(self, query_id: int) -> int:
        # the C side indexes its per-query arrays with the id unchecked
        if not 0 <= query_id < self._polled:
            raise ValueError(f"query {query_id} was not polled ({self._polled} polled)")
        return query_id

    def complete(self, query_id: int) -> None:
        """Stamp a polled query complete on the native clock."""
        self._lib.lg_complete(self._h, self._polled_query(query_id))

    def mark_deferred(self, query_id: int) -> None:
        """Flag a QoS-deferred query: its completion is kept out of the live
        latency percentiles and the wall, and reported apart (the reference
        drains its QoS queue only after FlushQueries, outside the measured
        window)."""
        self._lib.lg_mark_deferred(self._h, self._polled_query(query_id))

    @property
    def completed(self) -> int:
        return int(self._lib.lg_completed(self._h))

    @property
    def issued(self) -> int:
        return int(self._lib.lg_issued(self._h))

    @property
    def pending(self) -> int:
        """Issued queries not polled yet."""
        return int(self._lib.lg_pending(self._h))

    @property
    def done_issuing(self) -> bool:
        return bool(self._lib.lg_done_issuing(self._h))

    @property
    def drained(self) -> bool:
        """All issued queries completed and the issuer has finished."""
        return self.done_issuing and self.completed >= self.issued

    def report(self) -> dict:
        """Latency summary.  Percentiles cover live completions only;
        QoS-deferred completions (mark_deferred) are reported apart."""
        out = (ctypes.c_double * 12)()
        self._lib.lg_report(self._h, out)
        return dict(
            completed=int(out[0]) + int(out[9]),
            completed_live=int(out[0]),
            latency_ms_mean=round(out[1], 2),
            latency_ms_p50=round(out[2], 2),
            latency_ms_p90=round(out[3], 2),
            latency_ms_p99=round(out[4], 2),
            latency_ms_max=round(out[5], 2),
            wall_seconds=round(out[6], 3),
            qps=round(out[7], 2),
            issued=int(out[8]),
            deferred_completed=int(out[9]),
            deferred_ms_mean=round(out[10], 2),
            deferred_ms_max=round(out[11], 2),
        )

    def close(self) -> None:
        """Stop the issuer thread and free the recorder."""
        if self._h:
            self._lib.lg_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
