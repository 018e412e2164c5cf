"""Is the card answering?  A CUDA probe with a deadline (counterpart of
rnnt_inference_tpu/utils/backend.py).

A wedged NVIDIA driver, for example after an Xid error, can block CUDA
initialisation in the process that tries it (``torch.cuda.is_available()``,
the first allocation, even ``nvidia-smi``) with no error and no timeout,
and an initialisation that blocked cannot be retried in that process.  So
the probe runs in a THROWAWAY SUBPROCESS, killed at its deadline with
everything it started: it imports torch, checks that a CUDA device is
available, runs one tiny op on cuda:0, synchronises and prints the card's
name and the device count.  ``wait_for_backend`` repeats it with
exponential backoff, so a card that recovers delays a run instead of
failing it, and one that does not recover fails it at a deadline instead
of hanging it.

The probe exits with status 3 when this torch is built without CUDA: no
card can appear by waiting, so ``wait_for_backend`` stops at once.

Override the probe with env ``RNNT_PROBE_CMD``, a shell command whose exit
status 0 means "the card answers" (3: "it never can"); the tests use it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Tuple

NO_CUDA = 3  # the probe's exit status when this torch has no CUDA at all

_PROBE_SRC = f"""
import sys, torch
if not torch.backends.cuda.is_built():
    print(f"torch {{torch.__version__}} is built without CUDA", file=sys.stderr)
    sys.exit({NO_CUDA})
if not torch.cuda.is_available():
    sys.exit("no CUDA device is available")
x = torch.arange(256, device="cuda:0", dtype=torch.float32)
s = float((x * 2).sum())
torch.cuda.synchronize()
if s != 65280.0:
    sys.exit(f"cuda:0 computed {{s}} for 65280")
print(f"cuda: {{torch.cuda.get_device_name(0)}}, devices={{torch.cuda.device_count()}}", flush=True)
"""


def _probe(timeout_s: float) -> Tuple[int, str]:
    """(exit status, detail) of one probe; -1 when it was killed at the
    deadline."""
    cmd = os.environ.get("RNNT_PROBE_CMD")
    argv, shell = (cmd, True) if cmd else ([sys.executable, "-c", _PROBE_SRC], False)
    # its own session, so the deadline kills the shell and whatever it started
    proc = subprocess.Popen(argv, shell=shell, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        try:
            proc.communicate(timeout=5.0)
        except subprocess.TimeoutExpired:  # stuck in the driver: cannot be reaped
            pass
        return -1, f"probe still blocked after {timeout_s:.0f}s"
    if proc.returncode != 0:
        tail = (err or out or "").strip().splitlines()
        return proc.returncode, f"probe rc={proc.returncode}: {tail[-1] if tail else ''}"
    return 0, (out or "").strip()


def probe_backend(timeout_s: float = 120.0) -> Tuple[bool, str]:
    """Return (ok, detail).  Never blocks much longer than timeout_s.

    ok=True means a throwaway subprocess reached the card and computed on
    it within the deadline; detail is its stdout (the card's name and the
    device count) or the failure reason.  The subprocess is killed on
    timeout, so a wedged driver costs timeout_s, not forever.
    """
    rc, detail = _probe(timeout_s)
    return rc == 0, detail


def wait_for_backend(
    deadline_s: float,
    probe_timeout_s: float = 120.0,
    initial_backoff_s: float = 20.0,
    max_backoff_s: float = 600.0,
    log=lambda m: print(m, file=sys.stderr, flush=True),
) -> bool:
    """Probe with exponential backoff until the card answers or the
    deadline passes.  Returns True iff the card became available."""
    t_end = time.monotonic() + deadline_s
    backoff = initial_backoff_s
    attempt = 0
    while True:
        attempt += 1
        remaining = t_end - time.monotonic()
        if remaining <= 0:
            log(f"backend probe: gave up after {attempt - 1} attempts "
                f"({deadline_s:.0f}s deadline)")
            return False
        rc, detail = _probe(min(probe_timeout_s, max(5.0, remaining)))
        if rc == 0:
            log(f"backend probe: available on attempt {attempt} ({detail})")
            return True
        remaining = t_end - time.monotonic()
        if remaining <= 0 or rc == NO_CUDA:
            log(f"backend probe: gave up after {attempt} attempts "
                f"({deadline_s:.0f}s deadline); last: {detail}")
            return False
        sleep = min(backoff, remaining)
        log(f"backend probe attempt {attempt}: unavailable ({detail}); "
            f"retrying in {sleep:.0f}s "
            f"({remaining:.0f}s left of {deadline_s:.0f}s deadline)")
        time.sleep(sleep)
        backoff = min(backoff * 2.0, max_backoff_s)
