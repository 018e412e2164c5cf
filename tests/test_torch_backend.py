"""The port's card probe (rnnt_inference_tpu_torch/utils/backend.py), the
cases of tests/test_backend_probe.py on the port's module, and its two
callers: the port's bench and stage -1 of tools/run_stages.py.

The probe command is replaced through RNNT_PROBE_CMD, as the JAX tests do,
to play an outage that recovers, one that does not, and a probe that
blocks.  The bench under a dead probe prints one error line and never an
earlier record (the JAX bench re-emits its last good one marked stale; the
port has no such fallback).
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from rnnt_inference_tpu_torch.utils.backend import probe_backend, wait_for_backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counter_probe_cmd(tmp_path, succeed_after: int) -> str:
    cnt = tmp_path / "cnt"
    cnt.write_text("0")
    # POSIX sh: bump the counter, succeed once it reaches the threshold
    return f"n=$(cat {cnt}); n=$((n+1)); echo $n > {cnt}; [ $n -ge {succeed_after} ]"


def test_probe_recovers_after_outage(tmp_path, monkeypatch):
    monkeypatch.setenv("RNNT_PROBE_CMD", _counter_probe_cmd(tmp_path, succeed_after=3))
    msgs = []
    ok = wait_for_backend(deadline_s=30.0, probe_timeout_s=5.0, initial_backoff_s=0.01,
                          max_backoff_s=0.05, log=msgs.append)
    assert ok
    assert int((tmp_path / "cnt").read_text()) == 3
    assert any("retrying" in m for m in msgs)
    assert msgs[-1].startswith("backend probe: available on attempt 3")


def test_probe_gives_up_at_deadline(monkeypatch):
    monkeypatch.setenv("RNNT_PROBE_CMD", "false")
    msgs = []
    ok = wait_for_backend(deadline_s=0.2, probe_timeout_s=5.0, initial_backoff_s=0.05,
                          max_backoff_s=0.05, log=msgs.append)
    assert not ok
    assert any("gave up" in m for m in msgs)


def test_probe_timeout_kills_wedged_child(tmp_path, monkeypatch):
    """A probe that blocks forever costs the timeout, not a hang, and the
    deadline kills what it started too."""
    pid = tmp_path / "pid"
    monkeypatch.setenv("RNNT_PROBE_CMD", f"sleep 3600 & echo $! > {pid}; wait")
    t0 = time.monotonic()
    ok, detail = probe_backend(timeout_s=0.5)
    assert not ok and "blocked" in detail
    assert time.monotonic() - t0 < 10
    child = int(pid.read_text())
    deadline = time.monotonic() + 10
    while os.path.exists(f"/proc/{child}") and time.monotonic() < deadline:
        with open(f"/proc/{child}/stat") as f:  # a zombie is dead, only not yet reaped
            if f.read().split(") ")[-1].startswith("Z"):
                break
        time.sleep(0.05)
    else:
        assert not os.path.exists(f"/proc/{child}"), "the probe's own child outlived it"


def test_probe_without_cuda_gives_up_at_once(monkeypatch):
    """The real probe on a torch built without CUDA exits 3: no card can
    appear by waiting, so wait_for_backend stops after one attempt and says
    why."""
    monkeypatch.delenv("RNNT_PROBE_CMD", raising=False)
    if torch.backends.cuda.is_built():
        monkeypatch.setenv("RNNT_PROBE_CMD", "echo 'torch is built without CUDA' >&2; exit 3")
    msgs = []
    t0 = time.monotonic()
    ok = wait_for_backend(deadline_s=600.0, probe_timeout_s=120.0, log=msgs.append)
    assert not ok and time.monotonic() - t0 < 120
    (msg,) = msgs
    assert "gave up after 1 attempts" in msg and "last: probe rc=3: " in msg
    assert msg.endswith("built without CUDA")


def test_bench_unavailable_prints_one_error_line(tmp_path):
    """The port's bench under a dead probe: one JSON line on stdout with
    value 0 and "unavailable", exit code 1, and no stale record even when
    BENCH_LAST_GOOD_PATH holds one (the JAX bench would re-emit it)."""
    last_good = tmp_path / "last_good.json"
    last_good.write_text(json.dumps({
        "metric": "offline_audio_seconds_per_second", "value": 70347.0, "unit": "audio-s/s",
        "vs_baseline": 1.513, "measured_at": "2026-08-17T12:00:00"}))
    env = dict(os.environ, RNNT_PROBE_CMD="false", BENCH_DEADLINE_S="0.2",
               BENCH_LAST_GOOD_PATH=str(last_good))
    r = subprocess.run([sys.executable, "-m", "rnnt_inference_tpu_torch.bench"], cwd=REPO,
                       env=env, timeout=120, capture_output=True, text=True)
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert r.returncode == 1 and len(lines) == 1, (r.stdout, r.stderr[-2000:])
    payload = json.loads(lines[0])
    assert payload["metric"] == "offline_audio_seconds_per_second"
    assert payload["value"] == 0 and "unavailable" in payload["error"]
    assert "gave up" in payload["error"] and "stale" not in payload
    assert "70347" not in r.stdout


def test_bench_init_guard_gives_up(monkeypatch):
    """The probe answers but CUDA initialisation in the bench's own process
    blocks: the thread guard gives up after BENCH_BACKEND_TIMEOUT_S and says
    so; an initialisation that raises is the reason."""
    from rnnt_inference_tpu_torch import bench

    monkeypatch.setenv("RNNT_PROBE_CMD", "true")
    monkeypatch.setenv("BENCH_BACKEND_TIMEOUT_S", "0.2")
    monkeypatch.setattr(torch.cuda, "init", lambda: time.sleep(3))
    why = bench.card_unavailable(torch.device("cuda"))
    assert why == "CUDA initialisation still blocked after 0s"

    def broken():
        raise RuntimeError("driver says no")

    monkeypatch.setattr(torch.cuda, "init", broken)
    assert bench.card_unavailable(torch.device("cuda")) == "RuntimeError: driver says no"


@pytest.mark.parametrize("cmd,timeout,reason", [("false", "300", "probe rc=1"),
                                                ("sleep 3600", "0.3", "blocked")])
def test_prepare_env_stops_before_any_build(monkeypatch, cmd, timeout, reason):
    """Stage -1 with PLATFORM unset and a probe that fails or blocks:
    SystemExit with prepare_env.sh's text, before any kernel or the loadgen
    is built."""
    from rnnt_inference_tpu_torch.ops import cuda_build
    from rnnt_inference_tpu_torch.runtime import native
    from rnnt_inference_tpu_torch.tools import run_stages

    monkeypatch.setenv("RNNT_PROBE_CMD", cmd)
    monkeypatch.setattr(cuda_build, "build", lambda *a, **k: pytest.fail("built a kernel"))
    monkeypatch.setattr(native, "get_lib", lambda *a, **k: pytest.fail("built the loadgen"))
    with pytest.raises(SystemExit) as e:
        run_stages.prepare_env({"PREPARE_PROBE_TIMEOUT_S": timeout})
    msg = str(e.value)
    assert msg.startswith("  accelerator backend unavailable: ") and reason in msg
    assert msg.endswith("\n  (set PLATFORM=cpu to prepare without it)")
