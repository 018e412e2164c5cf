"""The port's device tracing (rnnt_inference_tpu_torch/utils/profiler.py)
on the CPU: the idle-share arithmetic on a hand-made trace, the no-fallback
rule of device_trace, and a CPU trace's timed-rep span.  Its spans are
tested in tests/test_torch_spans.py."""

import pytest
import torch

from rnnt_inference_tpu_torch.utils import profiler


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_device_idle_share_counts_the_union_of_kernels_in_each_span():
    """Two timed reps of 100 us: kernels overlapping each other, crossing
    a span's edge and falling outside every span; a memcpy counts only
    when asked for; the device-side copy of the annotation is not a span."""
    events = [
        _x(profiler.TIMED_REP, 0, 100, "user_annotation"),
        _x(profiler.TIMED_REP, 200, 100, "user_annotation"),
        _x(profiler.TIMED_REP, 0, 100, "gpu_user_annotation"),
        _x("k1", 10, 20, "kernel"), _x("k2", 20, 20, "kernel"),  # union 10..40
        _x("k3", 90, 30, "kernel"),  # 90..100 inside the first span
        _x("k4", 150, 10, "kernel"),  # between the spans
        _x("k5", 250, 25, "kernel"), _x("copy", 280, 10, "gpu_memcpy"),
        _x("op", 0, 300, "cpu_op"),
    ]
    first, second = profiler.device_idle_share(events)
    assert (first["window_us"], first["busy_us"]) == (100, 40)
    assert first["idle_share"] == pytest.approx(0.6)
    assert (second["busy_us"], second["idle_share"]) == (25, pytest.approx(0.75))
    with_copies = profiler.device_idle_share(events, cats=profiler.DEVICE_CATS)
    assert with_copies[1]["busy_us"] == 35


def test_device_trace_raises_where_it_cannot_trace_the_card(tmp_path):
    """No fallback: asking for a CUDA trace from a build that cannot trace
    CUDA raises instead of writing an empty trace; no directory, no trace."""
    with profiler.device_trace(None) as path:
        assert path is None
    if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiler.device_trace(str(tmp_path / "t"), "cuda"):
                pass
    with profiler.device_trace(str(tmp_path / "c"), "cpu") as path:
        with torch.profiler.record_function(profiler.TIMED_REP):
            torch.ones(8) @ torch.ones(8)
    events = profiler.load_trace(path)
    (span,) = profiler.device_idle_share(events, cats=("cpu_op",))
    assert span["window_us"] > 0 and span["busy_us"] > 0

