"""The harness on the CPU: traffic, trace and roofline arithmetic, cells and
models found by name from files, and what a run may import."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness, roofline, traffic
from benchmark.common import Cell, Run
from benchmark.harness import metrics_of
from benchmark.models import rnnt
from benchmark.trace import Trace, union_us

REPO = tiny.REPO


# -- traffic ---------------------------------------------------------------


def test_traffic_is_a_function_of_the_seed():
    law = tiny.DURATION
    big = 2 ** 31 + 12345  # seeds past 32 signed bits
    a = traffic.substreams(big, 4)
    assert a == traffic.substreams(big, 4) and a != traffic.substreams(big + 1, 4)
    la, wa = traffic.store(law, 20, a[0], "cpu")
    lb, wb = traffic.store(law, 20, a[0], "cpu")
    np.testing.assert_array_equal(la, lb)
    assert all(np.array_equal(x, y) for x, y in zip(wa, wb))
    assert [len(w) for w in wa] == list(la)
    rms = [float(np.sqrt(np.mean(w.astype(np.float64) ** 2))) for w in wa]
    assert np.allclose(rms, 0.1, rtol=0.01)
    # the same utterances for every seed, in another order
    lc, wc = traffic.store(law, 20, a[1], "cpu")
    assert not np.array_equal(la, lc)
    key = lambda ws: sorted(w.tobytes() for w in ws)
    assert key(wa) == key(wc)
    pa = traffic.speechlike(la, a[2], "cpu")
    assert pa.dtype == torch.int16 and pa.numel() == la.sum()
    assert torch.equal(pa, traffic.speechlike(la, a[2], "cpu"))
    assert not torch.equal(pa, traffic.speechlike(la, a[3], "cpu"))
    (s1, q1), (s2, q2) = traffic.arrivals(50.0, 4.0, 10, 5, 9), traffic.arrivals(50.0, 4.0, 10, 5, 9)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(q1, q2)
    assert s1[-1] < 4.0 and np.all(np.diff(s1) > 0) and 120 < len(s1) < 280
    assert len(q1) == len(s1) and 0 <= q1.min() and q1.max() < 10
    # the same gaps in another order
    s3, _ = traffic.arrivals(50.0, 4.0, 10, 5, 10)
    assert not np.array_equal(s1[:20], s3[:20])
    assert abs(len(s3) - len(s1)) < 40
    pick = traffic.check_sample(100, 8, 3, [97, 5])
    assert pick == traffic.check_sample(100, 8, 3, [97, 5]) and len(pick) == 8
    assert {97, 5} <= set(pick)


# -- trace arithmetic --------------------------------------------------------


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_union_and_idle_share_by_hand():
    assert union_us([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert union_us([(0, 10), (5, 15), (20, 30)], 8, 25) == 12
    events = [
        _ev("benchmark.window", "user_annotation", 100, 100),  # window 100..200
        _ev("quant_lstm<...>", "kernel", 90, 30),  # 100..120 inside
        _ev("decode_loop<...>", "kernel", 110, 20),  # overlaps: union 100..130
        _ev("Memcpy DtoH", "gpu_memcpy", 150, 10),
        _ev("lstm_scan<...>", "kernel", 190, 40),  # 190..200 inside
        _ev("aten::mm", "cpu_op", 125, 50),  # the host, from 125 to 175
        _ev("cudaStreamSynchronize", "cuda_runtime", 160, 30),
    ]
    t = Trace.of(events)
    assert (t.lo, t.hi) == (100, 200) and t.window_s == pytest.approx(1e-4)
    assert t.busy_s(("kernel",)) == pytest.approx(40e-6)
    assert t.busy_s() == pytest.approx(50e-6)
    assert t.idle_share() == pytest.approx(0.6)
    assert t.kernel_s("quant_lstm") == pytest.approx(20e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["quant_lstm<...>", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # idle 130..150 (aten::mm running), 160..190 (the synchronize, inside aten::mm)
    assert gaps == {"aten::mm": pytest.approx(20e-6),
                    "cudaStreamSynchronize": pytest.approx(30e-6)}
    assert Trace.of([_ev("k", "kernel", 0, 1)]) is None


# -- rooflines ---------------------------------------------------------------


def test_roofline_counts_by_hand():
    # one kernel-A call: 16 steps of 1024 lanes, IC 240, H 1024, int8 out
    ops = 2 * 16 * 1024 * (240 + 1024) * 4096
    nbytes = 1264 * 4096 + 4096 * 4 + 16 * 1024 * 240 + 16 * 1024 * 1024 + 2 * 1024 * 1024 * 5
    assert roofline.kernel_a([(16, 1024, 240, 1024, False)]) == pytest.approx(
        max(ops / 1979e12, nbytes / 3.35e12))
    assert ops / 1979e12 > nbytes / 3.35e12  # operations bound it
    # kernel C: bf16 recurrence of 48 steps, 128 lanes, H 1024
    c_ops = 2 * 48 * 128 * 1024 * 4096
    c_bytes = 1024 * 4096 * 2 + 48 * 128 * 4096 * 2 + 48 * 128 * 1024 * 2 + 2 * 128 * 1024 * 6
    assert roofline.kernel_c([(48, 128, 1024, "bf16")]) == pytest.approx(
        max(c_ops / 989e12, c_bytes / 3.35e12))
    # kernel E: post-net layer 0 (8,192 x 2,048 x 4,096, bias, bf16 out), bound by operations
    e_ops = 2 * 8192 * 2048 * 4096
    e_bytes = 2 * (8192 * 2048 + 2048 * 4096) + 4096 * 4 + 8192 * 4096 * 2
    assert roofline.kernel_e([(8192, 2048, 4096, True, "bf16")]) == pytest.approx(
        max(e_ops / 989e12, e_bytes / 3.35e12))
    assert e_ops / 989e12 > e_bytes / 3.35e12
    # the joint's fproj (8,192 x 1,024 x 512, no bias, f32 out), bound by bytes
    f_ops = 2 * 8192 * 1024 * 512
    f_bytes = 2 * (8192 * 1024 + 1024 * 512) + 8192 * 512 * 4
    assert roofline.kernel_e([(8192, 1024, 512, False, "f32")]) == pytest.approx(f_bytes / 3.35e12)
    assert f_bytes / 3.35e12 > f_ops / 989e12
    assert roofline.kernel_e([(8192, 2048, 4096, True, "bf16"), (8192, 1024, 512, False, "f32")]) \
        == pytest.approx(e_ops / 989e12 + f_bytes / 3.35e12)
    # the model's own counts (benchmark/models/rnnt.py)
    cfg = json.loads((REPO / "benchmark/configs/rnnt_mlperf_int8.json").read_text())
    # one decode iteration: 2 layers x (x W_ih + h W_hh) of 320 x 1280, 320 x 512, 512 x 29
    it = 2 * (2 * 2 * 320 * 1280 + 320 * 512 + 512 * 29)
    assert rnnt.decode_iteration_ops(cfg) == it
    wb = 2 * (2 * 2 * 320 * 1280 + 28 * 320 + 320 * 512 + 512 * 29)  # bf16, the embedding too
    assert rnnt.decode_costs(cfg) == dict(iteration_ops=it, weight_bytes=wb, frame_bytes=512 * 4,
                                          precision="bf16")
    assert roofline.kernel_b(1000.0, 600.0, 2, it, wb, 512 * 4, "bf16") == pytest.approx(
        max(1000 * it / 989e12, (2 * wb + 600 * 512 * 4) / 3.35e12))
    # one second of audio: 34 feature frames, 17 stacked, 13 symbols
    enc = 2 * 4096 * (34 * ((240 + 1024) + 2048) + 17 * ((2048 + 1024) + 2 * 2048))
    assert rnnt.encoder_ops(cfg, 34, 17) == enc
    want = enc / 1979e12 + ((17 + 13) * it + 2 * 17 * 1024 * 512) / 989e12
    assert rnnt.least(cfg, dict(frames=34, post_frames=17, symbols=13)) == pytest.approx(want)
    bf = dict(cfg, precision=dict(encoder="bf16", prediction="bf16", joint="bf16"))
    assert rnnt.least(bf, dict(frames=34, post_frames=17, symbols=13)) == pytest.approx(
        enc / 989e12 + ((17 + 13) * it + 2 * 17 * 1024 * 512) / 989e12)


# -- found by name -----------------------------------------------------------


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    root = tiny.make_repo(tmp_path)
    b = root / "benchmark"
    cfg = tiny.tiny_config(dict(encoder="bf16", prediction="bf16", joint="bf16"), 77)
    cfg["name"] = "dummy_model"
    (b / "configs" / "dummy_model.json").write_text(json.dumps(cfg))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(dict(tiny.OFFLINE, utterances=9)))
    (b / "cells" / "dummy.cell.json").write_text(json.dumps(
        dict(emission=tiny.EMISSION["tiny_bf16"], limits=dict(mean_logit_gap=0.25))))
    (b / "metrics" / "dummy.reps.py").write_text(
        '"""How many reps were traced."""\n\n\ndef read(run):\n    return len(run.phases)\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="dummy_model", source="https://example.org/dummy",
                                file="benchmark/configs/dummy_model.json", reduced=[], why="test"))
    spec["workloads"].append(dict(name="dummy.cell", config="dummy_model", traffic="dummy_mix",
                                  chips=1, why="test"))
    spec["per_layer"].append(dict(name="dummy.reps", unit="reps", better="higher",
                                  source="program_span", layer="test", moves="audio_s_per_s",
                                  workloads=["dummy.cell"]))
    for m in spec["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Cell.load("dummy.cell", root)
    assert cell.config["weight_seed"] == 77 and cell.traffic["utterances"] == 9
    assert cell.entry["limits"]["mean_logit_gap"] == 0.25
    assert [m["name"] for m in cell.end_to_end()] == ["audio_s_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer()] == ["dummy.reps"]
    run = Run(cell=cell, phases=[{}, {}, {}])
    assert metrics_of(cell, run, True) == {"dummy.reps": {"value": 3.0, "unit": "reps"}}


def test_every_metric_in_benchmark_json_has_a_reader_and_every_cell_its_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for w in spec["workloads"]:
        cell = Cell.load(w["name"], REPO)
        assert cell.per_layer() and len(cell.end_to_end()) >= 2
        assert cell.traffic["kind"] in ("offline", "server")


TWIN = '''"""The RNN-T under another name: every function of the model interface is
rnnt's (benchmark/models/rnnt.py of this checkout), and each call it serves
is recorded in SERVED."""

from pathlib import Path

from benchmark import models

_rnnt = models.load("rnnt", Path(__file__).resolve().parents[2])
SERVED = []


def _serving(name):
    def serve(*args, **kw):
        SERVED.append(name)
        return getattr(_rnnt, name)(*args, **kw)

    return serve


for _name in models.INTERFACE:
    globals()[_name] = _serving(_name)
'''


def test_a_second_model_is_added_as_files_alone(tmp_path):
    """A configuration naming another model module is served through that
    module alone: new files and BENCHMARK.json entries, no file of the
    checkout edited, and the same result as under "model": "rnnt"."""
    root = tiny.make_repo(tmp_path)
    b = root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    (b / "models" / "rnnt_twin.py").write_text(TWIN)
    cfg = json.loads((b / "configs" / "tiny_int8.json").read_text())
    (b / "configs" / "tiny_twin.json").write_text(json.dumps(dict(cfg, name="tiny_twin",
                                                                   model="rnnt_twin")))
    (b / "traffic" / "twin_offline.json").write_text(json.dumps(tiny.OFFLINE))
    (b / "cells" / "twin.int8.offline.json").write_text(
        (b / "cells" / "tiny.int8.offline.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_twin", source="https://example.org/twin",
                                file="benchmark/configs/tiny_twin.json", reduced=[], why="test"))
    spec["workloads"].append(dict(name="twin.int8.offline", config="tiny_twin",
                                  traffic="twin_offline", chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.int8.offline" in m.get("workloads", []):
            m["workloads"].append("twin.int8.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == data for p, data in before.items())

    cells = {n: Cell.load(n, root) for n in ("tiny.int8.offline", "twin.int8.offline")}
    twin = cells["twin.int8.offline"].model
    assert twin.__file__ == str(b / "models" / "rnnt_twin.py") and twin.SERVED == []
    assert cells["tiny.int8.offline"].model.__file__ == str(b / "models" / "rnnt.py")
    seed = 2 ** 31 + 77
    for traced in (False, True):
        r = {n: harness.run_cell(c, "cpu", seed, 0.6, traced, time.perf_counter())
             for n, c in cells.items()}
        ours, theirs = r["tiny.int8.offline"], r["twin.int8.offline"]
        assert theirs["correct"] is True
        for key in ("correct", "failed", "checks"):
            assert ours[key] == theirs[key], key
        # the values are timings; the metrics reported are the same
        assert {k: v["unit"] for k, v in ours["metrics"].items()} == \
            {k: v["unit"] for k, v in theirs["metrics"].items()}
        if traced:
            assert "offline.mfu" in theirs["metrics"]
    assert {"random_weights", "apply_emission", "program", "reference", "work", "least",
            "recording"} <= set(twin.SERVED)


def test_a_configuration_without_a_model_key_is_refused(tmp_path):
    root = tiny.make_repo(tmp_path)
    path = root / "benchmark" / "configs" / "tiny_bf16.json"
    cfg = json.loads(path.read_text())
    del cfg["model"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match='"model"'):
        Cell.load("tiny.bf16.offline", root)
    path.write_text(json.dumps(dict(cfg, model="no_such_model")))
    with pytest.raises(ValueError, match="no_such_model"):
        Cell.load("tiny.bf16.offline", root)


# the RNN-T configuration keys that only its model module and reference read
RNNT_KEYS = ("stack_time_factor", "trans_hidden_size", "pre_num_layers", "post_num_layers",
             "pred_num_layers", "trans_input_size")
OWN = ("models", "reference", "configs", "tests")  # what belongs to a model, and the tests


def test_no_shared_module_names_an_rnnt_configuration_key():
    bench = REPO / "benchmark"
    shared = sorted(p for p in bench.rglob("*.py")
                    if p.relative_to(bench).parts[0] not in OWN and "__pycache__" not in p.parts)
    names = {str(p.relative_to(bench)) for p in shared}
    assert {"harness.py", "common.py", "offline.py", "server.py", "check.py",
            "calibrate_emission.py", "limits.py", "sweep.py", "metrics/offline.mfu.py",
            "metrics/kernel_b.roofline.py"} <= names
    for p in shared:
        text = p.read_text()
        assert not [k for k in RNNT_KEYS if k in text], p


# -- what a run loads ----------------------------------------------------------

FORBIDDEN_CHECK = r"""
import sys, time
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from pathlib import Path
import tiny
from benchmark import harness
from benchmark.common import Cell
root = tiny.make_repo(Path({tmp!r}))
harness.run_cell(Cell.load("tiny.int8.offline", root), "cpu", 5, 0.2, False, time.perf_counter())
print(harness.forbidden_modules())
print(sorted(m for m in sys.modules if m.split(".")[0] == "rnnt_inference_tpu_torch")[:1])
"""


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program(tmp_path):
    code = FORBIDDEN_CHECK.format(repo=str(REPO), tests=os.path.dirname(__file__),
                                  tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, program = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert program != "[]"  # the run did load the port
    ref = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(REPO)!r}); import benchmark.reference.rnnt, "
         "benchmark.check; print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'rnnt_inference_tpu_torch', 'rnnt_inference_tpu', 'jax', 'jaxlib', 'flax'}))"],
        capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert ref.stdout.strip() == "[]"


def test_the_command_without_a_card_or_the_program_prints_no_result(tmp_path):
    cmd = [sys.executable, "benchmark/run.py", "--workload", "int8.offline.speech", "--seed",
           "3", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    bare = tmp_path / "bare"
    (bare / "benchmark").mkdir(parents=True)
    (bare / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    for f in (REPO / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            dest = bare / f.relative_to(REPO)
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(f.read_bytes())
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
