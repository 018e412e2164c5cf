"""On the card: each configuration at its full widths through its kernels,
on an Offline store cut to 256 utterances on 256 lanes, comes out correct
against the reference, and the control (the reference one precision step
down) does not, at the cell's own limit.

    python -m pytest benchmark/tests/test_bench_cuda.py -q -m cuda
"""

import json
import shutil
import time

import pytest

from benchmark import harness
from benchmark.common import REPO, Cell

CELLS = ["int8.offline.speech", "bf16.offline.speech", "int8.offline.burst"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_full_width_cell_is_correct_and_its_control_is_not(card, name, tmp_path):
    root = tmp_path / "repo"
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("configs", "traffic", "cells", "metrics", "models", "reference"):
        shutil.copytree(REPO / "benchmark" / d, root / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    mix = {w["name"]: w for w in spec["workloads"]}[name]["traffic"]
    path = root / "benchmark" / "traffic" / f"{mix}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), utterances=256, lanes=256)))
    for seed in (31, 32, 33):
        r = harness.run_cell(Cell.load(name, root), card, seed, 1.0, False, time.perf_counter(),
                             control=True)
        limit = r["checks"]["mean_logit_gap"]["limit"]
        assert r["correct"] is True, r["checks"]
        assert r["control"]["mean_logit_gap"] > limit, r["control"]
