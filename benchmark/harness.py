"""One run of one cell: the driver of its traffic kind, the reference's
check of what the window served, the metrics, and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from BENCHMARK.json: the cell's configuration
(its "file") and the model module it names (benchmark/models/<model>.py,
through which the drivers, the check and the readers reach the weights, the
program, the reference and the work counts), its traffic mix
(benchmark/traffic/<traffic>.json, whose "kind" picks the driver), its
entry (benchmark/cells/<cell>.json: the replayed emission model and the
check's limits) and each per-layer metric's reader
(benchmark/metrics/<metric>.py, ``read(run)`` returning a number or None
when it finds nothing to read).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics), device, with --trace 1 breakdown, and last the numbers
the check compared, each with its limit.  The same numbers end standard
error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark import check, models
from benchmark.common import REPO, Cell, Run, log

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "rnnt_inference_tpu")


def drivers() -> Dict[str, Callable]:
    from benchmark import offline, server

    return {"offline": offline.run, "server": server.run}


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def reader(cell: Cell, name: str):
    """The ``read`` function of benchmark/metrics/<name>.py."""
    path = cell.repo / "benchmark" / "metrics" / f"{name}.py"
    return models.from_file(path, f"benchmark.metrics.{name}").read


def metrics_of(cell: Cell, run: Run, traced: bool) -> Dict[str, dict]:
    out = {}
    if not traced:
        for m in cell.end_to_end():
            if m["name"] not in run.e2e:
                raise RuntimeError(f"the {cell.traffic['kind']} driver does not measure "
                                   f"{m['name']}")
            out[m["name"]] = {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
        return out
    for m in cell.per_layer():
        value = reader(cell, m["name"])(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
        else:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(cell: Cell, run: Run, device) -> Dict[str, dict]:
    """The numbers compared, each with its limit."""
    t0 = time.perf_counter()
    gaps = check.gaps(cell.config, run.weights, cell.traffic["max_symbols_per_step"],
                      run.check_wavs, run.check_tokens, device, cell.model)
    log(f"check: {len(gaps)} answers, {sum(len(t) for t in run.check_tokens)} tokens in "
        f"{time.perf_counter() - t0:.2f} s; widest logit gap by answer "
        f"{[float(f'{g:.3g}') for g in gaps]}")
    return {"mean_logit_gap": {"value": min(check.mean_gap(gaps), 1e30),
                               "limit": float(cell.entry["limits"]["mean_logit_gap"])},
            "unanswered": {"value": run.failed, "limit": 0}}


def run_cell(cell: Cell, device, seed: int, seconds: float, traced: bool,
             t_begin: float, control: bool = False) -> dict:
    """The result of one run (the result line's object).  control=True also
    reads the control's widest gap on the same sample (benchmark/limits.py;
    the benchmark's own runs do not)."""
    device = torch.device(device)
    drive = drivers()[cell.traffic["kind"]]
    run = drive(cell, device, seed, seconds, traced, t_begin)
    metrics = metrics_of(cell, run, traced)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.memory_peak}
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    run.trace = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, run, device)
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    if control:
        cap = cell.traffic["max_symbols_per_step"]
        toks = check.control_tokens(cell.config, run.weights, cap, run.check_wavs, device,
                                    cell.model)
        gaps = check.gaps(cell.config, run.weights, cap, run.check_wavs, toks, device, cell.model)
        result["control"] = {"mean_logit_gap": check.mean_gap(gaps), "gaps": gaps,
                             "tokens_differing": sum(int(not np.array_equal(a, b)) for a, b in
                                                     zip(toks, run.check_tokens))}
    result["checks"] = checks
    return result


def main(argv=None, t_begin: Optional[float] = None) -> int:
    t_begin = time.perf_counter() if t_begin is None else t_begin
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell.load(args.workload, REPO)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(f"device={torch.cuda.get_device_name(0)} torch={torch.__version__} "
        f"cuda={torch.version.cuda} cell={cell.name} seed={args.seed} seconds={args.seconds} "
        f"trace={args.trace}")
    result = run_cell(cell, "cuda", args.seed, args.seconds, bool(args.trace), t_begin)
    found = forbidden_modules()
    if found:
        log(f"modules that a run may not load are loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
