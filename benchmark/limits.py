"""The readings a cell's limits are set from: for each seed a short run of
the cell, the program's mean logit gap on its sample, and the control's
(the reference one precision step down, put in the program's place) on the
same sample.

    python benchmark/limits.py --workload int8.offline.speech --seeds 1,2,3 --seconds 3

Prints one JSON line per seed.  The limit goes above the largest program
reading of a dozen seeds or more and below the smallest control reading
(benchmark/cells/<cell>.json, PERF.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark.common import REPO, Cell, log  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=1, help="0: the program's readings only")
    args = p.parse_args(argv)
    cell = Cell.load(args.workload, REPO)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run_cell(cell, "cuda", seed, args.seconds, False, t, bool(args.control))
        row = dict(workload=cell.name, seed=seed, correct=r["correct"],
                   program_mean_logit_gap=r["checks"]["mean_logit_gap"]["value"],
                   limit=r["checks"]["mean_logit_gap"]["limit"],
                   control=r.get("control"), metrics=r["metrics"],
                   seconds=time.perf_counter() - t)
        log(json.dumps(row))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
