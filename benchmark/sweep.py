"""The sweep that fixes a Server mix's rate (run once, when the cell is
defined; its levels and R go into the mix's file and PERF.md).

    python benchmark/sweep.py --workload int8.server.poisson --levels 300,400,500 --seconds 20

One set-up, then each level in turn: Poisson arrivals at the level for
``seconds``, served until every query is answered.  A level is sustained
when every query issued was answered, the p99 latency (from the scheduled
arrival) is at most 1,000 ms, and the answers of the window's second half
come within 2% of its arrivals (a queue that grows makes them lag).  R is
80% of the highest sustained level, rounded down to 10 QPS.  Prints one JSON line per level and
one with R.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import traffic  # noqa: E402
from benchmark.common import REPO, Cell, log  # noqa: E402
from benchmark.server import Serving, latencies  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--levels", required=True, help="comma-separated QPS")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cell = Cell.load(args.workload, REPO)
    sv = Serving(cell, torch.device("cuda"), args.seed)
    best = 0.0
    for k, qps in enumerate(float(q) for q in args.levels.split(",")):
        sched, order = sv.schedule(qps, args.seconds, traffic.substreams(args.seed, 8)[6] + k)
        lg, _ = sv.serve(sched, order, args.seconds)
        lat, answered, last = latencies(lg)
        half = args.seconds / 2
        done = lg.stamps()[2]
        served = float(((done >= half) & (done < args.seconds)).sum()) / half
        offered = float((sched >= half).sum()) / half
        ok = bool(answered.all() and np.percentile(lat, 99) <= 1000.0
                  and served >= 0.98 * offered)
        row = dict(qps=qps, offered=offered, served=served, issued=len(sched),
                   answered=int(answered.sum()), p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)), max_ms=float(lat.max()),
                   last_answer_s=last, sustained=ok)
        log(json.dumps(row))
        print(json.dumps(row), flush=True)
        if ok:
            best = max(best, qps)
    print(json.dumps({"highest_sustained_qps": best, "R": float(np.floor(0.8 * best / 10) * 10)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
