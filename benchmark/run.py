"""The benchmark's command: one run of one cell on the CUDA card(s) of this
machine (benchmark/harness.py says what it prints).

    python3 benchmark/run.py --workload int8.offline.speech --seed 7 --seconds 20 --trace 0

Run from the root of a checkout.  Builds go into build/ of the checkout (the
program's kernels into build/torch_kernels/, the load generator into
build/benchmark/), so only the first run in a checkout builds.
"""

import time

T_BEGIN = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one intra-op thread: the host-bound Server loop read steadier with it
# (PERF.md, PR 16), and the program does no large work on the CPU
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(REPO, "build", "benchmark", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(REPO, "build", "benchmark", "torch_ext")
sys.path.insert(0, REPO)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_BEGIN))
