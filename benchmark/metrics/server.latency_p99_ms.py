"""The Server's 99th percentile of latency (scheduled arrival to answer, on
the loadgen's clock) over the queries of the traced run whose life lies
wholly outside the profiled span, which the profiler's host work slows."""

import numpy as np


def read(run):
    return float(np.percentile(run.latency_ms, 99)) if run.latency_ms else None
