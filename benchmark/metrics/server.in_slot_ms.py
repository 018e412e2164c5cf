"""The Server's in_slot stage, ms: the median, from a query's insert to the
end of the enqueue of the dispatch whose finish mask first holds its slot,
over the queries completed between 1 s and trace_from_s - 0.5 s into the
last run_server_native call (before the profiler starts, after the
pipeline fills), from the program's per-query record."""

import numpy as np


def read(run):
    try:
        from rnnt_inference_tpu_torch.utils.profiler import REGISTRY
    except ImportError:  # a program without the span registry
        return None
    if REGISTRY.server is None:
        return None
    st = REGISTRY.server.stages(1.0, run.cell.traffic["trace_from_s"] - 0.5)["in_slot"]
    return float(np.median(st)) / 1e6 if len(st) else None
