"""The card's idle share over the traced span of the Server window: 1 -
(union of kernel intervals) / window, from torch.profiler."""

def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
