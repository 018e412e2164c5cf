"""The host's ms per ServerRunner.insert_samples call (featurizing and
placing up to insert_batch queries), the mean over the window before the
traced span (perf_counter around each call)."""

def read(run):
    s = run.host_s.get("insert", [])
    return 1e3 * sum(s) / len(s) if s else None
