"""The host's ms per ServerRunner.step_async call (enqueueing one dispatch),
the mean over the window before the traced span (perf_counter around each
call)."""

def read(run):
    s = run.host_s.get("dispatch", [])
    return 1e3 * sum(s) / len(s) if s else None
