"""The Offline rep's host tail, ms a traced rep: the program's
rnnt.offline.readback and rnnt.offline.harvest spans (user annotations on
the profiler's clock) inside the traced window, summed, over the traced
reps (the window's annotations)."""

from benchmark.trace import SPAN

TAIL = ("rnnt.offline.readback", "rnnt.offline.harvest")


def read(run):
    t = run.trace
    if t is None:
        return None
    notes = [e for e in t.events if e.get("cat") == "user_annotation"]
    reps = sum(e["name"] == SPAN for e in notes)
    tail = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in notes
            if e["name"] in TAIL]
    if not reps or not tail:
        return None
    return sum(max(0.0, min(b, t.hi) - max(a, t.lo)) for a, b in tail) / 1e3 / reps
