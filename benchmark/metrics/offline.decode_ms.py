"""Phase C (decode) of the packed runner: ms a rep, the mean over
the traced reps of OfflineResult.phase_seconds (CUDA events between the
runner's phase marks)."""


def read(run):
    reps = [p["decode"] for p in run.phases if "decode" in p]
    return 1e3 * sum(reps) / len(reps) if reps else None
