"""The Conformer's subsampling in the packed runner's phase B: ms a rep,
the mean over the traced reps of OfflineResult.phase_seconds["subsample"]
(CUDA events at the runner's mark after each group's subsampling, summed).
Silent for an encoder without the phase."""


def read(run):
    reps = [p["subsample"] for p in run.phases if "subsample" in p]
    return 1e3 * sum(reps) / len(reps) if reps else None
