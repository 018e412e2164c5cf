"""The whole Offline step's share of the card's peak: the least time of the
model's products (encoder, prediction net, joint) for the audio of the
traced reps, each at its precision's peak, over the traced window.
Features are left out (their own layer metric)."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.work:
        return None
    w = run.work
    least = roofline.model_least(run.cell.config, w["frames"], w["post_frames"], w["symbols"])
    return 100.0 * least / run.trace.window_s
