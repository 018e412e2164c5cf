"""The whole Offline step's share of the card's peak: the least time of the
model's products (the cell's model counts them, ``least``: encoder,
prediction net, joint) for the audio of the traced reps, each at its
precision's peak, over the traced window.  Features are left out (their own
layer metric)."""


def read(run):
    if run.trace is None or not run.work:
        return None
    return 100.0 * run.cell.model.least(run.cell.config, run.work) / run.trace.window_s
