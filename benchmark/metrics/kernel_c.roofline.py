"""Kernel C (float LSTM recurrence): the least time of the traced calls (from
their shapes) at the bf16 peak over the kernel's time in the trace.  Silent
when the calls recorded do not match the program's launch count."""

from benchmark import roofline


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.kernel_s(roofline.KERNEL_NAME["kernel_c"])
    calls = run.calls.get("kernel_c", [])
    if not busy or not calls or len(calls) != run.launches.get("lstm_recurrence"):
        return None
    return 100.0 * roofline.kernel_c(calls) / busy
