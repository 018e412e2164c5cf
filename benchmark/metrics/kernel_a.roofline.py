"""Kernel A (int8 LSTM layer): the least time of the traced calls' int8
products and bytes (from their shapes) over the kernel's time in the trace.
Silent when the calls recorded do not match the program's launch count."""

from benchmark import roofline


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.kernel_s(roofline.KERNEL_NAME["kernel_a"])
    calls = run.calls.get("kernel_a", [])
    if not busy or not calls or len(calls) != run.launches.get("quant_lstm_layer"):
        return None
    return 100.0 * roofline.kernel_a(calls) / busy
