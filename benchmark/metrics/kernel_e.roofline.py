"""Kernel E (the bf16 product on the tensor cores: the float encoder's
projection, the joint's fproj): the least time of the traced calls (from
their shapes) at the bf16 peak over the kernel's time in the trace.  Silent
when the calls recorded do not match the program's launch count."""

from benchmark import roofline


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.kernel_s(roofline.KERNEL_NAME["kernel_e"])
    calls = run.calls.get("kernel_e", [])
    if not busy or not calls or len(calls) != run.launches.get("projection"):
        return None
    return 100.0 * roofline.kernel_e(calls) / busy
