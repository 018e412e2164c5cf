"""Kernel F (the Conformer's relative-position attention, csrc/rel_attention.cu):
the least time of the traced calls over the kernel's time in the trace.
A call over utterances of T_i frames, H heads of d: 6 T_i^2 d operations a
head and utterance ((q + u) k, (q + v) p and . v at each pair the inputs
need) at the bf16 peak, against q, k, v and the output read or written
once (bf16) and the band of projected positions, 2 t_max - 1 rows, once.
Silent when the calls recorded do not match the program's launch count
(a program without kernel F records none)."""

from benchmark import roofline

NAME = "rel_attention_fwd"  # part of the kernel's name in the device trace


def least(calls) -> float:
    total = 0.0
    for lens, heads, d in calls:
        ops = 6.0 * sum(t * t for t in lens) * d * heads
        nbytes = 2.0 * heads * d * (4 * sum(lens) + 2 * max(lens) - 1)
        total += roofline.least(ops, nbytes, "bf16")
    return total


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.kernel_s(NAME)
    calls = run.calls.get("kernel_f", [])
    if not busy or not calls or len(calls) != run.launches.get("attention"):
        return None
    return 100.0 * least(calls) / busy
