"""The yardstick of the rooflines and of mfu: the card's published peaks and
the operations and bytes each kernel's calls need (the model's own products,
mfu's numerator, are counted by its module, ``cell.model.least``).

Least time = max(operations / peak of their precision, bytes / bandwidth),
each input byte counted read once and each output byte written once.  The
peaks are those of an H100 SXM at 700 W (NVIDIA's data sheet, dense).
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_OPS = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}
BANDWIDTH = 3.35e12  # bytes/s
ITEM = {"int8": 1, "bf16": 2, "f32": 4}

# a substring of each kernel's name in the device trace
KERNEL_NAME = {"kernel_a": "quant_lstm", "kernel_b": "decode_loop", "kernel_c": "lstm_scan",
               "kernel_e": "projection"}


def least(ops: float, nbytes: float, prec: str) -> float:
    return max(ops / PEAK_OPS[prec], nbytes / BANDWIDTH)


def kernel_a(calls: Iterable[Tuple[int, int, int, int, bool]]) -> float:
    """Kernel A, one int8 LSTM layer over a chunk: per call (T steps, N lanes,
    IC inputs, H units, f32 output?): x (T, N, IC) and h (N, H) int8 times
    W_ih, W_hh int8; gates, cell in f32."""
    total = 0.0
    for T, N, IC, H, f32_out in calls:
        ops = 2.0 * T * N * (IC + H) * 4 * H
        nbytes = ((IC + H) * 4 * H + 4 * H * 4  # weights, bias
                  + T * N * IC + T * N * H * (4 if f32_out else 1)  # x in, y out
                  + 2 * N * H * (1 + 4))  # h int8 and c f32, in and out
        total += least(ops, nbytes, "int8")
    return total


def kernel_c(calls: Iterable[Tuple[int, int, int, str]]) -> float:
    """Kernel C, a float LSTM recurrence over a chunk: per call (T, N, H,
    dtype): xw (T, N, 4H) plus h W_hh, the cell; y (T, N, H)."""
    total = 0.0
    for T, N, H, prec in calls:
        e = ITEM[prec]
        ops = 2.0 * T * N * H * 4 * H
        nbytes = H * 4 * H * e + T * N * 4 * H * e + T * N * H * e + 2 * N * H * (e + 4)
        total += least(ops, nbytes, prec)
    return total


def kernel_b(iterations: float, frames: float, launches: int, iteration_ops: float,
             weight_bytes: float, frame_bytes: float, prec: str) -> float:
    """Kernel B over the work its inputs need: ``iterations`` lane-iterations
    (each lane's post-stack frames plus its emitted symbols) of
    ``iteration_ops`` operations each, reading the joint's hoisted
    projection, ``frame_bytes`` a frame, of ``frames`` frames and the
    weights, ``weight_bytes``, once a launch (the model's
    ``decode_costs``)."""
    ops = iterations * iteration_ops
    nbytes = launches * weight_bytes + frames * frame_bytes
    return least(ops, nbytes, prec)


def kernel_e(calls: Iterable[Tuple[int, int, int, bool, str]]) -> float:
    """Kernel E, a bf16 product with f32 sums: per call (M, K, N, bias?,
    out dtype): A (M, K) and W (K, N) bf16 read once, the f32 bias, the
    output (M, N) at its dtype; 2 M K N operations at the bf16 peak."""
    total = 0.0
    for M, K, N, bias, out in calls:
        ops = 2.0 * M * K * N
        nbytes = 2 * (M * K + K * N) + (4 * N if bias else 0) + M * N * ITEM[out]
        total += least(ops, nbytes, "bf16")
    return total
