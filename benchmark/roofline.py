"""The yardstick of the rooflines and of mfu: the card's published peaks and
the operations and bytes each kernel's calls, and the model, need.

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
KERNEL_NAME = {"kernel_a": "quant_lstm", "kernel_b": "decode_loop", "kernel_c": "lstm_scan"}


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


def decode_iteration_ops(c: dict) -> float:
    """One decode iteration of one lane: the prediction net's step (every
    layer's x W_ih and h W_hh) and the joint (g W1p, z W2)."""
    P, J, V = c["pred_hidden_size"], c["joint_hidden_size"], c["num_labels"]
    return 2.0 * (c["pred_num_layers"] * 2 * P * 4 * P + P * J + J * V)


def decode_weight_bytes(c: dict, prec: str) -> float:
    P, J, V = c["pred_hidden_size"], c["joint_hidden_size"], c["num_labels"]
    return ITEM[prec] * (c["pred_num_layers"] * 2 * P * 4 * P + (V - 1) * P + P * J + J * V)


def kernel_b(iterations: float, frames: float, launches: int, c: dict, prec: str) -> float:
    """Kernel B over the work its inputs need: ``iterations`` lane-iterations
    (each lane's post-stack frames plus its emitted symbols), reading the
    joint's hoisted projection of ``frames`` frames (f32) and the weights
    once a launch."""
    ops = iterations * decode_iteration_ops(c)
    nbytes = launches * decode_weight_bytes(c, prec) + frames * c["joint_hidden_size"] * 4
    return least(ops, nbytes, prec)


def encoder_ops(c: dict, frames: float, post_frames: float) -> float:
    """The encoder's products over ``frames`` feature frames (the pre layers)
    and ``post_frames`` stacked frames (the post layers)."""
    H = c["trans_hidden_size"]
    pre_in = [c["trans_input_size"]] + [H] * (c["pre_num_layers"] - 1)
    post_in = [H * c["stack_time_factor"]] + [H] * (c["post_num_layers"] - 1)
    return 2.0 * 4 * H * (frames * sum(ic + H for ic in pre_in)
                          + post_frames * sum(ic + H for ic in post_in))


def model_least(c: dict, frames: float, post_frames: float, symbols: float) -> float:
    """The least time of the model's products (encoder, prediction net,
    joint) for utterances of ``frames`` feature frames, ``post_frames``
    stacked frames and ``symbols`` emitted, each at its precision's peak."""
    prec = c["precision"]
    enc = encoder_ops(c, frames, post_frames) / PEAK_OPS[prec["encoder"]]
    fproj = 2.0 * post_frames * c["trans_hidden_size"] * c["joint_hidden_size"]
    dec = ((post_frames + symbols) * decode_iteration_ops(c) + fproj) / PEAK_OPS[prec["joint"]]
    return enc + dec
