"""Cross-check a calibration artifact against a TensorRT calibration cache
(counterpart of scripts/check_calib.py; same parser, table, tolerance and
exit code).

    python -m rnnt_inference_tpu_torch.tools.check_calib \\
        --cache calibration_result_nv.cache --calib rnnt_calib.npz [--rtol 0.5]

The reference ships NVIDIA's TRT per-tensor amax table as an independent
cross-reference for calibration sanity (format `tensor_name: <big-endian
hex of the f32 scale>`, amax = scale * 127 for MinMax calibration).  This
tool reconstructs the shared cat(x, h) amax the quantizer uses (the max of
the previous layer's output amax and this layer's hidden amax: one scale
across the concatenated input) and compares it with a calibration .npz
written by ``main --calibration`` of either package.

Different calibration corpora give different amaxes, so this is a
sanity/order-of-magnitude gate (default rtol 0.5), not a bit check.  It
reads the amaxes onto the CPU (models/checkpoint.py ``load_calib(path,
device="cpu")``) and runs no kernel, so it needs no card, as the JAX
script forces the CPU.  Exit code 0 when every layer is within rtol, 1
otherwise.
"""

from __future__ import annotations

import argparse
import struct
import sys

from rnnt_inference_tpu_torch.models.checkpoint import load_calib


def parse_trt_cache(path: str) -> dict:
    """Parse `name: hex` lines -> {name: f32 value} (header line skipped)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            name, _, hexval = line.rpartition(":")
            name, hexval = name.strip(), hexval.strip()
            if not name or len(hexval) != 8:
                continue  # header like TRT-8001-MinMaxCalibration
            try:
                (val,) = struct.unpack(">f", bytes.fromhex(hexval))
            except ValueError:
                continue
            out[name] = val
    return out


def expected_shared_amax(cache: dict) -> dict:
    """Per-LSTM-layer shared cat(x, h) amaxes from the TRT per-tensor table:
    in_amax[l] = max(output_amax[l-1], hidden_amax[l]); layer 0's input is
    the feature stream ("input")."""
    scale = lambda k: cache[k] * 127.0
    out = {}
    prev = scale("input")
    for l in range(2):
        key = f"encoder.pre_rnn.lstm{l}"
        out[f"pre_{l}"] = max(prev, scale(f"{key}_hidden"))
        prev = scale(f"{key}_output")
    # the StackTime reshape carries the amax across (encoder_reshape ==
    # pre_rnn lstm1_output in the NV table)
    for l in range(3):
        key = f"encoder.post_rnn.lstm{l}"
        out[f"post_{l}"] = max(prev, scale(f"{key}_hidden"))
        prev = scale(f"{key}_output")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("check_calib")
    p.add_argument("--cache", required=True, help="TRT calibration cache file")
    p.add_argument("--calib", required=True, help="rnnt_calib.npz from main --calibration")
    p.add_argument("--rtol", type=float, default=0.5,
                   help="relative tolerance (corpora differ; sanity gate)")
    args = p.parse_args(argv)

    nv = expected_shared_amax(parse_trt_cache(args.cache))
    calib = load_calib(args.calib, device="cpu")
    ours = {
        **{f"pre_{i}": float(a) for i, a in enumerate(calib.pre_amax)},
        **{f"post_{i}": float(a) for i, a in enumerate(calib.post_amax)},
    }

    bad = 0
    for k in sorted(nv):
        ref, got = nv[k], ours.get(k)
        if got is None:
            print(f"{k}: missing in {args.calib}")
            bad += 1
            continue
        rel = abs(got - ref) / max(abs(ref), 1e-12)
        flag = "" if rel <= args.rtol else "  <-- OUT OF RANGE"
        if rel > args.rtol:
            bad += 1
        print(f"{k}: ours={got:.4f} nv={ref:.4f} rel={rel:.2f}{flag}")
    print("calibration cross-check:", "OK" if bad == 0 else f"{bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
