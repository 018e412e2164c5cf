"""Find a cell's emission model once, for its file to replay.

    python benchmark/calibrate_emission.py --workload int8.offline.speech [--write]

The cell's file names the model ("blank" or "burst"); this finds its values
on the program's own decode of the encoder output of 64 utterances drawn by
the cell's traffic law (the cell's model's ``emission_probe``), as the
program's bench.py calibrates (``emission.bisect``):
  blank  for w1_trans amp 1, 2, 4 and 8 the bisected blank delta for
         ``target`` symbols per post-stack frame (0.8, as speech); the
         nearest of the four;
  burst  for amp 2, 4, 8 and each kappa of a fine ladder (the best then
         refined) the delta
         bisected for 1.05 ``target`` symbols a frame at the cell's cap, and
         the burst factor, symbols at the cap over symbols at cap 1; of the
         points whose worst utterance stays under min(10, 0.4 cap) symbols a
         frame, the one whose worse relative miss of the two targets (the
         rate, a burst of ``target_burst``) is least.
Prints the values as JSON (and with --write puts them into the cell's file).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import emission, traffic  # noqa: E402
from benchmark.common import REPO, Cell, log  # noqa: E402


def calibrate(cell: Cell, device, n: int = 64, target: float = 0.8,
              target_burst: float = 1.05) -> dict:
    config, tr, model = cell.config, cell.traffic, cell.model
    kind = cell.entry["emission"]["model"]
    cap = tr["max_symbols_per_step"]
    w = model.random_weights(config, device)
    lens = traffic.durations(tr["duration"], n, 0)
    pcm = traffic.speechlike(lens, 1, device)
    wav = torch.zeros((n, int(lens.max())), device=device)
    off = np.concatenate([[0], np.cumsum(lens)])
    for i in range(n):
        wav[i, : lens[i]] = pcm[off[i] : off[i + 1]].float() / 32768.0
    probe = model.emission_probe(config, w, wav, lens, device)
    emitting = lambda **values: model.apply_emission(w, values, config)

    def symbols(wt: dict, at_cap: int):
        r, frames_u = probe(wt, at_cap)
        return r.sum() / frames_u.sum(), float((r / frames_u).max()), r.sum()

    if kind == "blank":
        best = None
        for amp in (1.0, 2.0, 4.0, 8.0):
            delta, r = emission.bisect(
                lambda d, amp=amp: symbols(emitting(model="blank", amp=amp, delta=d), cap)[0],
                target, iters=14)
            log(f"blank: amp {amp:g} delta {delta:.4f} -> {r:.4f} symbols/frame")
            if best is None or abs(r - target) < abs(best[2] - target):
                best = (amp, delta, r)
        amp, delta, r = best
        return dict(model="blank", amp=amp, delta=round(delta, 6), target_symbols_per_frame=target,
                    measured_symbols_per_frame=round(r, 4))

    tail_cap = min(10.0, 0.4 * cap)
    found = []

    def consider(kappa, amp):
        delta, r = emission.bisect(
            lambda d: symbols(emitting(model="burst", amp=amp, delta=d, kappa=kappa), cap)[0],
            rate_target, iters=12)
        wt = emitting(model="burst", amp=amp, delta=delta, kappa=kappa)
        r, tail, s_cap = symbols(wt, cap)
        s_1 = symbols(wt, 1)[2]
        factor = s_cap / max(s_1, 1.0)
        log(f"burst: amp {amp:g} kappa {kappa:g} delta {delta:.4f} -> {r:.4f} symbols/frame, "
            f"burst factor {factor:.4f}, worst utterance {tail:.2f} symbols/frame")
        if tail <= tail_cap:
            miss = max(abs(r / rate_target - 1), abs(factor / target_burst - 1))
            found.append((miss, kappa, amp, delta, r, factor))

    # the rate and the burst factor jump with kappa and delta, so a fine
    # ladder, each point judged by its worse relative miss of the two targets
    rate_target = target * 1.05
    for amp in (2.0, 4.0, 8.0):
        for kappa in np.geomspace(1 / 16, 2, 31):
            consider(float(kappa), amp)
    if not found:
        raise RuntimeError("burst calibration failed at every kappa")
    _, k, amp = min(found)[:3]
    for kappa in k * np.geomspace(2 ** -0.125, 2 ** 0.125, 9):
        consider(float(kappa), amp)
    _, kappa, amp, delta, r, factor = min(found)
    return dict(model="burst", amp=amp, delta=round(delta, 6), kappa=kappa,
                target_symbols_per_frame=round(target * 1.05, 4), target_burst=target_burst,
                measured_symbols_per_frame=round(r, 4), measured_burst=round(factor, 4))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--write", action="store_true", help="put the values into the cell's file")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = Cell.load(args.workload, REPO)
    t = time.perf_counter()
    found = calibrate(cell, torch.device(args.device))
    log(f"{cell.name}: {time.perf_counter() - t:.1f} s")
    print(json.dumps({"workload": cell.name, "emission": found}), flush=True)
    if args.write:
        path = REPO / "benchmark" / "cells" / f"{cell.name}.json"
        entry = json.loads(path.read_text())
        entry["emission"] = found
        path.write_text(json.dumps(entry, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
