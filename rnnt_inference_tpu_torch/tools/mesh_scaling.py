"""Data-parallel scaling of the int8 Offline runners over the visible cards.

    python -m rnnt_inference_tpu_torch.tools.mesh_scaling --cards 1 2 4
    python -m rnnt_inference_tpu_torch.tools.mesh_scaling --runner bucketed --cards 1 2 4

One seeded store and one seeded int8 model at the MLPerf widths
(tools/multihost_probe.py ``probe_weights``), sized by ``CELLS``: the
packed runner on 1,024 lanes in all over 2,048 utterances of 1-4 s, or the
bucketed runner at batch 128 over 512 utterances of 1-15 s.  For each mesh
over the first k cards (parallel/mesh.py) the runner is staged, run once
untimed, then timed rep by rep with the meshes taken in turns (1, 2, 4, 4,
2, 1, ...), so drift on the host or the cards falls on every mesh alike.
A rep's time is the runner's wall (dispatch and device work, ended by a
synchronize; the token readback apart).  Prints one JSON object: the card
and its power limit, and per mesh the median rep wall, audio-seconds per
second, the speed-up over the first mesh, every rep's wall, each shard's
launches and whether its tokens equal the first mesh's (exit code 1 if
not).  ``measure`` takes other sizes and the CPU (k copies of it), for
tests.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.parallel.mesh import make_mesh
from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
from rnnt_inference_tpu_torch.tools.multihost_probe import probe_params, probe_weights

# per runner: utterances, their longest seconds, total lanes (the batch
# when bucketed), timed reps per mesh
CELLS = {
    "packed": dict(n=2048, max_seconds=4.0, lanes=1024, reps=4),
    "bucketed": dict(n=512, max_seconds=15.0, lanes=128, reps=3),
}


def measure(cards, runner: str = "packed", device: str = "cuda", hidden: int = 1024,
            **cell) -> dict:
    """The scaling report over meshes of ``cards`` devices (module
    docstring); ``cell`` overrides ``CELLS[runner]``."""
    cell = dict(CELLS[runner], **cell)
    cuda = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    card = lambda i: torch.device("cuda", i) if cuda else torch.device("cpu")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines() \
        if cuda else ["cpu"]
    params, cfg = probe_params(hidden), FeaturizerConfig()
    weights = probe_weights(params, card(0))
    store = SampleStore.synthetic(n=cell["n"], seed=0, min_seconds=1.0,
                                  max_seconds=cell["max_seconds"],
                                  mean_seconds=min(7.8, cell["max_seconds"] / 2))
    qsl = QuerySampleLibrary(store, cfg)
    lanes = cell["lanes"]
    runs = {}
    for k in cards:
        mesh = make_mesh(devices=[card(i) for i in range(k)])
        if runner == "packed":
            r = PackedOfflineRunner(weights, params, cfg, n_lanes=lanes, batch_size=lanes,
                                    mesh=mesh)
            r.stage(qsl)
            rep = r.run_device
        else:
            r = OfflineRunner(weights, params, cfg, batch_size=lanes, mesh=mesh)
            dqsl = qsl.load_to_device(lanes, device=r.device)
            rep = lambda r=r, dqsl=dqsl: r.run_device(dqsl)
        first = rep()  # one-off costs, untimed
        runs[k] = {"rep": rep, "walls": [], "tokens": first.tokens,
                   "shard_launches": first.shard_launches}
    order = list(cards)
    for i in range(cell["reps"]):
        for k in (order if i % 2 == 0 else order[::-1]):
            runs[k]["walls"].append(runs[k]["rep"]().wall_seconds)
    base = cards[0]
    out = {"card": smi[0], "cards_visible": torch.cuda.device_count() if cuda else 0,
           "runner": runner, "params": f"trans_hidden_size={params.trans_hidden_size}",
           "utterances": len(store), "audio_seconds": store.audio_seconds,
           "lanes": lanes, "reps": cell["reps"], "meshes": {}}
    for k, run in runs.items():
        med = float(np.median(run["walls"]))
        equal = len(run["tokens"]) == len(runs[base]["tokens"]) and all(
            np.array_equal(a, b) for a, b in zip(run["tokens"], runs[base]["tokens"]))
        out["meshes"][str(k)] = {
            "median_wall_seconds": med,
            "audio_seconds_per_second": store.audio_seconds / med,
            "speedup": float(np.median(runs[base]["walls"])) / med,
            "rep_walls": run["walls"], "tokens_equal_first_mesh": equal,
            "shard_launches": run["shard_launches"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("mesh_scaling")
    p.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--runner", choices=tuple(CELLS), default="packed")
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(args.cards):
        print(f"mesh_scaling: needs {max(args.cards)} CUDA devices", file=sys.stderr)
        return 2
    out = measure(args.cards, args.runner)
    print(json.dumps(out))
    return 0 if all(m["tokens_equal_first_mesh"] for m in out["meshes"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
