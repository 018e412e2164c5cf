"""Data-parallel scaling of the int8 Offline runners over the visible cards,
and the int8 greedy decode under tensor parallelism.

    python -m rnnt_inference_tpu_torch.tools.mesh_scaling --cards 1 2 4
    python -m rnnt_inference_tpu_torch.tools.mesh_scaling --runner bucketed --cards 1 2 4
    python -m rnnt_inference_tpu_torch.tools.mesh_scaling --tp 1x2 1x4 2x2

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

``--tp DxK ...`` (``measure_tp``): the same int8 model decodes one seeded
batch (``TP_CELL``: 16 utterances of 1-4 s, log-mel on the first card) on
one card (models/decoder.py greedy_decode: kernels A and B) and on each
mesh of D data shards x K model ranks over the first D K cards
(parallel/tensor.py greedy_decode_tp with impl="reference": the plain
rank steps, exchanging through PyTorch's copies between devices; tensor
parallelism has no kernel), the meshes timed in
turns as above (host clock around the decode, ended by a synchronize).
Prints one JSON object: per mesh the median wall, the slow-down against
the one card, every rep's wall and whether res and res_idx equal the one
card's (exit code 1 if not).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

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


# the tensor-parallel cell: utterances, their longest seconds, timed reps per mesh
TP_CELL = dict(n=16, max_seconds=4.0, reps=3)


def _mesh_shape(name: str):
    d, k = (int(v) for v in name.split("x"))
    return d, k


def measure_tp(meshes=("1x2", "1x4", "2x2"), device: str = "cuda", hidden: int = 1024,
               **cell) -> dict:
    """The tensor-parallel report (module docstring) over meshes named
    "DxK"; ``cell`` overrides ``TP_CELL``; on the CPU each mesh lists the
    CPU D K times."""
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode
    from rnnt_inference_tpu_torch.ops.features import log_mel_features
    from rnnt_inference_tpu_torch.parallel.mesh import weight_shardings
    from rnnt_inference_tpu_torch.parallel.tensor import greedy_decode_tp

    cell = dict(TP_CELL, **cell)
    cuda = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    card = lambda i: torch.device("cuda", i) if cuda else torch.device("cpu")
    def sync():  # every card: a mesh's ranks run on several
        for i in range(torch.cuda.device_count() if cuda else 0):
            torch.cuda.synchronize(i)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines() \
        if cuda else ["cpu"]
    # token buffers no utterance fills: every emission is compared
    params = dataclasses.replace(probe_params(hidden), max_res_len=8192)
    weights = probe_weights(params, card(0))
    store = SampleStore.synthetic(n=cell["n"], seed=0, min_seconds=1.0,
                                  max_seconds=cell["max_seconds"],
                                  mean_seconds=cell["max_seconds"] / 2)
    wav = np.zeros((len(store), int(store.lengths.max())), np.float32)
    for i, smp in enumerate(store.samples):
        wav[i, : len(smp)] = smp
    feats, flens = log_mel_features(torch.from_numpy(wav).to(card(0)),
                                    torch.from_numpy(store.lengths).to(card(0)))
    runs = {"1x1": {"fn": lambda: greedy_decode(weights, feats, flens, params)}}
    for name in meshes:
        d, k = _mesh_shape(name)
        mesh = make_mesh(devices=[card(i) for i in range(d * k)], model_parallel=k)
        wr = weight_shardings(mesh, weights, tensor_parallel=True)
        runs[name] = {"fn": lambda mesh=mesh, wr=wr: greedy_decode_tp(mesh, wr, feats, flens,
                                                                      params,
                                                                      impl="reference")}
    for run in runs.values():
        run["out"] = [t.cpu() for t in run["fn"]()]  # one-off costs, untimed
        sync()
        run["walls"] = []
    order = list(runs)
    for i in range(cell["reps"]):
        for name in (order if i % 2 == 0 else order[::-1]):
            sync()
            t0 = time.perf_counter()
            runs[name]["fn"]()
            sync()
            runs[name]["walls"].append(time.perf_counter() - t0)
    base = runs["1x1"]
    one = float(np.median(base["walls"]))
    out = {"card": smi[0], "cards_visible": torch.cuda.device_count() if cuda else 0,
           "params": f"trans_hidden_size={params.trans_hidden_size}", "utterances": len(store),
           "audio_seconds": store.audio_seconds, "reps": cell["reps"],
           "tokens": int(base["out"][1].sum()), "longest": int(base["out"][1].max()),
           "max_res_len": params.max_res_len, "meshes": {}}
    for name, run in runs.items():
        med = float(np.median(run["walls"]))
        out["meshes"][name] = {
            "median_wall_seconds": med, "slowdown_vs_one_card": med / one,
            "rep_walls": run["walls"],
            "tokens_equal_one_card": all(torch.equal(a, b) for a, b in zip(run["out"],
                                                                           base["out"]))}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("mesh_scaling")
    p.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--runner", choices=tuple(CELLS), default="packed")
    p.add_argument("--tp", nargs="+", metavar="DxK", default=None,
                   help="tensor-parallel meshes instead (e.g. 1x2 1x4 2x2)")
    args = p.parse_args(argv)
    need = max(args.cards) if args.tp is None else max(d * k for d, k in map(_mesh_shape, args.tp))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"mesh_scaling: needs {need} CUDA devices", file=sys.stderr)
        return 2
    if args.tp is not None:
        out = measure_tp(args.tp)
        print(json.dumps(out))
        return 0 if all(m["tokens_equal_one_card"] for m in out["meshes"].values()) else 1
    out = measure(args.cards, args.runner)
    print(json.dumps(out))
    return 0 if all(m["tokens_equal_first_mesh"] for m in out["meshes"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
