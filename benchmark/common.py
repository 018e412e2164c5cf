"""What the drivers share: a cell's files and model, the record of one run
that the metric readers read, and the set-up of a cell's weights."""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import models

ROOT = Path(__file__).resolve().parent  # benchmark/
REPO = ROOT.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files: the
    configuration (its "file"), the traffic mix (traffic/<traffic>.json),
    the cell's own entry (cells/<name>.json: the replayed emission model
    and the limits of the correctness check) and the model module the
    configuration's "model" names (models/<model>.py)."""

    name: str
    chips: int
    config: dict
    traffic: dict
    entry: dict
    spec: dict
    repo: Path
    model: ModuleType

    @classmethod
    def load(cls, name: str, repo: Path = REPO) -> "Cell":
        spec = json.loads((repo / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
        bench = repo / "benchmark"
        config = json.loads((repo / cfg["file"]).read_text())
        if "model" not in config:
            raise ValueError(f"configuration {cfg['file']} has no \"model\" key: it names "
                             "the model module benchmark/models/<model>.py")
        return cls(name=name, chips=int(w["chips"]), config=config,
                   traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
                   entry=json.loads((bench / "cells" / f"{name}.json").read_text()),
                   spec=spec, repo=repo, model=models.load(config["model"], repo))

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


@dataclass
class Run:
    """What one run leaves for the result line and the metric readers."""

    cell: Cell
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    trace: Optional[object] = None  # benchmark.trace.Trace of the traced window
    # traced window: kernel calls by kernel (shapes), launches by the
    # program's counters, the phase seconds of each traced rep, the work
    # served (feature frames, post-stack frames, symbols), host seconds of
    # wrapped calls
    calls: Dict[str, list] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    phases: List[Dict[str, float]] = field(default_factory=list)
    work: Dict[str, float] = field(default_factory=dict)
    host_s: Dict[str, List[float]] = field(default_factory=dict)
    # Server: latency ms of each query whose life lies outside the profiled
    # span (every query of an untraced run)
    latency_ms: List[float] = field(default_factory=list)
    # the sample the reference judges
    check_wavs: List[np.ndarray] = field(default_factory=list)
    check_tokens: List[np.ndarray] = field(default_factory=list)
    weights: Optional[dict] = None  # the float32 weights both sides were given


def cell_program(cell: Cell, device, max_symbols_per_step: int):
    """(the float32 weights with the cell's emission model, and the
    program's served weights, params and featurizer config made from them:
    ``cell.model.program``)."""
    m = cell.model
    w = m.apply_emission(m.random_weights(cell.config, device), cell.entry["emission"],
                         cell.config)
    return (w,) + tuple(m.program(cell.config, w, device, max_symbols_per_step))


def cell_weights(cell: Cell, device):
    """(the float32 weights with the cell's emission model, the program's
    served weights made from them) at a cap of one symbol a frame."""
    return cell_program(cell, device, 1)[:2]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
