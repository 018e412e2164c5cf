"""A small Conformer-Transducer cell beside the tiny RNN-T cells
(tiny.make_repo): the NeMo configuration at d_model 64, 2 heads, 2 blocks,
conv kernel 7, P = J = 64, 40 labels, on tiny.OFFLINE's traffic at cap 10,
run by the harness on the program's plain twins."""

from __future__ import annotations

import json
from pathlib import Path

import tiny

SIZES = dict(d_model=64, num_blocks=2, n_heads=2, conv_kernel_size=7, conv_channels=16,
             pred_hidden_size=64, joint_hidden_size=64, num_labels=40, max_res_len=128)
CELL = "tiny.conformer.offline"
# the blank model at 0.16 symbols an encoder frame for these weights
# (benchmark/calibrate_emission.py's calibrate, target 0.16, 64 utterances)
EMISSION = dict(model="blank", amp=1.0, delta=0.530762)


def add_cell(root: Path, limit: float = 0.5) -> str:
    """The tiny Conformer's configuration, traffic and cell in the checkout
    ``root`` (made by tiny.make_repo), with its BENCHMARK.json entries: the
    cell appended wherever the accepted Conformer cell is listed."""
    b = root / "benchmark"
    real = json.loads((b / "configs" / "nemo_conformer_transducer_large.json").read_text())
    cfg = dict(real, name="tiny_conformer", **SIZES, weight_seed=21)
    (b / "configs" / "tiny_conformer.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny_offline_cap10.json").write_text(
        json.dumps(dict(tiny.OFFLINE, max_symbols_per_step=10)))
    (b / "cells" / f"{CELL}.json").write_text(json.dumps(
        dict(emission=EMISSION, limits=dict(mean_logit_gap=limit))))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_conformer", source="https://example.org/tiny",
                                file="benchmark/configs/tiny_conformer.json", reduced=[],
                                why="small widths for the CPU tests"))
    spec["workloads"].append(dict(name=CELL, config="tiny_conformer",
                                  traffic="tiny_offline_cap10", chips=1, why="CPU test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "conformer.offline.speech" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return CELL
