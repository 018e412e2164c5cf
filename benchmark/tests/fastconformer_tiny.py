"""A small streaming FastConformer-Transducer cell beside the tiny RNN-T
cells (tiny.make_repo): NeMo's cache-aware streaming configuration at
d_model 64, 2 heads, 2 blocks, 16 subsampling channels, att_context_size
[6, 2] (chunks of 3 encoder frames, 2 before), conv kernel 5, P = J = 64,
40 labels, served by ServerRunner on tiny.SERVER's traffic at cap 10 with
one chunk (24 feature frames) a step (host times over the window's first
second, then the profile), on the program's plain twins."""

from __future__ import annotations

import json
from pathlib import Path

import tiny

SIZES = dict(d_model=64, num_blocks=2, n_heads=2, conv_kernel_size=5,
             subsampling_conv_channels=16, att_context_size=[6, 2], pred_hidden_size=64,
             joint_hidden_size=64, num_labels=40, max_res_len=128)
CELL = "tiny.fastconformer.server"
REAL = "nemo_fastconformer_transducer_large_streaming"
# the blank model at about 0.32 symbols an encoder frame for these weights
# (benchmark/calibrate_emission.py's calibrate, target 0.32, 64 utterances: its amp 1 row)
EMISSION = dict(model="blank", amp=1.0, delta=0.284180)


def config() -> dict:
    real = json.loads((tiny.REPO / "benchmark" / "configs" / f"{REAL}.json").read_text())
    return dict(real, name="tiny_fastconformer", **SIZES, weight_seed=23)


def add_cell(root: Path, limit: float = 0.5) -> str:
    """The tiny streaming model's configuration, traffic and cell in the
    checkout ``root`` (made by tiny.make_repo), with its BENCHMARK.json
    entries: the cell appended wherever the accepted streaming cell is
    listed."""
    b = root / "benchmark"
    (b / "configs" / "tiny_fastconformer.json").write_text(json.dumps(config()))
    (b / "traffic" / "tiny_server_stream.json").write_text(
        json.dumps(dict(tiny.SERVER, max_symbols_per_step=10, steps_per_dispatch=1,
                        trace_from_s=1.0)))
    (b / "cells" / f"{CELL}.json").write_text(json.dumps(
        dict(emission=EMISSION, limits=dict(mean_logit_gap=limit))))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_fastconformer", source="https://example.org/tiny",
                                file="benchmark/configs/tiny_fastconformer.json", reduced=[],
                                why="small widths for the CPU tests"))
    spec["workloads"].append(dict(name=CELL, config="tiny_fastconformer",
                                  traffic="tiny_server_stream", chips=1, why="CPU test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "fastconformer.server.poisson" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return CELL
