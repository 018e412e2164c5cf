"""A copy of the benchmark's data files with small cells beside them, for the
CPU tests: the model at the golden bundle's small widths (H 64, P 32, J 32)
and traffic of a few short utterances, run by the harness on the program's
plain twins."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the files a checkout's cells are found from: data, metric readers, and the
# model modules with their references
DATA = ("configs", "traffic", "cells", "metrics", "models", "reference")

SIZES = dict(trans_input_size=240, trans_hidden_size=64, pre_num_layers=2, post_num_layers=3,
             stack_time_factor=2, pred_hidden_size=32, pred_num_layers=2, joint_hidden_size=32,
             num_labels=29, max_res_len=128)
DURATION = dict(law="gamma", shape=4.0, mean_s=1.6, min_s=0.6, max_s=3.0, sizes_seed=5)
OFFLINE = dict(kind="offline", utterances=12, duration=DURATION, wav_buckets_s=[1.0, 2.0, 3.0],
               lanes=4, chunk_frames=16, decode_chunk=32, max_symbols_per_step=1, trace_reps=1,
               check_utterances=6)
SERVER = dict(kind="server", utterances=8, duration=DURATION, qps=12.0, arrivals_seed=6,
              slots=4, split_len=24,
              insert_batch=2, steps_per_dispatch=2, pipeline_depth=4, response_size=2,
              qos_len=240001, max_symbols_per_step=1, warm_s=0.3, grace_s=30.0,
              trace_from_s=0.3, trace_dispatches=3, check_queries=6)
# the blank model at 0.80-0.83 symbols a frame for each tiny configuration's
# weights (benchmark/calibrate_emission.py on 16 utterances)
EMISSION = {"tiny_int8": dict(model="blank", amp=1.0, delta=-0.046387),
            "tiny_bf16": dict(model="blank", amp=1.0, delta=0.267578)}


def tiny_config(precision: dict, seed: int) -> dict:
    real = json.loads((REPO / "benchmark" / "configs" / "rnnt_mlperf_int8.json").read_text())
    cfg = dict(real, name=f"tiny_{precision['encoder']}", **SIZES, precision=precision,
               weight_seed=seed)
    if precision["encoder"] != "int8":
        cfg.pop("calibration_audio")
    return cfg


def make_repo(root: Path, limit: float = 0.5) -> Path:
    """``root`` laid out as a checkout: BENCHMARK.json with the tiny cells
    tiny.int8.offline, tiny.bf16.offline and tiny.int8.server, and the
    benchmark's data files."""
    for d in DATA:
        shutil.copytree(REPO / "benchmark" / d, root / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    for prec, seed in ((dict(encoder="int8", prediction="bf16", joint="bf16"), 14),
                       (dict(encoder="bf16", prediction="bf16", joint="bf16"), 12)):
        cfg = tiny_config(prec, seed)
        (b / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(name=cfg["name"], source="https://example.org/tiny",
                                    file=f"benchmark/configs/{cfg['name']}.json", reduced=[],
                                    why="small widths for the CPU tests"))
    (b / "traffic" / "tiny_offline.json").write_text(json.dumps(OFFLINE))
    (b / "traffic" / "tiny_server.json").write_text(json.dumps(SERVER))
    cells = [("tiny.int8.offline", "tiny_int8", "tiny_offline"),
             ("tiny.bf16.offline", "tiny_bf16", "tiny_offline"),
             ("tiny.int8.server", "tiny_int8", "tiny_server")]
    for name, cfg, traffic in cells:
        spec["workloads"].append(dict(name=name, config=cfg, traffic=traffic, chips=1,
                                      why="CPU test"))
        (b / "cells" / f"{name}.json").write_text(json.dumps(
            dict(emission=EMISSION[cfg], limits=dict(mean_logit_gap=limit))))
    names = [c[0] for c in cells]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "server" if m["name"].startswith(("server", "latency")) else "offline"
            m["workloads"] += [n for n in names if kind in n]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
