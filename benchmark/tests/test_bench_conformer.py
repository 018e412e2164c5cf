"""The Conformer-Transducer's cell taken by the harness as files: a tiny
configuration of it (conformer_tiny.py) beside the tiny RNN-T cells, run
through run_cell on the CPU on the program's plain twins."""

import time

import tiny
import conformer_tiny
from benchmark import harness
from benchmark.common import Cell


def test_a_tiny_conformer_cell_runs_through_the_harness(tmp_path):
    """Untraced: correct, audio_s_per_s and setup_s reported.  Traced: the
    phase metrics, offline.subsample_ms among them, read on the CPU; the
    kernel rooflines stay silent (no device kernels in a CPU trace)."""
    root = tiny.make_repo(tmp_path)
    cell = Cell.load(conformer_tiny.add_cell(root), root)
    assert cell.model.__file__.endswith("conformer_transducer.py")
    seed = 2 ** 31 + 20
    r = harness.run_cell(cell, "cpu", seed, 0.6, False, time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    # the bf16 twins against the f32 reference: near ties only (a wrong token costs tenths)
    assert r["checks"]["mean_logit_gap"]["value"] < 1e-2
    t = harness.run_cell(cell, "cpu", seed, 0.6, True, time.perf_counter())
    assert t["correct"] is True
    got = set(t["metrics"])
    assert {"offline.features_ms", "offline.encoder_ms", "offline.decode_ms",
            "offline.subsample_ms", "offline.mfu"} <= got
    assert not got & {"kernel_b.roofline", "kernel_e.roofline", "kernel_f.roofline"}
    assert 0 < t["metrics"]["offline.subsample_ms"]["value"]


def test_conformer_decode_costs_count_what_kernel_b_computes():
    """Kernel B's costs at the configuration's widths, by hand: a lane's
    iteration computes h W_hh (P x 4P) and the joint's g W1p (P x J) and z
    W2 (J x V), 2 operations a product term; x W_ih is the eproj table's
    row, so a launch reads W_hh, W1p and W2 in bf16 and the table (V rows
    of 4P) in f32, and a frame J f32 of the hoisted projection."""
    import json

    from benchmark.models import load

    cfg = json.loads((tiny.REPO / "benchmark" / "configs"
                      / "nemo_conformer_transducer_large.json").read_text())
    P, J, V = 640, 640, 1025
    assert (cfg["pred_hidden_size"], cfg["joint_hidden_size"], cfg["num_labels"],
            cfg["pred_num_layers"]) == (P, J, V, 1)
    model = load("conformer_transducer", tiny.REPO)
    it = 2.0 * (P * 4 * P + P * J + J * V)
    assert model.decode_iteration_ops(cfg) == it
    assert model.decode_costs(cfg) == dict(
        iteration_ops=it, weight_bytes=2 * (P * 4 * P + P * J + J * V) + 4 * V * 4 * P,
        frame_bytes=J * 4, precision="bf16")
