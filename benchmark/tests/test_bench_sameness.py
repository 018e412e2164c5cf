"""Moving what depends on the architecture into its model module
(benchmark/models/rnnt.py) changed no reading: the same seed gives
bit-equal weights, program objects and check numbers, and every metric
reader reads a hand-made Run as before.

The digests and values below were computed on the CPU, at one intra-op
thread, with the harness of commit 7352eee (benchmark/weights.py,
common.cell_weights, check.gaps and the readers before the model module
existed), by the same code as here."""

import dataclasses
import hashlib
import time

import pytest
import torch

import tiny
from benchmark import harness, roofline
from benchmark.common import REPO, Cell, Run, cell_weights
from benchmark.trace import SPAN, Trace

SEED = 2 ** 31 + 21

# sha256 (first 16 hex digits) of the tiny configurations' raw weights,
# the weights with the cell's emission model, and the program's served
# weights made from them
WEIGHTS = {
    "tiny.int8.offline": dict(random="c25f34b91d2a7fd5", emission="5e509f741489ed89",
                              program="5af7c47af1aa6a83"),
    "tiny.bf16.offline": dict(random="1fcf9d761f8e6fda", emission="c02af30167b2a199",
                              program="49a41e9bdd1bf26c"),
}
# run_cell(..., SEED, 0.6 s, control=True): the program's mean logit gap, the
# control's, the digest of the control's gaps, answers the control changed
CHECKS = {
    "tiny.int8.offline": (0.0, 0.00031403452157974243, "005adf7d6abc6b4f", 5),
    "tiny.bf16.offline": (0.0, 0.001453101634979248, "51b3e8cc25f2036d", 6),
    "tiny.int8.server": (0.0, 0.0003885279099146525, "c59b48023ceb3708", 4),
}
# each reader of a cell's per-layer metrics on ``hand_made_run``
READINGS = {
    "int8.offline.speech": {
        "offline.features_ms": 205.00000000000003, "offline.encoder_ms": 965.0,
        "offline.decode_ms": 355.0, "kernel_a.roofline": 2.739967767155129,
        "kernel_b.roofline": 82.67842264914054, "offline.mfu": 122.97342742380772,
        "offline.idle_share": 38.60759493670886, "offline.host_tail_ms": 2.6},
    "bf16.offline.speech": {
        "offline.features_ms": 205.00000000000003, "offline.encoder_ms": 965.0,
        "offline.decode_ms": 355.0, "kernel_b.roofline": 82.67842264914054,
        "kernel_c.roofline": 1.0422569777957533, "offline.mfu": 231.48460303848665,
        "offline.idle_share": 38.60759493670886, "offline.host_tail_ms": 2.6},
    "int8.server.poisson": {
        "server.latency_p99_ms": 297.01, "server.dispatch_host_ms": 5.5,
        "server.insert_host_ms": 4.0, "server.idle_share": 38.60759493670886,
        "server.in_slot_ms": None, "server.readback_wait_ms": None, "server.respond_ms": None,
        "server.extract_host_ms": None},
}


def digest(obj) -> str:
    """sha256 of every tensor's dtype, shape and bytes, and every other leaf's
    repr, in field, key (sorted) and list order."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            t = o.detach().cpu().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(o.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                h.update(f.name.encode())
                walk(getattr(o, f.name))
        elif isinstance(o, dict):
            for k in sorted(o):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for v in o:
                walk(v)
            h.update(b"]")
        else:
            h.update(repr(o).encode())

    walk(obj)
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_repo(tmp_path_factory.mktemp("tiny"), limit=1e-5)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_and_program_objects_are_bit_equal_to_the_parents(root, name, one_thread):
    cell = Cell.load(name, root)
    w, served = cell_weights(cell, "cpu")
    got = dict(random=digest(cell.model.random_weights(cell.config, "cpu")), emission=digest(w),
               program=digest(served))
    assert got == WEIGHTS[name]


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_check_numbers_are_bit_equal_to_the_parents(root, name, one_thread):
    r = harness.run_cell(Cell.load(name, root), "cpu", SEED, 0.6, False, time.perf_counter(),
                         control=True)
    c = r["control"]
    got = (r["checks"]["mean_logit_gap"]["value"], c["mean_logit_gap"],
           digest([float(g) for g in c["gaps"]]), c["tokens_differing"])
    assert got == CHECKS[name]


def hand_made_run(cell):
    ev = lambda name, cat, ts, dur: {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    events = [ev(SPAN, "user_annotation", 1000, 40000), ev(SPAN, "user_annotation", 41000, 39000),
              ev("void quant_lstm<false>(...)", "kernel", 1500, 9000),
              ev("void quant_lstm<true>(...)", "kernel", 11000, 3000),
              ev("void decode_loop<bf16, 4, true>(...)", "kernel", 15000, 12000),
              ev("void lstm_scan<bf16, 8>(...)", "kernel", 42000, 20000),
              ev("void projection<true>(...)", "kernel", 63000, 4000),
              ev("void projection<false>(...)", "kernel", 68000, 500),
              ev("Memcpy DtoH", "gpu_memcpy", 70000, 300),
              ev("rnnt.offline.readback", "user_annotation", 71000, 200),
              ev("rnnt.offline.harvest", "user_annotation", 71200, 5000),
              ev("aten::mm", "cpu_op", 30000, 8000)]
    calls = {"kernel_a": [(16, 1024, 240, 1024, False), (16, 1024, 1024, 1024, False),
                          (8, 1024, 2048, 1024, True)],
             "kernel_c": [(16, 1024, 1024, "bf16"), (8, 1024, 1024, "bf16")],
             "kernel_e": [(16384, 240, 4096, True, "bf16"), (8192, 1024, 512, False, "f32")]}
    launches = {"quant_lstm_layer": 3, "lstm_recurrence": 2, "decode_step": 9, "projection": 2}
    phases = [{"features": 0.2, "encoder": 0.97, "decode": 0.35},
              {"features": 0.21, "encoder": 0.96, "decode": 0.36}]
    work = dict(frames=3.0e6, post_frames=1.5e6, symbols=1.2e6)
    host_s = {"dispatch": [0.005, 0.006], "insert": [0.004]}
    return Run(cell=cell, trace=Trace.of(events), calls=calls, launches=launches, phases=phases,
               work=work, host_s=host_s, latency_ms=[float(x) for x in range(100, 300)])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_every_reader_reads_a_hand_made_run_as_before(name, monkeypatch):
    from rnnt_inference_tpu_torch.utils.profiler import REGISTRY

    monkeypatch.setattr(REGISTRY, "server", None)
    monkeypatch.setattr(REGISTRY, "spans", {})
    cell = Cell.load(name, REPO)
    run = hand_made_run(cell)
    got = {m["name"]: harness.reader(cell, m["name"])(run) for m in cell.per_layer()}
    want = dict(READINGS[name])
    if name == "bf16.offline.speech":
        # new: kernel E's two calls over its 4.5 ms in the window
        want["kernel_e.roofline"] = 100.0 * roofline.kernel_e(run.calls["kernel_e"]) / 4.5e-3
        assert want["kernel_e.roofline"] == pytest.approx(
            100.0 * (144064512 / 3.35e12 + 34603008 / 3.35e12) / 4.5e-3)
    assert got == want
