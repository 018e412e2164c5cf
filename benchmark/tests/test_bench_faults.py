"""Whole runs of the small cells on the CPU, past the harness's look for a
card: a sound run comes out correct; the control (the reference one
precision step down in the program's place) and runs with the timed path
broken underneath come out not correct.  The faults a one-card inference
cell can have: a step that returns its state unchanged, half of the answers
left out, a token altered where it is produced.  (No cell spans cards, so
no exchange between cards can be left out.)

The small cells' limit of the mean logit gap, 1e-5, lies between the
program's readings there (0.0 on every seed tried: the plain twins compute
what the reference does) and the control's (3.8e-5 to 1.6e-3 over three
seeds of each cell)."""

import time

import numpy as np
import pytest

import tiny
from benchmark import harness
from benchmark.common import Cell

CELLS = ["tiny.int8.offline", "tiny.bf16.offline", "tiny.int8.server"]
LIMIT = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_repo(tmp_path_factory.mktemp("tiny"), limit=LIMIT)


def _run(root, name, control=False):
    cell = Cell.load(name, root)
    return harness.run_cell(cell, "cpu", 2 ** 31 + 21, 0.6, False, time.perf_counter(),
                            control=control)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(root, name):
    r = _run(root, name, control=True)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["mean_logit_gap"]["value"] <= LIMIT
    assert r["control"]["mean_logit_gap"] > LIMIT
    assert list(r)[-1] == "checks"


def _alter(tokens, i):
    t = np.array(tokens, copy=True)
    if len(t):
        t[len(t) // 2] = (t[len(t) // 2] + 1) % 28
    return t


def _faulty_answers(monkeypatch, how):
    """Break the answers where the program produces them: the packed
    runner's harvest and the Server's extract."""
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner

    harvest, extract = PackedOfflineRunner.harvest, ServerRunner.extract

    def bad_harvest(self, res, res_idx):
        return [how(t, i) for i, t in enumerate(harvest(self, res, res_idx))]

    def bad_extract(self, slots):
        return [(q, how(t, q)) for q, t in extract(self, slots)]

    monkeypatch.setattr(PackedOfflineRunner, "harvest", bad_harvest)
    monkeypatch.setattr(ServerRunner, "extract", bad_extract)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "token_altered"])
def test_a_broken_timed_path_is_not_correct(root, name, fault, monkeypatch):
    if fault == "state_unchanged":
        from rnnt_inference_tpu_torch.models import rnnt as model

        transcription = model.transcription

        def stateless(weights, x, x_lens, state, *args, **kw):
            f, _ = transcription(weights, x, x_lens, state, *args, **kw)
            return f, state

        monkeypatch.setattr(model, "transcription", stateless)
    elif fault == "half_left_out":
        _faulty_answers(monkeypatch, lambda t, i: t if i % 2 == 0 else t[:0])
    else:
        _faulty_answers(monkeypatch, _alter)
    r = _run(root, name)
    assert r["correct"] is False
    assert r["checks"]["mean_logit_gap"]["value"] > LIMIT
