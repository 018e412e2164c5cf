"""The port's utils/golden.py against tests/golden/golden.npz, on the CPU:
compute_golden from the bundle's f32 weights and calibration batch
(jax.random, seeds 21 and 22, carried over as numpy arrays), every mode
after them computed by the port.

Tolerance: f32, fake_quant and quant token for token; packed 7 of 8, the
miss utterance 5, the measured near-tie of ROADMAP.md section 3 (the port's
own featurizer; tests/test_torch_packing.py). The bundle is never written.
"""

import hashlib
import os

import jax
import numpy as np
import pytest

from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.utils import golden as jgolden
from rnnt_inference_tpu_torch.models.weights import weights_from_numpy_leaves
from rnnt_inference_tpu_torch.utils import golden as tgolden

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden.npz")


def _digest():
    with open(GOLDEN, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest(), os.path.getmtime(GOLDEN)


@pytest.fixture(scope="module")
def recomputed():
    import torch

    torch.set_num_threads(1)
    before = _digest()
    jw = jinit_weights(jax.random.PRNGKey(jgolden.SEED_WEIGHTS), jgolden._small_params())
    w32 = weights_from_numpy_leaves([np.asarray(a) for a in jax.tree.flatten(jw)[0]],
                                    "rnnt_weights", tgolden.small_params(), "cpu")
    xc = np.asarray(jax.random.normal(jax.random.PRNGKey(jgolden.SEED_WEIGHTS + 1),
                                      (16, 4, 240)))
    out = tgolden.compute_golden(w32, xc, device="cpu")
    assert _digest() == before  # golden.npz is never written
    return out


def test_constants_and_loader_match_jax():
    jp = jgolden._small_params()
    tp = tgolden.small_params()
    assert {k: getattr(tp, k) for k in tp.__dataclass_fields__} == \
        {k: getattr(jp, k) for k in tp.__dataclass_fields__}
    assert (tgolden.SEED_WEIGHTS, tgolden.SEED_STORE, tgolden.N_SAMPLES) == \
        (jgolden.SEED_WEIGHTS, jgolden.SEED_STORE, jgolden.N_SAMPLES)
    got, want = tgolden.load_golden(GOLDEN), jgolden.load_golden(GOLDEN)
    assert sorted(got) == sorted(want) == ["f32", "fake_quant", "packed", "quant"]
    for mode in want:
        assert len(got[mode]) == len(want[mode]) == tgolden.N_SAMPLES
        for a, b in zip(got[mode], want[mode]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["f32", "fake_quant", "quant"])
def test_modes_match_golden_token_for_token(recomputed, mode):
    want = tgolden.load_golden(GOLDEN)[mode]
    assert len(recomputed[mode]) == len(want) == tgolden.N_SAMPLES
    for i, (g, w) in enumerate(zip(recomputed[mode], want)):
        assert np.array_equal(g, w), (mode, i, g.tolist(), w.tolist())
    assert sum(len(g) for g in recomputed[mode]) > 0


def test_packed_mode_misses_only_the_near_tie(recomputed):
    want = tgolden.load_golden(GOLDEN)["packed"]
    same = [np.array_equal(g, w) for g, w in zip(recomputed["packed"], want)]
    assert len(same) == tgolden.N_SAMPLES
    assert [i for i, s in enumerate(same) if not s] == [5]
