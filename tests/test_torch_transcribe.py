"""The port's Transcriber (transcribe.py) against the JAX package's on the
same weights files, on the CPU at the golden bundle's small width: a float
.npz (f32 and bf16), a quantized .npz and a zenodo-layout .pt.

Tolerance: transcripts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.models import checkpoint as jckpt
from rnnt_inference_tpu.models.quant import calibrate as jcalibrate
from rnnt_inference_tpu.models.quant import quantize_weights as jquantize_weights
from rnnt_inference_tpu.models.weights import init_weights as jinit_weights
from rnnt_inference_tpu.transcribe import Transcriber as JTranscriber
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import weights as tweights
from rnnt_inference_tpu_torch.transcribe import Transcriber

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)


def _waves():
    rng = np.random.RandomState(0)
    return [(rng.randn(int(s * 16000)) * 0.1).astype(np.float32) for s in (0.4, 0.7, 0.5, 1.1, 0.3)]


@pytest.fixture(scope="module")
def jweights():
    return jinit_weights(jax.random.PRNGKey(0), JP)


@pytest.mark.parametrize("kind,bf16", [("npz", False), ("npz", True), ("quant", False),
                                       ("pt", False)])
def test_transcriber_matches_jax(tmp_path, jweights, kind, bf16):
    """from_checkpoint on the same file in both packages, batch 2 over five
    utterances: equal transcripts, and transcribe() equals its batch row."""
    if kind == "quant":
        xc = jax.random.normal(jax.random.PRNGKey(1), (16, 4, 240))
        jq = jquantize_weights(jweights, jcalibrate(
            jweights, [(xc, jnp.full((4,), 16, jnp.int32))], JP), JP)
        path = str(tmp_path / "q.npz")
        jckpt.save_quant_weights(path, jq)
    elif kind == "pt":
        path = str(tmp_path / "rnnt.pt")
        tw = tweights.weights_from_numpy_leaves(
            [np.asarray(a) for a in jax.tree.flatten(jweights)[0]], "rnnt_weights", TP, "cpu")
        torch.save({"state_dict": tweights.torch_state_dict_from_weights(tw)}, path)
    else:
        path = str(tmp_path / "w.npz")
        jckpt.save_weights(path, jweights)
    want = JTranscriber.from_checkpoint(path, JP, bf16=bf16, batch_size=2)
    got = Transcriber.from_checkpoint(path, TP, bf16=bf16, batch_size=2, device="cpu")
    waves = _waves()
    texts = got.transcribe_batch(waves)
    assert texts == want.transcribe_batch(waves)
    assert len(texts) == 5 and all(isinstance(t, str) for t in texts)
    assert got.transcribe(waves[1]) == texts[1]
    wdt = got._runner.weights.pre_rnn[0].w_ih.dtype
    assert wdt == {"quant": torch.int8, "npz": torch.bfloat16 if bf16 else torch.float32,
                   "pt": torch.float32}[kind]


def test_transcriber_twins_on_request():
    """impl="reference" is passed to the runner (on the card: the twins)."""
    w = tweights.init_weights(TP, torch.Generator().manual_seed(0), device="cpu")
    t = Transcriber(w, TP, batch_size=2, device="cpu", impl="reference")
    assert t._runner.impl == "reference"
    assert t.transcribe_batch(_waves()[:2]) == Transcriber(w, TP, batch_size=2, device="cpu") \
        .transcribe_batch(_waves()[:2])
