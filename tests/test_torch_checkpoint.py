"""The port's rnnt.pt importer (models/weights.py weights_from_torch_state_dict
and load_torch_checkpoint) against the JAX package's, on synthetic state
dicts in the zenodo layout at the golden bundle's small width (H=64, P=32,
J=32): raw zenodo keys and migrated keys, bare and under a "state_dict"
entry, with featurizer buffers that must be ignored.

Tolerance: every leaf bit-equal to JAX's (same dtype, shape and bytes).
"""

import jax
import numpy as np
import pytest
import torch

from rnnt_inference_tpu.config import RNNTParams as JParams
from rnnt_inference_tpu.models import weights as jweights
from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models import weights as tweights

DIMS = dict(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
            joint_hidden_size=32, max_res_len=128)
JP, TP = JParams(**DIMS), RNNTParams(**DIMS)


def _zenodo_state_dict(p, seed=0, migrated=False):
    """Random tensors under the zenodo checkpoint's keys (or the migrated
    names the reference's models/utils.py gives them)."""
    rng = np.random.RandomState(seed)
    r = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32))
    sd = {}

    def lstm(prefix, layers, ic, h):
        for l in range(layers):
            sd[f"{prefix}.weight_ih_l{l}"] = r(4 * h, ic)
            sd[f"{prefix}.weight_hh_l{l}"] = r(4 * h, h)
            sd[f"{prefix}.bias_ih_l{l}"] = r(4 * h)
            sd[f"{prefix}.bias_hh_l{l}"] = r(4 * h)
            ic = h

    H, P, J = p.trans_hidden_size, p.pred_hidden_size, p.joint_hidden_size
    names = (("transcription.pre_rnn", "transcription.post_rnn", "prediction.pred_rnn")
             if migrated else
             ("encoder.pre_rnn.lstm", "encoder.post_rnn.lstm", "prediction.dec_rnn.lstm"))
    lstm(names[0], p.pre_num_layers, p.trans_input_size, H)
    lstm(names[1], p.post_num_layers, H * p.stack_time_factor, H)
    lstm(names[2], p.pred_num_layers, P, P)
    sd["prediction.embed.weight"] = r(p.num_labels - 1, P)
    if migrated:
        sd["joint.linear1_trans.weight"] = r(J, H)
        sd["joint.linear1_trans.bias"] = r(J)
        sd["joint.linear1_pred.weight"] = r(J, P)
        sd["joint.linear1_pred.bias"] = r(J)
        sd["joint.linear2.weight"] = r(p.num_labels, J)
        sd["joint.linear2.bias"] = r(p.num_labels)
    else:
        sd["joint_net.0.weight"] = r(J, H + P)
        sd["joint_net.0.bias"] = r(J)
        sd["joint_net.3.weight"] = r(p.num_labels, J)
        sd["joint_net.3.bias"] = r(p.num_labels)
    sd["audio_preprocessor.featurizer.fb"] = torch.zeros(1)  # ignored
    sd["audio_preprocessor.featurizer.window"] = torch.zeros(1)
    return sd


def _assert_bit_equal(tw, jw):
    got = tweights.numpy_leaves(tw)
    want = [np.asarray(a) for a in jax.tree.flatten(jw)[0]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "state_dict"])
@pytest.mark.parametrize("migrated", [False, True], ids=["zenodo_keys", "migrated_keys"])
def test_state_dict_import_is_bit_equal_to_jax(migrated, wrapped):
    sd = _zenodo_state_dict(TP, seed=3, migrated=migrated)
    ckpt = {"state_dict": sd, "epoch": 100} if wrapped else sd
    tw = tweights.weights_from_torch_state_dict(ckpt, TP, device="cpu")
    _assert_bit_equal(tw, jweights.weights_from_torch_state_dict(ckpt, JP))
    assert tuple(tw.pre_rnn[0].w_ih.shape) == (240, 4 * TP.trans_hidden_size)
    if not migrated:  # the fc1 split: zero trans bias, pred bias the old bias
        w = sd["joint_net.0.weight"].numpy()
        assert torch.equal(tw.joint.w1_trans, torch.from_numpy(w[:, :64].T.copy()))
        assert torch.equal(tw.joint.w1_pred, torch.from_numpy(w[:, 64:].T.copy()))
        assert torch.equal(tw.joint.b1, sd["joint_net.0.bias"])


def test_torch_save_round_trip(tmp_path):
    """torch.save of a wrapped zenodo state dict with a non-tensor entry,
    then load_torch_checkpoint in either package: the same leaves, bit for
    bit."""
    path = str(tmp_path / "rnnt.pt")
    torch.save({"state_dict": _zenodo_state_dict(TP, seed=4), "config": {"labels": "abc"}},
               path)
    tw = tweights.load_torch_checkpoint(path, TP, device="cpu")
    _assert_bit_equal(tw, jweights.load_torch_checkpoint(path, JP))
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in tweights.tensor_leaves(tw))


def test_state_dict_from_weights_round_trips():
    """torch_state_dict_from_weights writes the zenodo layout that both
    importers read back to the same values."""
    w = tweights.init_weights(TP, torch.Generator().manual_seed(5), device="cpu")
    sd = tweights.torch_state_dict_from_weights(w)
    assert "joint_net.0.weight" in sd and "prediction.dec_rnn.lstm.bias_hh_l1" in sd
    back = tweights.weights_from_torch_state_dict(sd, TP, device="cpu")
    jback = jweights.weights_from_torch_state_dict(sd, JP)
    for a, b, c in zip(tweights.tensor_leaves(w), tweights.tensor_leaves(back),
                       jax.tree.flatten(jback)[0]):
        assert torch.equal(a, b) and np.array_equal(b.numpy(), np.asarray(c))
