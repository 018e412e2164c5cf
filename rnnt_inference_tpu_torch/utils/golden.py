"""The golden bundle's modes recomputed by the port (counterpart of
rnnt_inference_tpu/utils/golden.py).

tests/golden/golden.npz pins the greedy-decode tokens of a small model on
eight synthetic utterances under every numeric mode:

  f32         plain float pipeline
  fake_quant  fake-quantized weights (rounding isolated from the kernels)
  quant       real int8 encoder execution
  packed      quant weights through the sequence-packed Offline runner

The bundle's f32 weights and its calibration batch come from jax.random
(seed 21 and 22), which the port does not reproduce: the caller passes them
in, as numpy arrays bridged by models/weights.py.  Everything after them
(calibration, quantization, features, decodes, packing) is the port's.  The
port never writes the bundle: only the JAX package's
scripts/make_golden.py does, after an intended semantic change.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams

# the bundle's seeds and size (rnnt_inference_tpu/utils/golden.py)
SEED_WEIGHTS = 21
SEED_STORE = 11
N_SAMPLES = 8


def small_params() -> RNNTParams:
    """The bundle's model: H=64, P=32, J=32, max_res_len 128.  Its P and J
    are below kernel B's least width (64), so on the card the bundle runs
    with impl="reference"."""
    return RNNTParams(trans_input_size=240, trans_hidden_size=64, pred_hidden_size=32,
                      joint_hidden_size=32, max_res_len=128)


def golden_store():
    from rnnt_inference_tpu_torch.data.dataset import SampleStore

    return SampleStore.synthetic(n=N_SAMPLES, seed=SEED_STORE, min_seconds=0.4,
                                 max_seconds=2.0, mean_seconds=1.0)


def compute_golden(
    w32,
    calib_x: np.ndarray,
    params: Optional[RNNTParams] = None,
    device="cuda",
    impl: Optional[str] = None,
) -> Dict[str, List[np.ndarray]]:
    """{mode: [tokens per sample]} of the four modes.  w32: the bundle's f32
    RNNTWeights; calib_x: its calibration features {16, 4, 240} (all 16
    frames valid).  Each utterance is featurized and decoded alone, as the
    bundle was made; packed serves the store on 3 lanes, 16-frame chunks,
    batch 4, wav buckets of 1 s and 2 s."""
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode
    from rnnt_inference_tpu_torch.models.quant import (
        calibrate,
        fake_quantize_weights,
        quantize_weights,
    )
    from rnnt_inference_tpu_torch.ops.features import log_mel_features
    from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
    from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

    params = params or small_params()
    dev = torch.device(device)
    cfg = FeaturizerConfig()
    store = golden_store()
    w32 = w32.to(dev)
    xc = torch.tensor(np.asarray(calib_x, np.float32), device=dev)
    calib = calibrate(w32, [(xc, torch.full((xc.shape[1],), xc.shape[0], device=dev))], params)
    wq = quantize_weights(w32, calib, params)
    wfq = fake_quantize_weights(w32, calib, params)

    def decode_all(weights) -> List[np.ndarray]:
        toks = []
        with torch.inference_mode():
            for s in store.samples:
                wav = torch.from_numpy(s[None, :]).to(dev)
                feats, flens = log_mel_features(
                    wav, torch.tensor([s.shape[0]], dtype=torch.int32, device=dev), cfg)
                res, rlens = greedy_decode(weights, feats, flens, params, impl=impl)
                toks.append(res[0, : int(rlens[0])].cpu().numpy().astype(np.int32))
        return toks

    out: Dict[str, List[np.ndarray]] = {
        "f32": decode_all(w32), "fake_quant": decode_all(wfq), "quant": decode_all(wq)}
    runner = PackedOfflineRunner(wq, params, cfg, n_lanes=3, chunk_frames=16, batch_size=4,
                                 device=dev, impl=impl)
    runner.stage(QuerySampleLibrary(store, cfg, wav_buckets_s=(1.0, 2.0)))
    out["packed"] = [t.astype(np.int32) for t in runner.run_device().tokens]
    return out


def load_golden(path: str) -> Dict[str, List[np.ndarray]]:
    """{mode: [tokens per sample]} from a bundle (keys ``{mode}_{i:02d}``)."""
    out: Dict[str, List[np.ndarray]] = {}
    with np.load(path) as data:
        for key in sorted(data.files):
            mode, _, _ = key.rpartition("_")
            out.setdefault(mode, []).append(data[key])
    return out
