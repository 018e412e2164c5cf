"""Model artifacts: save/load weights, calibration state and quantized
models (counterpart of rnnt_inference_tpu/models/checkpoint.py).

The container is the JAX package's, key for key: arrays a0..a{n-1} in
``jax.tree.flatten`` order (dataclass field order, the order
models/weights.py tensor_leaves walks) and __meta__ (json: kind, n, dtypes),
bf16 stored as its uint16 bit pattern.  So a file written by either package
loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models.quant import CalibState, QuantRNNTWeights
from rnnt_inference_tpu_torch.models.weights import (
    RNNTWeights,
    numpy_leaves,
    read_npz,
    tensor_leaves,
    weights_from_numpy_leaves,
)

_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.int8: "int8",
}


def save_pytree(path: str, obj, kind: str) -> None:
    dtypes = [_DTYPE_NAMES[t.dtype] for t in tensor_leaves(obj)]
    meta = {"kind": kind, "n": len(dtypes), "dtypes": dtypes}
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"a{i}": a for i, a in enumerate(numpy_leaves(obj))},
    )


def _read(path: str, kind: str):
    meta, leaves = read_npz(path)
    if meta["kind"] != kind:
        raise ValueError(f"{path} holds {meta['kind']!r}, not {kind!r}")
    return leaves


def save_weights(path: str, weights: RNNTWeights) -> None:
    save_pytree(path, weights, "rnnt_weights")


def load_weights(path: str, params: RNNTParams = RNNTParams(), device="cuda") -> RNNTWeights:
    return weights_from_numpy_leaves(_read(path, "rnnt_weights"), "rnnt_weights", params, device)


def save_calib(path: str, calib: CalibState) -> None:
    save_pytree(path, calib, "rnnt_calib")


def load_calib(path: str, device="cuda") -> CalibState:
    pre, post = _read(path, "rnnt_calib")
    return CalibState(pre_amax=torch.from_numpy(pre).to(device),
                      post_amax=torch.from_numpy(post).to(device))


def save_quant_weights(path: str, qweights: QuantRNNTWeights) -> None:
    save_pytree(path, qweights, "rnnt_quant_weights")


def load_quant_weights(
    path: str, params: RNNTParams = RNNTParams(), device="cuda"
) -> QuantRNNTWeights:
    leaves = _read(path, "rnnt_quant_weights")
    return weights_from_numpy_leaves(leaves, "rnnt_quant_weights", params, device)
