"""Device mesh and data-parallel sharding (counterpart of
rnnt_inference_tpu/parallel/mesh.py).

A ``Mesh`` is an array of ``torch.device`` shaped (data, model) with axis
names ("data", "model"), as the JAX mesh.  Utterance batches shard over
"data": each data device runs the whole model on a contiguous slice of the
lanes (slots), the runners enqueue every shard's kernel launches before they
read any shard's finish mask (runtime/offline.py ``lockstep``), and the
results join in lane order.  Weights replicate: one copy per distinct
device, shared by every shard on that device, so those shards also share
its kernel-operand registry (ops/cuda_build.py ``cached_operands``).

A device may appear more than once (two shards on one card, or
``["cpu", "cpu"]``): the sharding logic is the same, the shards then share
the device's stream.  Tensor parallelism (gate columns split across cards)
is not ported: it is queued as ROADMAP item 2.8.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rnnt_inference_tpu_torch.models.weights import tensor_leaves

AXIS_NAMES = ("data", "model")
TP_QUEUED = ("tensor parallelism is not ported: splitting kernels A, B and C over gate "
             "columns across cards is queued as ROADMAP item 2.8")


class Mesh:
    """An array of devices shaped (data, model)."""

    def __init__(self, devices: np.ndarray, axis_names=AXIS_NAMES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """One device per data shard, in shard order."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _visible_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: pass devices= (e.g. ['cpu', 'cpu'])")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (every visible CUDA device
    by default; a device may be listed more than once), cut to the
    first ``n_devices``.  model_parallel > 1 raises NotImplementedError."""
    if model_parallel != 1:
        raise NotImplementedError(f"model_parallel={model_parallel}: {TP_QUEUED}")
    devs = [torch.device(d) for d in (devices if devices is not None else _visible_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    arr = np.empty((len(devs), 1), dtype=object)
    for i, d in enumerate(devs):
        arr[i, 0] = d
    return Mesh(arr)


def weight_shardings(mesh: Mesh, weights, tensor_parallel: bool = False) -> list:
    """The weights each data shard runs: one replica per distinct device
    (``weights`` itself where it already lives there), the same object for
    shards on the same device.  tensor_parallel=True raises
    NotImplementedError."""
    if tensor_parallel:
        raise NotImplementedError(TP_QUEUED)
    by_dev = {tensor_leaves(weights)[0].device: weights}
    for d in mesh.data_devices:
        if d not in by_dev:
            by_dev[d] = weights.to(d)
    return [by_dev[d] for d in mesh.data_devices]


def lane_bounds(mesh: Mesh, n: int) -> List[tuple]:
    """(lo, hi) of each data shard's contiguous slice of n lanes (the first
    n % dp shards one lane longer, as torch.tensor_split cuts)."""
    dp = mesh.shape["data"]
    q, r = divmod(n, dp)
    out, lo = [], 0
    for s in range(dp):
        hi = lo + q + (s < r)
        out.append((lo, hi))
        lo = hi
    return out


def shard(mesh: Mesh, x: torch.Tensor, axis: int) -> List[torch.Tensor]:
    """x cut along ``axis`` into the data shards' contiguous slices, each on
    its shard's device."""
    return [x.narrow(axis, lo, hi - lo).to(d)
            for (lo, hi), d in zip(lane_bounds(mesh, x.shape[axis]), mesh.data_devices)]


def join(shards: Sequence[torch.Tensor], axis: int, device) -> torch.Tensor:
    """The shards joined along ``axis`` in shard order, on ``device``."""
    return torch.cat([s.to(device) for s in shards], dim=axis)


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Features {T, N, C}: the batch axis cut over "data"."""
    return shard(mesh, x, 1)


def lens_sharding(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Per-lane vectors and {N, ...} matrices: axis 0 cut over "data"."""
    return shard(mesh, x, 0)


def replicated(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """x on every data shard's device (one copy per distinct device)."""
    by_dev = {x.device: x}
    return [by_dev.setdefault(d, x.to(d)) for d in mesh.data_devices]


def _slot_axis(t: torch.Tensor) -> int:
    """The slot axis of a server-state leaf: 0 for per-slot vectors and
    matrices ((N,), (N, R)), 1 for layer-stacked and time-major tensors
    ((L, N, H), (T, N, C)) (runtime/server.py's state layout)."""
    return 1 if t.dim() >= 3 else 0


def server_state_sharding(mesh: Mesh, state) -> list:
    """A ServerState (and its nested DecodeState and EncoderState) cut along
    the slot axis into one state per data shard, each on its device."""
    if isinstance(state, torch.Tensor):
        return shard(mesh, state, _slot_axis(state))
    parts = {f.name: server_state_sharding(mesh, getattr(state, f.name))
             for f in dataclasses.fields(state)}
    return [dataclasses.replace(state, **{k: v[s] for k, v in parts.items()})
            for s in range(mesh.shape["data"])]


def join_server_state(shards: Sequence, device):
    """The per-shard states of ``server_state_sharding`` joined in slot
    order on ``device``."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        return join(shards, _slot_axis(first), device)
    return dataclasses.replace(first, **{
        f.name: join_server_state([getattr(s, f.name) for s in shards], device)
        for f in dataclasses.fields(first)})
