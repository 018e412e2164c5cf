"""Device mesh, data-parallel sharding and the tensor-parallel weight split
(counterpart of rnnt_inference_tpu/parallel/mesh.py).

A ``Mesh`` is an array of ``torch.device`` shaped (data, model) with axis
names ("data", "model"), as the JAX mesh: ``make_mesh(model_parallel=k)``
lays n devices out data-major, device i at (i // k, i % k), as JAX's
``reshape(n // k, k)``.

Data parallelism: utterance batches shard over "data": each data device
(column 0 of the mesh, ``data_devices``) runs the whole model on a
contiguous slice of the lanes (slots), the runners enqueue every shard's
kernel launches before they read any shard's finish mask
(runtime/offline.py ``lockstep``), and the results join in lane order.
Weights replicate: one copy per distinct device, shared by every shard on
that device, so those shards also share its kernel-operand registry
(ops/cuda_build.py ``cached_operands``).  The Offline runners and the
Server take only the data axis and never split over "model" (as the JAX
runners, which replicate over it: runtime/offline.py, runtime/packing.py).

Tensor parallelism (``weight_shardings(..., tensor_parallel=True)``, run by
parallel/tensor.py): the weights of every (data, model) rank.  The port
splits the LSTMs **by hidden unit**, not by contiguous gate columns: rank r
of k takes units [r H/k, (r+1) H/k) with all four gates i, f, g, o of each
(``split_units``), and the matching slice of the folded bias, so every
cell update stays inside its rank (the plain rank steps of
parallel/tensor.py compute whole units).  GSPMD's split of the gate-major
columns (``P(None, "model")`` on (in, 4H)) would put the i and f gates of
a unit on one card and its g and o gates on another.  The two
packages' results are compared, never their shards.  Which leaf goes
where: the five encoder layers (float or int8) and the two prediction
layers by unit; the joint's w1_trans, w1_pred and b1 by joint-hidden
column (``split_columns``); the embedding, the int8 scales, w2 and b2
replicated (JAX splits w2 by row with an all-reduce; the port gathers the
joint's hidden z and every rank computes the full z.W2, so logits and the
argmax do not depend on k); fake-quant weights replicated whole, as JAX's.

A device may appear more than once (two shards or two model ranks on one
card, or ``["cpu"] * 4``): the logic is the same, those ranks then share
the device's stream, and shards of one model rank on one device share one
weight slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rnnt_inference_tpu_torch.models.quant import FakeQuantRNNTWeights
from rnnt_inference_tpu_torch.models.weights import map_tensors, tensor_leaves

AXIS_NAMES = ("data", "model")


class Mesh:
    """An array of devices shaped (data, model)."""

    def __init__(self, devices: np.ndarray, axis_names=AXIS_NAMES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """One device per data shard, in shard order (model rank 0's)."""
        return list(self.devices[:, 0])

    def model_devices(self, shard: int) -> List[torch.device]:
        """The devices of data shard ``shard``'s model ranks, in rank order."""
        return list(self.devices[shard])

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
    """A (n // k, k) ("data", "model") mesh, k = model_parallel, over
    ``devices`` (every visible CUDA device by default; a device may be
    listed more than once) cut to the first ``n_devices``, data-major:
    device i at (i // k, i % k).  n not divisible by k raises."""
    devs = [torch.device(d) for d in (devices if devices is not None else _visible_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    k = model_parallel
    if k < 1 or len(devs) % k:
        raise ValueError(f"{len(devs)} devices are not divisible by model_parallel={k}")
    arr = np.empty((len(devs) // k, k), dtype=object)
    for i, d in enumerate(devs):
        arr[i // k, i % k] = d
    return Mesh(arr)


def _cat(parts: Sequence, axis: int):
    return (torch.cat(list(parts), dim=axis) if isinstance(parts[0], torch.Tensor)
            else np.concatenate(parts, axis=axis))


def _contiguous(a):
    return a.contiguous() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)


def split_units(w, k: int) -> list:
    """Gate columns (..., 4H) (gate g of unit j at column g H + j; a folded
    bias (4H,) too), numpy or tensor, cut into k rank slices (..., 4H/k):
    slice r holds units [r H/k, (r+1) H/k), all four gates of each, in the
    same gate-major order.  H not divisible by k raises."""
    *lead, G = w.shape
    if G % 4 or (G // 4) % k:
        raise ValueError(f"{G // 4} hidden units do not split over {k} model ranks")
    v = w.reshape(*lead, 4, k, G // 4 // k)
    return [_contiguous(v[..., r, :].reshape(*lead, G // k)) for r in range(k)]


def join_units(slices: Sequence):
    """The (..., 4H) gate columns back from ``split_units``' slices."""
    *lead, Gl = slices[0].shape
    return _cat([s.reshape(*lead, 4, 1, Gl // 4) for s in slices], -2).reshape(
        *lead, Gl * len(slices))


def split_columns(w, k: int) -> list:
    """(..., J) cut into k contiguous column slices (..., J/k), numpy or
    tensor; J not divisible by k raises."""
    J = w.shape[-1]
    if J % k:
        raise ValueError(f"{J} columns do not split over {k} model ranks")
    return [_contiguous(w[..., r * (J // k):(r + 1) * (J // k)]) for r in range(k)]


def join_columns(slices: Sequence):
    """The (..., J) columns back from ``split_columns``' slices."""
    return _cat(list(slices), -1)


def rank_weights(weights, r: int, k: int):
    """Model rank r of k's weights (module docstring): the same type, its
    LSTM layers cut by unit, the joint's first layer by column, the rest
    replicated.  ``weights`` itself for k = 1 and for fake-quant weights."""
    if k == 1 or isinstance(weights, FakeQuantRNNTWeights):
        return weights
    layer = lambda l: dataclasses.replace(
        l, **{f: split_units(getattr(l, f), k)[r] for f in ("w_ih", "w_hh", "b")})
    jw = weights.joint
    return dataclasses.replace(
        weights,
        pre_rnn=[layer(l) for l in weights.pre_rnn],
        post_rnn=[layer(l) for l in weights.post_rnn],
        pred_rnn=[layer(l) for l in weights.pred_rnn],
        joint=dataclasses.replace(jw, **{f: split_columns(getattr(jw, f), k)[r]
                                         for f in ("w1_trans", "w1_pred", "b1")}),
    )


def weight_shardings(mesh: Mesh, weights, tensor_parallel: bool = False) -> list:
    """The weights each data shard runs: one replica per distinct device
    (``weights`` itself where it already lives there), the same object for
    shards on the same device.  tensor_parallel=True: the weights of every
    (data, model) rank, ``[shard][rank]``, each on its device
    (``rank_weights``; one object per (device, rank), shared by the shards
    whose rank r is on that device)."""
    home = tensor_leaves(weights)[0].device
    if tensor_parallel:
        k = mesh.shape["model"]
        by_rank: Dict[tuple, object] = {}
        out = []
        for s in range(mesh.shape["data"]):
            row = []
            for r, d in enumerate(mesh.model_devices(s)):
                if (d, r) not in by_rank:
                    w = rank_weights(weights, r, k)
                    by_rank[d, r] = w if d == home else map_tensors(w, lambda t: t.to(d))
                row.append(by_rank[d, r])
            out.append(row)
        return out
    by_dev = {home: weights}
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
