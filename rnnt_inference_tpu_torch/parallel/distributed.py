"""Multi-process initialization and process-sharded Offline serving
(counterpart of rnnt_inference_tpu/parallel/distributed.py).

One process per host (or per card), each serving its own length-striped
share of the sample set: Offline needs no communication while it serves,
so the only collective is the merge of the processes' reports at the end.
``torch.distributed`` carries it, over NCCL on the card or gloo on the CPU
(NCCL refuses two ranks on one GPU; gloo takes them).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from rnnt_inference_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join a process group of ``num_processes`` at ``coordinator_address``
    ("host:port" or "tcp://host:port") as rank ``process_id``; a no-op for
    one process.  backend: "nccl" by default when CUDA is available, else
    "gloo"; a caller may ask for "gloo" on the card."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need coordinator_address and process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id)


def shutdown() -> None:
    """Leave the process group: a barrier, so that no rank tears its
    connections down while another still uses them, then
    destroy_process_group; a no-op without a group.  A process that exits
    with its gloo group still alive can abort in the group's destructor
    ("terminate called without an active exception") after its work is
    done."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard_indices(n_samples: int, lengths: np.ndarray) -> np.ndarray:
    """This process's sample indices: the set sorted by descending length
    and striped over the processes (order[rank::world]), so every process
    gets long and short utterances alike."""
    order = np.argsort(-np.asarray(lengths))
    return order[process_index()::process_count()]


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """This process's devices of the kind its caller asks for: "cuda" takes
    the visible CUDA devices striped over the processes (device i to rank i
    mod world; with more ranks than cards, rank r takes card r mod count)
    and raises when no CUDA device is visible; "cpu" is the CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"device kind {kind!r}: 'cuda' or 'cpu'")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: ask for 'cpu' to serve on the CPU")
    rank, world = process_index(), process_count()
    mine = [torch.device("cuda", i) for i in range(n) if i % world == rank]
    return mine or [torch.device("cuda", rank % n)]


def local_data_mesh(kind: str = "cuda") -> Mesh:
    """A ("data", "model") mesh over this process's local devices of
    ``kind`` (``local_devices``)."""
    return make_mesh(devices=local_devices(kind))


def all_gather_floats(values) -> np.ndarray:
    """Every process's float64 vector, stacked in rank order (one
    all_gather, on the card under NCCL); this process's alone when no
    process group is initialized."""
    mine = np.asarray(values, np.float64).reshape(-1)
    if not dist.is_initialized():
        return mine[None]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(mine).to(dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_hosts_report(local: dict) -> dict:
    """Merge the processes' throughput reports: one all_gather of
    [audio_seconds_per_second, samples] (float64), summed, and ``hosts``.
    Returns ``local`` unchanged when no process group is initialized."""
    if not dist.is_initialized():
        return local
    vals = all_gather_floats([local.get("audio_seconds_per_second", 0.0),
                              local.get("samples", 0)])
    merged = dict(local)
    merged["audio_seconds_per_second"] = float(np.sum(vals[:, 0]))
    merged["samples"] = int(np.sum(vals[:, 1]))
    merged["hosts"] = int(vals.shape[0])
    return merged
