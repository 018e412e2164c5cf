"""Kernel C: the float (f32 / bf16) LSTM recurrence in CUDA C++
(csrc/lstm_scan.cu).

Replaces rnnt_inference_tpu/ops/lstm_pallas.py::_lstm_scan_kernel.
``lstm_recurrence_cuda`` launches it on PyTorch's current stream: one
cooperative launch per call, all T steps inside, H / U blocks that each
keep U hidden units' W_hh columns in shared memory (``plan``,
``recurrent_weight``).  bf16 calls of more than PASS_LANES lanes (the
packed runner's) run the cluster loop: the blocks in clusters of
``plan``'s cluster size, each chunk of h_{t-1} loaded once per cluster and
multicast to its blocks; f32 calls and bf16 calls of one pass run the
cp.async pass engine (at N = 16 the cluster loop took 7.3 us a step
on an H100 against its 5.6).  Every launch is counted in
``lstm_recurrence_cuda.launches``, and each launch of the cluster loop by
its cluster size in ``lstm_recurrence_cuda.cluster_launches``.  Its plain
twin is ops/lstm.py lstm_recurrence; ops/lstm.py lstm_layer chooses
between them by device.

The kernel serves one card's whole grid.  Tensor parallelism (a mesh's
"model" axis, parallel/tensor.py) has no kernel: it runs the plain rank
steps of ops/lstm.py (``lstm_layer_tp``), on the card only with
impl="reference".
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from rnnt_inference_tpu_torch.ops import cuda_build

NAME = "lstm_scan"
U = 8  # hidden units per block the kernel is built for


CLUSTER_SIZES = (4, 2)  # tried in order; 1 where the card holds neither
PASS_LANES = 128  # lanes of a bf16 pass: calls of more run the cluster loop
MAX_SLOTS = 16  # csrc/lstm_scan.cu: the cluster loop's ring slots, at most


def cluster_smem(H: int, N: int, slots: int) -> int:
    """Shared bytes of the bf16 cluster loop's block (csrc/lstm_scan.cu
    cluster_smem): alignment slack, ``slots`` ring slots of 64 or 128 lane
    rows x 128 bytes, W_hh's columns, c, the mbarriers."""
    box_rows = 128 if N > 64 else 64
    return 1024 + slots * box_rows * 128 + H * 4 * U * 2 + N * U * 4 + (2 * MAX_SLOTS + 3) * 8


def plan(H: int, N: int, dtype: torch.dtype, sms: int,
         clusters: Optional[Callable[[int], int]] = None) -> Tuple[int, int, int]:
    """(U, least shared bytes per block, cluster size) for H hidden units and
    N lanes on a card with ``sms`` SMs: H / U blocks, one to an SM (the
    kernel's staging ring then takes the rest of shared memory).  bf16 calls
    of more than PASS_LANES lanes run the cluster loop in clusters of the
    largest size in CLUSTER_SIZES of which the card holds all H / U / size
    at once, ``clusters(size)`` being how many it holds
    (cudaOccupancyMaxActiveClusters at the kernel's shared memory), else in
    clusters of 1; the other calls run the pass engine, cluster size 0.
    Raises ValueError for a shape the kernel cannot take."""
    if H <= 0 or H % 128:
        raise ValueError(f"kernel C needs H a multiple of 128, got H={H}")
    if H // U > sms:
        raise ValueError(f"kernel C: H={H} needs {H // U} blocks, the card has {sms} SMs")
    cluster_loop = dtype == torch.bfloat16 and N > PASS_LANES
    if cluster_loop:
        smem = cluster_smem(H, N, 2)
    else:
        smem = (H * 4 * U * dtype.itemsize + cuda_build.ring_min_bytes(dtype)
                + -(-N * U // 4) * 16)
    if smem > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(
            f"kernel C: N={N} lanes at H={H} need {smem} bytes of shared memory "
            f"per block, more than {cuda_build.SMEM_PER_BLOCK}"
        )
    cs = 0
    if cluster_loop:
        cs = next((c for c in CLUSTER_SIZES
                   if clusters is not None and clusters(c) >= H // U // c), 1)
    return U, smem, cs


def recurrent_weight(layer, U: int, kmajor: bool = False) -> torch.Tensor:
    """W_hh {H, 4H} of an LSTMLayerWeights in the kernel's per-block order
    (cuda_build.block_columns: {H / U, H, 4U}, in bf16 in mma fragment
    order, for the pass engine; with ``kmajor``, {H / U, 4U, H}, the rows
    TMA brings to the cluster loop's wgmma), kept until the layer is freed
    and made again if W_hh changes."""
    return cuda_build.cached_operands(
        layer, f"{NAME}/U{U}{'/kmajor' if kmajor else ''}", (layer.w_hh,),
        lambda: cuda_build.block_columns(layer.w_hh, U, kmajor=kmajor))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(NAME)
    if lib.rnnt_lstm_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lstm_scan.argtypes = [i, i, i] + [p] * 7 + [i] * 3 + [p]
        lib.rnnt_lstm_scan.restype = ctypes.c_int
        lib.rnnt_lstm_scan_clusters.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.rnnt_lstm_scan_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_clusters(device: torch.device, cs: int, N: int, H: int) -> int:
    """How many clusters of ``cs`` blocks of the bf16 loop for N lanes and
    H units the card holds at once (cudaOccupancyMaxActiveClusters)."""
    lib, out = _lib(), ctypes.c_int(0)
    with torch.cuda.device(device):
        cuda_build.check(lib, lib.rnnt_lstm_scan_clusters(cs, N, H, ctypes.byref(out)),
                         "lstm_scan occupancy")
    return out.value


def _count_launch(cs: int) -> None:
    # the cluster loop's launches go to the dict itself, not through the
    # function's name, for which a recorder may stand in
    lstm_recurrence_cuda.launches += 1
    if cs:
        CLUSTER_LAUNCHES[cs] = CLUSTER_LAUNCHES.get(cs, 0) + 1


def lstm_recurrence_cuda(
    layer, xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence of one float LSTM layer on the card, given
    xw = x @ W_ih + b {T, N, 4H} in the compute dtype (the layer's).
    h0 {N, H} compute dtype, c0 {N, H} f32.  Returns (y {T,N,H}, hT, cT f32).
    A refused cooperative launch raises."""
    dt = layer.w_hh.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel C takes bf16 or f32 weights, got {dt}")
    T, N, G = xw.shape
    H = layer.w_hh.shape[0]
    if G != 4 * H:
        raise ValueError(f"kernel C needs xw (T, N, 4H), got {tuple(xw.shape)} for H={H}")
    xw, h0, c0 = xw.contiguous(), h0.contiguous(), c0.contiguous()
    cuda_build.require(xw, "xw", dt, (T, N, 4 * H))
    cuda_build.require(h0, "h0", dt, (N, H))
    cuda_build.require(c0, "c0", torch.float32, (N, H))
    if h0.data_ptr() % 16:
        raise ValueError("kernel C copies h0 rows in 16-byte pieces: align it")
    dev = xw.device
    y = torch.empty((T, N, H), dtype=dt, device=dev)
    if T == 0 or N == 0:
        return y, h0.clone(), c0.clone()
    _, _, cs = plan(H, N, dt, cuda_build.sm_count(dev),
                    lambda c: max_clusters(dev, c, N, H))
    w_op = recurrent_weight(layer, U, kmajor=cs > 0)
    cuda_build.require(w_op, "w_hh operand", dt, w_op.shape)
    if w_op.device != dev:
        raise ValueError(f"kernel C: W_hh on {w_op.device}, xw on {dev}")
    lib = _lib()
    with torch.cuda.device(dev):  # the C side launches on the current device
        hT = torch.empty((N, H), dtype=dt, device=dev)
        cT = torch.empty((N, H), dtype=torch.float32, device=dev)
        err = lib.rnnt_lstm_scan(
            int(dt == torch.bfloat16), U, cs, xw.data_ptr(), w_op.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, N, H,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, err, "lstm_scan kernel")
    _count_launch(cs)
    return y, hT, cT


CLUSTER_LAUNCHES: Dict[int, int] = {}  # cluster size -> launches of the cluster loop
lstm_recurrence_cuda.launches = 0
lstm_recurrence_cuda.cluster_launches = CLUSTER_LAUNCHES

