"""Multi-process weak-scaling probe (counterpart of
scripts/multihost_probe.py): N processes form one torch.distributed group,
stripe the sample set by length over the processes
(parallel/distributed.py ``host_shard_indices``), each runs a real int8
Offline serve of its share, and the processes' reports are merged
(``all_hosts_report``).

Processes on one machine share its cores (and, on one card, its SMs), so
raw throughput per process means little; the printed efficiency is the
load balance, mean(process wall) / max(process wall), the term that bounds
weak scaling of this workload, which needs no communication while it
serves.

  # a rank per card over NCCL, RNNTParams() (the MLPerf widths):
  python -m rnnt_inference_tpu_torch.tools.multihost_probe --procs 2 --n 64
  # two ranks on one GPU (NCCL refuses that; gloo does not):
  python -m rnnt_inference_tpu_torch.tools.multihost_probe --procs 2 --n 64 \\
      --backend gloo --quant_in rnnt_quant.npz
  # on the CPU, a probe-sized model:
  python -m rnnt_inference_tpu_torch.tools.multihost_probe --procs 2 --n 32 \\
      --device cpu --hidden 64

``--hidden`` other than 1024 serves a probe-sized model (prediction and
joint width 32, CPU only: kernel B takes widths that are multiples of
64).  ``--out_dir D`` writes each rank's indices and tokens to
D/rank<r>/.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_params(hidden: int):
    from rnnt_inference_tpu_torch.config import RNNTParams

    if hidden == 1024:
        return RNNTParams()
    return RNNTParams(trans_input_size=240, trans_hidden_size=hidden, pred_hidden_size=32,
                      joint_hidden_size=32, max_res_len=128)


def probe_store(n: int):
    """Every process builds the same seeded store and serves its share."""
    from rnnt_inference_tpu_torch.data.dataset import SampleStore

    return SampleStore.synthetic(n=n, seed=11, min_seconds=0.5, max_seconds=3.0,
                                 mean_seconds=1.5)


def probe_weights(params, device, quant_in=None):
    """int8 weights: ``quant_in`` (a quantized npz), or seeded float weights
    calibrated on four seeded feature rows and quantized."""
    from rnnt_inference_tpu_torch.models import checkpoint
    from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
    from rnnt_inference_tpu_torch.models.weights import init_weights

    if quant_in:
        return checkpoint.load_quant_weights(quant_in, params, device)
    w = init_weights(params, torch.Generator().manual_seed(0), device=device)
    x = torch.randn((16, 4, params.trans_input_size),
                    generator=torch.Generator().manual_seed(1)).to(device)
    calib = calibrate(w, [(x, torch.full((4,), 16, device=device))], params)
    return quantize_weights(w, calib, params)


def worker(args) -> int:
    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.parallel import distributed
    from rnnt_inference_tpu_torch.runtime.harness import run_offline

    distributed.initialize(args.coord, args.procs, args.rank, args.backend)
    dev = distributed.local_devices()[0] if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.procs))
    params = probe_params(args.hidden)
    store = probe_store(args.n)
    mine = np.sort(distributed.host_shard_indices(args.n, store.lengths))
    out_dir = os.path.join(args.out_dir, f"rank{args.rank}") if args.out_dir else None
    rep = run_offline(probe_weights(params, dev, args.quant_in), store.select(mine), params,
                      FeaturizerConfig(), batch_size=args.batch, warmup=True,
                      min_duration_s=args.min_s, device=dev, output_dir=out_dir)
    if out_dir:
        with open(os.path.join(out_dir, "indices.json"), "w") as f:
            json.dump(mine.tolist(), f)
    local = dict(audio_seconds_per_second=rep.audio_seconds_per_second, samples=rep.samples,
                 wall_seconds=rep.wall_seconds, launches=rep.launches,
                 indices=mine.tolist(), device=str(dev), backend=args.backend)
    print("RANK " + json.dumps(local), flush=True)
    merged = distributed.all_hosts_report(local)
    walls = distributed.all_gather_floats([rep.wall_seconds])[:, 0]
    if args.rank == 0:
        merged.pop("indices")
        merged["per_host_wall_seconds"] = [float(v) for v in walls]
        merged["load_balance_efficiency"] = float(np.mean(walls) / np.max(walls))
        print("PROBE " + json.dumps(merged), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def run_cluster(procs: int, n: int, batch: int = 8, hidden: int = 1024, device: str = "cuda",
                backend: Optional[str] = None, quant_in=None, out_dir=None, min_s: float = 2.0,
                timeout: float = 900.0) -> dict:
    """Spawn ``procs`` worker processes on this machine, wait for all of
    them, and return rank 0's merged report with every rank's own report
    under "ranks".  ``backend`` defaults to nccl on the card and gloo on
    the CPU.  A failed or timed-out worker raises, after every worker has
    been stopped."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "rnnt_inference_tpu_torch.tools.multihost_probe", "--worker",
           "--coord", f"127.0.0.1:{port}", "--procs", str(procs), "--n", str(n), "--batch",
           str(batch), "--hidden", str(hidden), "--device", device, "--backend", backend,
           "--min_s", str(min_s)]
    cmd += ["--quant_in", quant_in] if quant_in else []
    cmd += ["--out_dir", out_dir] if out_dir else []
    workers = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, cwd=REPO,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
               for r in range(procs)]
    report, ranks = None, {}
    try:
        for r, p in enumerate(workers):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"worker {r} failed (rc {p.returncode}):\n{out}\n{err}")
            for line in out.splitlines():
                if line.startswith("PROBE "):
                    report = json.loads(line[len("PROBE "):])
                elif line.startswith("RANK "):
                    ranks[r] = json.loads(line[len("RANK "):])
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
                p.wait()
    if report is None:
        raise RuntimeError("no PROBE report from rank 0")
    report["ranks"] = [ranks[r] for r in range(procs)]
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multihost_probe")
    p.add_argument("--procs", type=int, default=2, help="processes (simulated hosts)")
    p.add_argument("--n", type=int, default=32, help="total samples")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hidden", type=int, default=1024,
                   help="encoder width (1024: the MLPerf widths; other: probe-sized, CPU only)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default nccl on the card, gloo on the CPU; "
                        "NCCL refuses two ranks on one GPU)")
    p.add_argument("--quant_in", default=None, help="int8 weights npz (default: seeded)")
    p.add_argument("--out_dir", default=None, help="write each rank's tokens here")
    p.add_argument("--min_s", type=float, default=2.0, help="timed reps per rank, seconds")
    p.add_argument("--timeout", type=float, default=900.0, help="per worker, seconds")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--coord", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multihost_probe: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    report = run_cluster(args.procs, args.n, args.batch, args.hidden, args.device, args.backend,
                         args.quant_in, args.out_dir, args.min_s, args.timeout)
    report["procs"] = args.procs
    print(json.dumps(report))
    eff = report["load_balance_efficiency"]
    print(f"load-balance efficiency over {args.procs} processes: {eff:.1%}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
