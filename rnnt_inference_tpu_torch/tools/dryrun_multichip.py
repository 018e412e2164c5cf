"""Multi-device dry run (counterpart of __graft_entry__.py
``dryrun_multichip``): each data-parallel phase on an n-device mesh, held
to the same work on one device.

  python -m rnnt_inference_tpu_torch.tools.dryrun_multichip --n 2
  python -m rnnt_inference_tpu_torch.tools.dryrun_multichip --n 2 --device cpu

Phases, as JAX's: greedy decode at the MLPerf widths (f32) on a dp x
tp = 2 mesh when n is even (dp = n / 2; tensor parallelism,
parallel/tensor.py), else on a dp = n mesh; the dp OfflineRunner over
device-resident samples, quant-dp, packed-dp and Server-dp on the dp = n
mesh; quant-tp, the int8 small model on dp = n / 2 x tp = 2 (n even).
Each is held to the single-device run: tokens and ``res_idx`` equal; the
float tensor-parallel decode may part from it only at near-ties (its
column-slice products may round apart:
tools/decode_divergence.compare_tp_run_launches).  Tensor parallelism has
no kernel, so on the card the tensor-parallel phases run its plain rank
steps (impl="reference").  With fewer cards than
n, the mesh lists the cards round-robin (two shards, or two model ranks,
may share one card).  The small model is 128 wide in the encoder and 64
in the prediction net and the joint, the least widths kernels C and B
take.
"""

from __future__ import annotations

import argparse
import sys

import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.data.dataset import SampleStore
from rnnt_inference_tpu_torch.models.decoder import drain, greedy_decode_steps
from rnnt_inference_tpu_torch.models.quant import calibrate, quantize_weights
from rnnt_inference_tpu_torch.models.weights import init_weights
from rnnt_inference_tpu_torch.parallel.mesh import (
    batch_sharding,
    join,
    lens_sharding,
    make_mesh,
    weight_shardings,
)
from rnnt_inference_tpu_torch.runtime.harness import run_offline
from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner, lockstep
from rnnt_inference_tpu_torch.runtime.packing import PackedOfflineRunner
from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary
from rnnt_inference_tpu_torch.parallel.tensor import greedy_decode_tp
from rnnt_inference_tpu_torch.runtime.server import (
    init_server_state,
    server_insert,
    server_multi_step,
    server_multi_step_dp,
)

SMALL = RNNTParams(trans_input_size=240, trans_hidden_size=128, pred_hidden_size=64,
                   joint_hidden_size=64, max_res_len=64)


def mesh_devices(n: int, device: str = "cuda") -> list:
    """n devices: the CPU n times, or the visible cards round-robin."""
    if device == "cpu":
        return ["cpu"] * n
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def decode_dp(mesh, weights, x, x_lens, params, impl=None):
    """greedy_decode with the batch axis cut over the mesh's data devices,
    the shards in lockstep; (res, res_lens) joined on x's device."""
    steps = [greedy_decode_steps(w, xs, ls, params, impl=impl) for w, xs, ls in
             zip(weight_shardings(mesh, weights), batch_sharding(mesh, x), lens_sharding(mesh, x_lens))]
    outs = lockstep(steps, mesh.data_devices)
    return tuple(join([o[k] for o in outs], 0, x.device) for k in range(2))


def _equal(name, got, want):
    if len(got) != len(want) or not all(
            torch.equal(torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu())
            for g, w in zip(got, want)):
        raise AssertionError(f"{name}: sharded run != single-device run")


def _near_ties(name, got, want, rerun) -> str:
    """A float tensor-parallel decode (res, lens) against the single-device
    one: "equal", or "near-ties" where tokens part at an edit rate <= 1e-3
    and every decode call of ``rerun()`` parts from the one-device twin
    only at a tie (tools/decode_divergence.compare_tp_run_launches)."""
    from rnnt_inference_tpu_torch.tools.decode_divergence import compare_tp_run_launches

    if all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)):
        return "equal"
    toks = lambda res, lens: [res[i, : int(lens[i])].tolist() for i in range(res.shape[0])]
    a, b = toks(*got), toks(*want)
    differ = sum(x != y for x, y in zip(a, b))
    if differ / max(sum(len(t) for t in b), 1) > 1e-3:
        raise AssertionError(f"{name}: {differ} utterances part from the single-device run")
    _, summary = compare_tp_run_launches(rerun)
    if summary["faults"]:
        raise AssertionError(f"{name}: parts outside a near-tie: {summary}")
    return "near-ties"


def dryrun_multichip(n_devices: int, devices=None, impl=None, log=print) -> dict:
    """Run every phase on a mesh of ``devices`` (``mesh_devices(n)`` by
    default); raises AssertionError where a sharded run parts from the
    single-device one.  Returns a dict of what each phase checked."""
    devices = devices if devices is not None else mesh_devices(n_devices)
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, devices=devices)
    tp_mesh = make_mesh(n_devices, model_parallel=tp, devices=devices)
    dev = mesh.data_devices[0]
    dp = mesh.shape["data"]
    tp_impl = "reference" if dev.type == "cuda" else impl  # no rank kernels
    cfg = FeaturizerConfig()
    out = {"mesh": repr(mesh), "tp_mesh": repr(tp_mesh)}
    with torch.inference_mode():
        # greedy decode at the MLPerf widths, dp x tp = 2 (n even)
        params = RNNTParams(max_res_len=64)
        w = init_weights(params, torch.Generator().manual_seed(0), device=dev)
        T, N = 8, max(2 * n_devices, 8)
        x = torch.randn((T, N, params.trans_input_size),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        x_lens = torch.full((N,), T, dtype=torch.int32, device=dev)
        want = drain(greedy_decode_steps(w, x, x_lens, params, impl=impl))
        if tp > 1:
            w_tp = weight_shardings(tp_mesh, w, tensor_parallel=True)
            run = lambda: greedy_decode_tp(tp_mesh, w_tp, x, x_lens, params, impl=tp_impl)
            res, lens = run()
            verdict = _near_ties("tp decode", (res, lens), want, run)
        else:
            res, lens = decode_dp(mesh, w, x, x_lens, params, impl)
            _equal("dp decode", (res, lens), want)
            verdict = "equal"
        out["dp_decode"] = dict(res=list(res.shape), lens=[int(lens.min()), int(lens.max())],
                                tokens=verdict)
        log(f"dryrun_multichip OK: mesh=({n_devices // tp}x{tp}) res={tuple(res.shape)} "
            f"lens min/max={int(lens.min())}/{int(lens.max())} tokens {verdict}")

        # the Offline runner over device-resident samples
        ws = init_weights(SMALL, torch.Generator().manual_seed(2), device=dev)
        store = SampleStore.synthetic(n=2 * dp, seed=3, min_seconds=0.3, max_seconds=0.8,
                                      mean_seconds=0.5)
        runner = OfflineRunner(ws, SMALL, cfg, batch_size=dp, mesh=mesh, impl=impl)
        rep = run_offline(ws, store, SMALL, cfg, batch_size=dp, warmup=False, runner=runner,
                          device_resident=True)
        single = run_offline(ws, store, SMALL, cfg, batch_size=dp, warmup=False,
                             device_resident=True, runner=OfflineRunner(
                                 ws, SMALL, cfg, batch_size=dp, device=dev, impl=impl))
        if rep.samples != len(store) or rep.hypotheses != single.hypotheses:
            raise AssertionError("offline-runner: sharded run != single-device run")
        out["offline"] = dict(samples=rep.samples, batches=rep.extra["batches"])
        log(f"dryrun_multichip offline-runner OK: dp={dp} samples={rep.samples} "
            f"batches={rep.extra['batches']}")

        # int8: replicated quantized weights, batch over "data"
        xq = torch.randn((8, dp, SMALL.trans_input_size),
                         generator=torch.Generator().manual_seed(4)).to(dev)
        lq = torch.full((dp,), 8, dtype=torch.int32, device=dev)
        wq = quantize_weights(ws, calibrate(ws, [(xq, lq)], SMALL), SMALL)
        resq = decode_dp(mesh, wq, xq, lq, SMALL, impl)
        _equal("quant-dp", resq, drain(greedy_decode_steps(wq, xq, lq, SMALL, impl=impl)))
        out["quant_dp"] = dict(res=list(resq[0].shape))
        log(f"dryrun_multichip quant-dp OK: dp={dp} res={tuple(resq[0].shape)}")

        # int8 under tensor parallelism: dp = n / 2 x tp = 2
        if tp > 1:
            wq_tp = weight_shardings(tp_mesh, wq, tensor_parallel=True)
            resqt = greedy_decode_tp(tp_mesh, wq_tp, xq, lq, SMALL, impl=tp_impl)
            _equal("quant-tp", resqt, resq)
            out["quant_tp"] = dict(dp=n_devices // 2, tp=2, res=list(resqt[0].shape))
            log(f"dryrun_multichip quant-tp OK: dp={n_devices // 2} tp=2 "
                f"res={tuple(resqt[0].shape)} tokens==single-device")

        # packed Offline, lanes over "data": tokens equal the single device's
        store_p = SampleStore.synthetic(n=4 * dp, seed=7, min_seconds=0.3, max_seconds=1.0,
                                        mean_seconds=0.6)
        qsl_p = QuerySampleLibrary(store_p, cfg)
        pk = dict(n_lanes=2 * dp, chunk_frames=8, batch_size=2 * dp, decode_chunk=16, impl=impl)
        r1 = PackedOfflineRunner(ws, SMALL, cfg, device=dev, **pk)
        r1.stage(qsl_p)
        rm = PackedOfflineRunner(ws, SMALL, cfg, mesh=mesh, **pk)
        rm.stage(qsl_p)
        t1, tm = r1.run_device().tokens, rm.run_device().tokens
        _equal("packed-dp", tm, t1)
        out["packed_dp"] = dict(lanes=pk["n_lanes"], samples=len(store_p))
        log(f"dryrun_multichip packed-dp OK: dp={dp} lanes={pk['n_lanes']} "
            f"samples={len(store_p)} tokens==single-device")

        # Server slots over "data": insert, then fused steps on the sharded state
        slots, split, max_frames = 2 * dp, 4, 16
        feats = torch.randn((max_frames, slots, SMALL.trans_input_size),
                            generator=torch.Generator().manual_seed(5)).to(dev)
        flens = torch.tensor([3 + (7 * i) % (max_frames - 2) for i in range(slots)],
                             dtype=torch.int32, device=dev)
        sids = torch.arange(slots, device=dev)
        k = -(-max_frames // split)
        st = server_insert(init_server_state(slots, max_frames, SMALL, cfg, device=dev),
                           feats, flens, sids, SMALL)
        s1, f1 = server_multi_step(ws, st, split, k, SMALL, impl)
        if not bool(f1.all()):
            raise AssertionError("single-device Server run left unfinished slots")
        st = server_insert(init_server_state(slots, max_frames, SMALL, cfg, device=dev),
                           feats, flens, sids, SMALL)
        sm, fm = server_multi_step_dp(mesh, weight_shardings(mesh, ws), st, split, k, SMALL, impl)
        _equal("server-dp", (sm.decode.res, sm.decode.res_idx, fm),
               (s1.decode.res, s1.decode.res_idx, f1))
        out["server_dp"] = dict(slots=slots, split=split)
        log(f"dryrun_multichip server-dp OK: dp={dp} slots={slots} split={split} "
            f"tokens==single-device")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("dryrun_multichip")
    p.add_argument("--n", type=int, default=None, help="mesh devices (default: visible cards)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 2)
    dryrun_multichip(n, mesh_devices(n, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
