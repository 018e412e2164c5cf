"""CLI entry point: calibrate -> quantize -> benchmark/accuracy
(counterpart of rnnt_inference_tpu/main.py, same flags and staged flow):

  python -m rnnt_inference_tpu_torch.main --model rnnt.pt --calibration \
      --calib_file train.npz --calib_out rnnt_calib.npz
  python -m rnnt_inference_tpu_torch.main --model rnnt.pt --save_quant \
      --calib_in rnnt_calib.npz --quant_out rnnt_quant.npz
  python -m rnnt_inference_tpu_torch.main --quant_in rnnt_quant.npz --benchmark \
      --scenario Offline --sample_file dev-clean.npz --accuracy
  python -m rnnt_inference_tpu_torch.main --benchmark --scenario Offline --synthetic 64
  python -m rnnt_inference_tpu_torch.main --quant_in rnnt_quant.npz --benchmark --packed \
      --synthetic 64
  python -m rnnt_inference_tpu_torch.main --quant_in rnnt_quant.npz --accuracy \
      --scenario Server --sample_file dev-clean.npz --manifest dev-clean.json
  python -m rnnt_inference_tpu_torch.main --quant_in rnnt_quant.npz --benchmark \
      --native_loadgen --scenario Server --sample_file dev-clean.npz --user_conf user.conf

--model takes the MLPerf zenodo checkpoint (rnnt.pt, read with torch.load)
or the JAX package's weights npz.  Weights, calibration, quantized models
and sample stores are the JAX package's npz files, so either package reads
what the other wrote.  --manifest replaces the store's transcripts with a
manifest's (utterances up to 15 s), for WER.  Run
modes: bf16 (the default: every weight cast to bf16), f32, quant (int8
encoder from --quant_in), fake_quant (f32 with the int8 rounding simulated;
needs --calib_in).  --profiler_dir writes a torch.profiler trace of the
benchmark/accuracy stage there.  Scenarios: Offline (bucketed, or sequence-packed
with --packed and by the JAX CLI's auto rule at symbol cap 1), Server (the
slot pipeline under Poisson arrivals) and SingleStream.  --native_loadgen
times performance runs of every scenario (SingleStream also with
--accuracy) on the native mini-loadgen's clock (runtime/native.py, built
with g++ on first use) under the conf's TestSettings.  Everything runs on
the card unless --device cpu is given, where the plain PyTorch twins of the
kernels run.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("rnnt_inference_tpu_torch")
    # model artifacts
    p.add_argument("--model", type=str, default=None,
                   help="f32 checkpoint: zenodo rnnt.pt (torch) or weights .npz "
                        "(the JAX package's container)")
    p.add_argument("--calib_in", type=str, default=None)
    p.add_argument("--calib_out", type=str, default="rnnt_calib.npz")
    p.add_argument("--quant_in", type=str, default=None)
    p.add_argument("--quant_out", type=str, default="rnnt_quant.npz")
    p.add_argument("--run_mode", type=str, default="bf16",
                   choices=["f32", "bf16", "quant", "fake_quant"])
    # stages
    p.add_argument("--calibration", action="store_true")
    p.add_argument("--save_quant", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--accuracy", action="store_true")
    # data
    p.add_argument("--sample_file", type=str, default=None,
                   help="SampleStore .npz (waveforms or features)")
    p.add_argument("--calib_file", type=str, default=None)
    p.add_argument("--calib_list", type=str, default=None,
                   help="calibration file list: restricts the calibration stage "
                        "to the listed utterances")
    p.add_argument("--manifest", type=str, default=None,
                   help="manifest JSON for WER scoring")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic utterances instead of sample_file")
    # scenario
    p.add_argument("--scenario", type=str, default="Offline",
                   choices=["Offline", "Server", "SingleStream"])
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--split_len", type=int, default=-1)
    p.add_argument("--packed", dest="packed", action="store_true", default=None,
                   help="force the sequence-packed Offline path")
    p.add_argument("--no_packed", dest="packed", action="store_false",
                   help="force the bucketed Offline path")
    p.add_argument("--pack_chunk", type=int, default=16,
                   help="packing grain in feature frames")
    p.add_argument("--pack_decode_chunk", type=int, default=128,
                   help="decode grain over the packed timeline, in post-stack frames")
    p.add_argument("--server_slots", type=int, default=128)
    p.add_argument("--response_size", type=int, default=9)
    p.add_argument("--native_loadgen", action="store_true",
                   help="time performance runs with the C++ mini-loadgen (native "
                        "issue thread and latency recorder)")
    p.add_argument("--mlperf_conf", type=str, default=None)
    p.add_argument("--user_conf", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--profiler_dir", type=str, default=None,
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels; cpu their plain PyTorch twins")
    return p.parse_args(argv)


def load_model_weights(args, params, device):
    """(weights, kind) from the CLI flags, on ``device``."""
    from rnnt_inference_tpu_torch.models import checkpoint as ckpt
    from rnnt_inference_tpu_torch.models.weights import init_weights, load_torch_checkpoint

    if args.quant_in:
        return ckpt.load_quant_weights(args.quant_in, params, device), "quant"
    if args.model is None:
        w = init_weights(params, torch.Generator().manual_seed(args.seed), device=device)
    elif args.model.endswith(".npz"):
        w = ckpt.load_weights(args.model, params, device)
    else:
        w = load_torch_checkpoint(args.model, params, device)
    if args.run_mode == "fake_quant":
        # the quantization-error triage mode needs the calibrated amaxes
        from rnnt_inference_tpu_torch.models.quant import fake_quantize_weights

        if not args.calib_in:
            raise SystemExit("--run_mode fake_quant requires --calib_in")
        calib = ckpt.load_calib(args.calib_in, device)
        return fake_quantize_weights(w.to(dtype=torch.float32), calib, params), "fake_quant"
    if args.run_mode == "bf16":
        w = w.to(dtype=torch.bfloat16)
    return w, args.run_mode


def load_store(args, path):
    from rnnt_inference_tpu_torch.data.dataset import SampleStore

    if args.synthetic:
        return SampleStore.synthetic(n=args.synthetic, seed=args.seed)
    if path is None:
        raise SystemExit("need --sample_file/--calib_file or --synthetic N")
    return SampleStore.load(path)


def main(argv=None):
    """Run the stages the flags ask for; returns the scenario's RunReport,
    for Server (ServerMetrics, {query: tokens}), with --native_loadgen (the
    native report dict, {query: tokens}) (None without
    --benchmark/--accuracy)."""
    args = parse_args(argv)
    from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams

    params = RNNTParams()
    cfg = FeaturizerConfig()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but no CUDA device is available (use --device cpu)")
        # true f32 matmuls (the featurizer's contract) and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    weights, _ = load_model_weights(args, params, device)

    # -- stage: calibration -------------------------------------------------
    if args.calibration:
        from rnnt_inference_tpu_torch.models import checkpoint as ckpt
        from rnnt_inference_tpu_torch.models.quant import calibrate
        from rnnt_inference_tpu_torch.ops.features import log_mel_features
        from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

        store = load_store(args, args.calib_file)
        if args.calib_list:
            store = store.filter_by_list(args.calib_list)
            print(f"calibration subset: {len(store)} utterances from {args.calib_list}")
        qsl = QuerySampleLibrary(store, cfg)
        order = qsl.sort_desc(np.arange(len(store)))
        B = min(args.batch_size, 32)
        batches = []
        for s in range(0, len(order), B):
            wav, lens, _ = qsl.assemble_waveforms(order[s : s + B], pad_n=B)
            batches.append(log_mel_features(
                torch.from_numpy(wav).to(device), torch.from_numpy(lens).to(device), cfg
            ))
        calib = calibrate(weights.to(dtype=torch.float32), batches, params)
        ckpt.save_calib(args.calib_out, calib)
        print(f"calibration saved to {args.calib_out}: "
              f"pre_amax={calib.pre_amax.cpu().numpy()} "
              f"post_amax={calib.post_amax.cpu().numpy()}")

    # -- stage: quantize + save ---------------------------------------------
    if args.save_quant:
        from rnnt_inference_tpu_torch.models import checkpoint as ckpt
        from rnnt_inference_tpu_torch.models.quant import quantize_weights

        calib = ckpt.load_calib(args.calib_in or args.calib_out, device)
        qw = quantize_weights(weights.to(dtype=torch.float32), calib, params)
        ckpt.save_quant_weights(args.quant_out, qw)
        print(f"quantized model saved to {args.quant_out}")

    # -- stage: benchmark / accuracy ----------------------------------------
    if args.benchmark or args.accuracy:
        from rnnt_inference_tpu_torch.utils.profiler import device_trace

        store = load_store(args, args.sample_file)
        if args.manifest:
            from rnnt_inference_tpu_torch.data.manifest import Manifest

            store.transcripts = Manifest([args.manifest], max_duration=15.0).transcripts
        with device_trace(args.profiler_dir, device):
            return _run_scenario(args, weights, store, params, cfg, device)
    return None


def _write_summary(args, summary):
    print(json.dumps(summary, indent=2))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def _run_scenario(args, weights, store, params, cfg, device):
    from rnnt_inference_tpu_torch.runtime.config import TestSettings, validate_report

    settings = TestSettings.from_conf(args.mlperf_conf, args.user_conf, "rnnt", args.scenario)
    # performance runs under an MLPerf conf load exactly
    # performance_sample_count samples; accuracy runs cover the whole set
    if (
        not args.accuracy
        and (args.mlperf_conf or args.user_conf)
        and len(store) > settings.performance_sample_count
    ):
        store = store.select(np.arange(settings.performance_sample_count))

    if args.scenario == "Offline":
        from rnnt_inference_tpu_torch.runtime.harness import run_offline

        # the JAX CLI's auto rule: packed at symbol cap 1, bucketed at the
        # product cap; --packed / --no_packed force either; feature stores
        # are always bucketed
        packed = args.packed
        if packed is None:
            packed = store.kind == "waveform" and params.max_symbols_per_step == 1
        elif packed and store.kind != "waveform":
            raise SystemExit("--packed requires a waveform sample store")
        if args.native_loadgen and not args.accuracy:
            from rnnt_inference_tpu_torch.runtime.harness import run_offline_native

            report = run_offline_native(
                weights, store, params, cfg,
                batch_size=args.batch_size,
                split_len=args.split_len,
                target_qps=settings.target_qps,
                min_query_count=settings.min_query_count,
                min_duration_s=settings.min_duration_ms / 1e3,
                samples_per_query=settings.samples_per_query,
                # 0: the whole store when no MLPerf conf was given (the
                # trim rule above)
                performance_sample_count=(settings.performance_sample_count
                                          if args.mlperf_conf or args.user_conf else 0),
                packed=packed,
                chunk_frames=args.pack_chunk,
                decode_chunk=args.pack_decode_chunk,
                device=device,
            )
            _write_summary(args, validate_report(settings, report.summary()))
            return report
        report = run_offline(
            weights, store, params, cfg,
            batch_size=args.batch_size,
            split_len=args.split_len,
            accuracy=args.accuracy,
            output_dir=args.output_dir,
            device_resident=not args.accuracy,
            packed=packed,
            device=device,
            chunk_frames=args.pack_chunk,
            decode_chunk=args.pack_decode_chunk,
        )
        print(json.dumps(report.summary(), indent=2))
    elif args.scenario == "Server":
        from rnnt_inference_tpu_torch.runtime.harness import tokens_to_hex
        from rnnt_inference_tpu_torch.runtime.scheduler import run_server
        from rnnt_inference_tpu_torch.runtime.server import ServerRunner

        runner = ServerRunner(
            weights, params, cfg,
            slots=args.server_slots,
            split_len=max(args.split_len, 2) if args.split_len > 0 else 24,
            device=device,
        )
        runner.warmup()
        # accuracy runs cover the set once; performance runs keep the
        # conf's min_duration / min_query_count rules
        if args.native_loadgen and not args.accuracy:
            from rnnt_inference_tpu_torch.runtime.scheduler import run_server_native

            metrics, results = run_server_native(
                runner, store, target_qps=settings.target_qps,
                response_size=args.response_size,
                min_query_count=settings.min_query_count,
                min_duration_s=settings.min_duration_ms / 1e3,
            )
            summary = dict(metrics, scenario="Server", timing="native")
        else:
            metrics, results = run_server(
                runner, store, target_qps=settings.target_qps,
                realtime=not args.accuracy,
                response_size=args.response_size,
                min_query_count=0 if args.accuracy else settings.min_query_count,
                min_duration_s=0.0 if args.accuracy else settings.min_duration_ms / 1e3,
            )
            summary = metrics.summary()
        _write_summary(args, validate_report(settings, summary))
        if args.accuracy:
            n = len(store)
            acc = [{"qsl_idx": q % n, "data": tokens_to_hex(results[q])} for q in sorted(results)]
            with open(os.path.join(args.output_dir, "accuracy_log.json"), "w") as f:
                json.dump(acc, f)
        return metrics, results
    else:  # SingleStream, on the native loadgen's clock with --native_loadgen
        from rnnt_inference_tpu_torch.runtime.harness import (
            run_single_stream,
            run_single_stream_native,
        )

        if args.native_loadgen:
            report = run_single_stream_native(
                weights, store, params, cfg,
                min_query_count=settings.min_query_count,
                min_duration_s=settings.min_duration_ms / 1e3,
                device=device,
            )
        else:
            report = run_single_stream(
                weights, store, params, cfg, split_len=args.split_len, device=device
            )
        _write_summary(args, validate_report(settings, report.summary()))
    return report


if __name__ == "__main__":
    main()
