"""The staged MLPerf flow of scripts/run.sh and its stage scripts, on the
port.

    STAGE=-1 python -m rnnt_inference_tpu_torch.tools.run_stages       # run.sh
    python -m rnnt_inference_tpu_torch.tools.run_stages calibrate       # calibrate.sh
    python -m rnnt_inference_tpu_torch.tools.run_stages eval            # eval_model.sh
    python -m rnnt_inference_tpu_torch.tools.run_stages offline         # run_offline.sh
    python -m rnnt_inference_tpu_torch.tools.run_stages server          # run_server.sh
    PLATFORM=cpu QUICK=true STAGE=-1 python -m rnnt_inference_tpu_torch.tools.run_stages

Run from the repository's root, as run.sh cds there: relative paths
(WORK_DIR=work, configs/mlperf.conf) are taken from the working directory.
Each command reads the environment knobs of its shell script, with the
same defaults (run.sh: STAGE, WORK_DIR, DATA_DIR, MODEL, MODEL_URL, CALIB_OUT,
QUANT_OUT, DEV_CLEAN, TRAIN_CALIB, SYNTHETIC_ONLY, QUICK, CALIB_LIST,
TRT_CACHE, PACKED, NATIVE, SYNTHETIC, USER_CONF; the stage scripts' own,
such as BATCH_SIZE, OUTPUT_DIR, SAMPLE_FILE or SLOTS), builds the argument
list the script builds, with ``python -m rnnt_inference_tpu.main`` replaced
by this package's ``main``, and calls ``main.main(argv)`` in this process,
so the kernels' launch counters see every stage.  A stage script run by
run.sh sees run.sh's environment with the stage's assignments on top, as
the shell passes it.  PLATFORM=cpu becomes ``--device cpu`` (where the
JAX scripts pass ``--platform``, and also in the stage-4 quantize call and
eval, whose JAX scripts pass none); unset, everything runs on the card.

Stages (each runs if STAGE <= n):
  -1  probe the card in a throwaway process killed at a deadline
      (utils/backend.py probe_backend, PREPARE_PROBE_TIMEOUT_S, 300 s; a
      probe that fails stops the run), then build the four CUDA kernels
      (neither with PLATFORM=cpu) and the native loadgen, round-trip FLAC;
      a failed build raises.  With QUICK, the port's golden gate
      (tests/test_torch_golden.py), where jax imports: that test makes the
      bundle's weights with the JAX package; elsewhere a line says that
      the gate did not run and why.
   0  the checkpoint: kept when MODEL exists, else (SYNTHETIC_ONLY not
      true) fetched from MODEL_URL (run.sh's zenodo URL) with
      data/download.py download_file; a failed fetch prints run.sh's skip
      notice and leaves no file at MODEL
   1  LibriSpeech: kept when the corpus is present, else (SYNTHETIC_ONLY
      not true) data/download.py main fetches, md5-checks and extracts
      dev-clean and train-clean-100 into DATA_DIR; a failure prints
      run.sh's notice and the flow goes on
   2  tools/convert_librispeech.py, when the corpus is present (looked
      for again after stage 1)
   3  calibrate and quantize (calibrate.sh), then tools/check_calib.py
      against TRT_CACHE when that file exists (default
      $WORK_DIR/calibration_result_nv.cache), advisory unless MODEL and
      TRAIN_CALIB both exist
   4  quantize alone (when STAGE is 4)
   5  Offline accuracy (packed) and performance (native), Server accuracy
      and performance (native)

QUICK=true writes $WORK_DIR/quick.conf (min_duration 0, 64 queries) and,
unless CALIB_LIST is set, a calibration list of the synthetic store's
first 32 names, and serves SYNTHETIC=64 utterances.  DEBUG (pdb,
faulthandler, gdb) is not supported: a run that sets it stops.

``run(command, env)`` returns one record per ``main`` call: the stage,
the script it stands for, argv, the kernel launches of the call and its
seconds.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import tarfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from rnnt_inference_tpu_torch import main as cli
from rnnt_inference_tpu_torch.data import download
from rnnt_inference_tpu_torch.runtime.offline import launch_counts, launches_since
from rnnt_inference_tpu_torch.utils import backend

REPO = Path(__file__).resolve().parents[2]
GOLDEN_TEST = REPO / "tests" / "test_torch_golden.py"

QUICK_CONF = """rnnt.*.min_duration = 0
rnnt.Offline.min_query_count = 64
rnnt.Server.min_query_count = 64
rnnt.Offline.target_qps = 100
rnnt.Server.target_qps = 50
"""

# run.sh's MODEL_URL default
ZENODO_URL = ("https://zenodo.org/record/3662521/files/"
              "DistributedDataParallel_1576581068.9962234-epoch-100.pt?download=1")
# what fails a fetch: urllib's errors and a bad md5 (OSError), a URL it
# cannot open (ValueError), a tarball it refuses (TarError)
FETCH_ERRORS = (OSError, ValueError, tarfile.TarError)

Env = Dict[str, str]


def _get(env: Env, key: str, default: str = "") -> str:
    """${KEY:-default}: the default when the knob is unset or empty."""
    return env.get(key) or default


def _device(env: Env) -> List[str]:
    platform = _get(env, "PLATFORM")
    if not platform:
        return []
    if platform not in ("cpu", "cuda"):
        raise SystemExit(f"PLATFORM={platform!r}: the port runs on 'cuda' or 'cpu'")
    return ["--device", platform]


def _data(env: Env, synthetic: str) -> List[str]:
    sample_file = _get(env, "SAMPLE_FILE")
    if sample_file:
        return ["--sample_file", sample_file]
    return ["--synthetic", _get(env, "SYNTHETIC", synthetic)]


def _refuse_debug(env: Env) -> None:
    if _get(env, "DEBUG"):
        raise SystemExit(f"DEBUG={env['DEBUG']}: run_stages calls main in this process and has "
                         "no debugger wrap; wrap the whole command instead")


def _opt(flag: str, value: str) -> List[str]:
    return [flag, value] if value else []


def calibrate_argvs(env: Env) -> List[List[str]]:
    """calibrate.sh: calibration, then quantization."""
    model, calib_out = _get(env, "MODEL"), _get(env, "CALIB_OUT", "rnnt_calib.npz")
    calib_file = _get(env, "CALIB_FILE")
    a = ["--run_mode", "f32", "--calibration", "--calib_out", calib_out] + _device(env)
    a += _opt("--model", model)
    a += (["--calib_file", calib_file] if calib_file
          else ["--synthetic", _get(env, "SYNTHETIC", "500")])
    a += _opt("--calib_list", _get(env, "CALIB_LIST"))
    b = ["--run_mode", "f32", "--save_quant", "--calib_in", calib_out,
         "--quant_out", _get(env, "QUANT_OUT", "rnnt_quant.npz")] + _device(env)
    b += _opt("--model", model) + ["--synthetic", "1"]
    return [a, b]


def eval_argv(env: Env) -> List[str]:
    """eval_model.sh (the port appends --device for PLATFORM)."""
    a = ["--scenario", "Offline", "--accuracy", "--batch_size", _get(env, "BATCH_SIZE", "128"),
         "--output_dir", _get(env, "OUTPUT_DIR", "output/eval")]
    a += _opt("--model", _get(env, "MODEL")) + _opt("--quant_in", _get(env, "QUANT"))
    a += _data(env, "256") + _opt("--manifest", _get(env, "MANIFEST"))
    return a + _device(env)


def offline_argv(env: Env) -> List[str]:
    """run_offline.sh."""
    a = ["--scenario", "Offline", "--benchmark", "--batch_size", _get(env, "BATCH_SIZE", "256"),
         "--split_len", _get(env, "SPLIT_LEN", "-1"),
         "--output_dir", _get(env, "OUTPUT_DIR", "output/offline")]
    a += ["--native_loadgen"] if _get(env, "NATIVE", "false") == "true" else []
    packed = _get(env, "PACKED")
    a += ["--packed"] if packed == "true" else ["--no_packed"] if packed == "false" else []
    a += _opt("--mlperf_conf", _get(env, "MLPERF_CONF"))
    a += _opt("--user_conf", _get(env, "USER_CONF"))
    a += _device(env) + _opt("--model", _get(env, "MODEL")) + _opt("--quant_in", _get(env, "QUANT"))
    a += _data(env, "1024")
    a += ["--accuracy"] if _get(env, "ACCURACY", "false") == "true" else []
    return a + _opt("--manifest", _get(env, "MANIFEST"))


def server_argv(env: Env) -> List[str]:
    """run_server.sh."""
    a = ["--scenario", "Server", "--benchmark", "--server_slots", _get(env, "SLOTS", "128"),
         "--split_len", _get(env, "SPLIT_LEN", "24"),
         "--response_size", _get(env, "RESPONSE_SIZE", "9"),
         "--output_dir", _get(env, "OUTPUT_DIR", "output/server"),
         "--mlperf_conf", _get(env, "MLPERF_CONF", "configs/mlperf.conf"),
         "--user_conf", _get(env, "USER_CONF", "configs/user.conf")]
    a += ["--native_loadgen"] if _get(env, "NATIVE", "false") == "true" else []
    a += _device(env) + _opt("--model", _get(env, "MODEL")) + _opt("--quant_in", _get(env, "QUANT"))
    a += ["--accuracy"] if _get(env, "ACCURACY", "false") == "true" else []
    return a + _data(env, "512")


class Stages:
    """The run's records: one per ``main`` call."""

    def __init__(self):
        self.records: List[dict] = []

    def main(self, stage: str, script: str, argv: List[str]):
        print(f"    main {' '.join(argv)}", flush=True)
        before, t0 = launch_counts(), time.time()
        ret = cli.main(argv)
        self.records.append(dict(stage=stage, script=script, argv=argv,
                                 launches=launches_since(before), seconds=time.time() - t0))
        return ret

    def calibrate(self, env: Env, stage: str = "calibrate") -> None:
        for argv in calibrate_argvs(env):
            self.main(stage, "calibrate.sh", argv)

    def eval(self, env: Env, stage: str = "eval") -> None:
        from rnnt_inference_tpu_torch.tools import eval_accuracy

        argv = eval_argv(env)
        self.main(stage, "eval_model.sh", argv)
        manifest = _get(env, "MANIFEST")
        if manifest:  # the corpus WER, scored apart as the reference does
            out = argv[argv.index("--output_dir") + 1]
            eval_accuracy.main(["--log_path", os.path.join(out, "accuracy_log.json"),
                                "--manifest_path", manifest])

    def offline(self, env: Env, stage: str = "offline") -> None:
        self.main(stage, "run_offline.sh", offline_argv(env))

    def server(self, env: Env, stage: str = "server") -> None:
        self.main(stage, "run_server.sh", server_argv(env))


def prepare_env(env: Env) -> None:
    """Stage -1 (prepare_env.sh): the versions; off PLATFORM=cpu, the card
    probed in a throwaway process killed after PREPARE_PROBE_TIMEOUT_S
    (a probe that fails raises SystemExit, before any build), then the
    four CUDA kernels built and loaded (PLATFORM=cpu runs the plain twins
    and builds none); the native loadgen built with g++, FLAC
    round-tripped.  A failed build raises."""
    import numpy as np
    import torch

    from rnnt_inference_tpu_torch.data.flac import decode_flac, encode_flac
    from rnnt_inference_tpu_torch.ops import (
        cuda_build, decode_cuda, features_cuda, lstm_cuda, lstm_scan_cuda, projection_cuda,
    )
    from rnnt_inference_tpu_torch.runtime import native

    print("== python deps ==")
    print(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), numpy {np.__version__}")
    if _device(env) == ["--device", "cpu"]:
        print("== CUDA kernels ==")
        print("  PLATFORM=cpu: no kernel built; the plain PyTorch twins run")
    else:
        # a wedged driver blocks CUDA initialisation: ask a killable child first
        ok, detail = backend.probe_backend(float(_get(env, "PREPARE_PROBE_TIMEOUT_S", "300")))
        if not ok:
            raise SystemExit(f"  accelerator backend unavailable: {detail}\n"
                             "  (set PLATFORM=cpu to prepare without it)")
        print(f"  backend probe: {detail}")
        print("== CUDA kernels ==")
        names = [lstm_cuda.NAME, decode_cuda.NAME, lstm_scan_cuda.NAME, features_cuda.NAME,
                 projection_cuda.NAME]
        cuda_build.build(names)  # one nvcc per source, in parallel; raises on failure
        for name in names:
            cuda_build.load(name)
        print(f"  built and loaded on {torch.cuda.get_device_name(0)}: {', '.join(names)}")
    print("== native mini-loadgen ==")
    native.get_lib()  # raises with g++'s output on failure
    print("  built OK")
    print("== pure-python FLAC codec ==")
    x = np.arange(-500, 500, dtype=np.int32)
    out, _sr, _bps = decode_flac(encode_flac(x, 16000))
    if not (out[:, 0] == x).all():
        raise RuntimeError("FLAC round trip changed the samples")
    print("  round-trip OK (no external codec needed)")
    print("environment ready")


def golden_gate() -> None:
    """The port's golden gate, tests/test_torch_golden.py, where jax
    imports (it makes the bundle's weights with the JAX package);
    elsewhere one line says it did not run and why.  A failing gate
    raises."""
    if not GOLDEN_TEST.exists():
        print(f"    golden gate NOT RUN: {GOLDEN_TEST} is not here (not a checkout)")
        return
    if importlib.util.find_spec("jax") is None:
        print("    golden gate NOT RUN: tests/test_torch_golden.py makes the bundle's "
              "weights with the JAX package, and jax is not installed here")
        return
    r = subprocess.run([sys.executable, "-m", "pytest", str(GOLDEN_TEST), "-q",
                        "-p", "no:cacheprovider"], cwd=REPO, capture_output=True, text=True)
    print(r.stdout[-2000:], end="")
    if r.returncode:
        raise RuntimeError(f"golden gate failed (pytest exit {r.returncode}):\n{r.stderr[-2000:]}")


def _write_quick(work: str, env: Env) -> None:
    """QUICK=true: the tiny rule overrides and the calibration list."""
    conf = os.path.join(work, "quick.conf")
    with open(conf, "w") as f:
        f.write(QUICK_CONF)
    env["USER_CONF"] = conf
    env["SYNTHETIC"] = _get(env, "SYNTHETIC", "64")
    if not _get(env, "CALIB_LIST"):
        path = os.path.join(work, "quick_calib_list.txt")
        with open(path, "w") as f:
            for i in range(32):
                f.write(f"synthetic-{i:05d}.wav\n")
        env["CALIB_LIST"] = path


def run_all(env: Env, stages: Stages, prepare: Callable[[Env], None] = prepare_env,
            gate: Callable[[], None] = golden_gate) -> None:
    """run.sh: every stage from STAGE on."""
    env = dict(env)
    knobs = {}
    knobs["STAGE"] = _get(env, "STAGE", "-1")
    work = knobs["WORK_DIR"] = _get(env, "WORK_DIR", "work")
    data_dir = knobs["DATA_DIR"] = _get(env, "DATA_DIR", f"{work}/LibriSpeech")
    model = knobs["MODEL"] = _get(env, "MODEL", f"{work}/rnnt.pt")
    model_url = knobs["MODEL_URL"] = _get(env, "MODEL_URL", ZENODO_URL)
    calib_out = knobs["CALIB_OUT"] = _get(env, "CALIB_OUT", f"{work}/rnnt_calib.npz")
    quant_out = knobs["QUANT_OUT"] = _get(env, "QUANT_OUT", f"{work}/rnnt_quant.npz")
    dev_clean = knobs["DEV_CLEAN"] = _get(env, "DEV_CLEAN", f"{work}/dev-clean.npz")
    train_calib = knobs["TRAIN_CALIB"] = _get(env, "TRAIN_CALIB", f"{work}/train-calib.npz")
    knobs["SYNTHETIC_ONLY"] = _get(env, "SYNTHETIC_ONLY", "false")
    have_net = knobs["SYNTHETIC_ONLY"] != "true"
    quick = knobs["QUICK"] = _get(env, "QUICK", "false")
    # run.sh's assignments reach the stage scripts only where the knob was
    # exported to it
    env.update({k: v for k, v in knobs.items() if k in env})
    stage = int(knobs["STAGE"])
    _refuse_debug(env)
    os.makedirs(work, exist_ok=True)
    if quick == "true":
        _write_quick(work, env)

    def have_corpus() -> bool:  # looked for at each stage, as run.sh does
        return os.path.isdir(f"{data_dir}/LibriSpeech/dev-clean")

    if stage <= -1:
        print("==> Stage -1: preparing environment", flush=True)
        prepare(env)
        if quick == "true":
            print("==> Stage -1b: golden-bundle regression gate (QUICK)", flush=True)
            gate()
    if stage <= 0:
        print("==> Stage 0: downloading model checkpoint", flush=True)
        fetched = os.path.isfile(model)
        if fetched:
            print(f"    {model} already present")
        elif have_net:
            try:
                download.download_file(model_url, model)
            except FETCH_ERRORS as e:
                print(f"    fetch failed: {type(e).__name__}: {e}")
            else:
                fetched = True
                print(f"    fetched {model} ({os.path.getsize(model)} bytes)")
        if not fetched:
            print("    no network access — skipping (runs will use random weights;")
            print(f"    place the zenodo checkpoint at {model} to use real weights)")
    if stage <= 1:
        print("==> Stage 1: downloading LibriSpeech", flush=True)
        if have_corpus():
            print(f"    {data_dir}/dev-clean already present")
        elif have_net:
            try:
                download.main(["--download_dir", data_dir, "--subsets", "dev-clean",
                               "train-clean-100"])
            except FETCH_ERRORS as e:
                print(f"    {type(e).__name__}: {e}")
                print("    download failed (no network?) — later stages fall back to "
                      "synthetic data")
        else:
            print("    SYNTHETIC_ONLY=true — skipping")
    if stage <= 2:
        print("==> Stage 2: converting dataset", flush=True)
        if have_corpus():
            from rnnt_inference_tpu_torch.tools import convert_librispeech

            workers = _get(env, "WORKERS", "8")
            convert_librispeech.main(
                ["--input_dir", f"{data_dir}/LibriSpeech/dev-clean", "--output", dev_clean,
                 "--features", "--workers", workers] + _device(env))
            if os.path.isdir(f"{data_dir}/LibriSpeech/train-clean-100"):
                convert_librispeech.main(
                    ["--input_dir", f"{data_dir}/LibriSpeech/train-clean-100", "--output",
                     train_calib, "--workers", workers]
                    + _opt("--calib_list", _get(env, "CALIB_LIST")) + _device(env))
        else:
            print("    corpus absent — skipping (calibration/serving use synthetic data)")
    if stage <= 3:
        print("==> Stage 3+4: calibrate + quantize", flush=True)
        cal = dict(env, CALIB_OUT=calib_out, QUANT_OUT=quant_out)
        if os.path.isfile(model):
            cal["MODEL"] = model
        if os.path.isfile(train_calib):
            cal["CALIB_FILE"] = train_calib
        stages.calibrate(cal, "3")
        trt_cache = _get(env, "TRT_CACHE", f"{work}/calibration_result_nv.cache")
        if os.path.isfile(trt_cache):
            from rnnt_inference_tpu_torch.tools import check_calib

            print("==> Stage 3b: calibration cross-check vs TRT cache", flush=True)
            rc = check_calib.main(["--cache", trt_cache, "--calib", calib_out])
            if rc and os.path.isfile(model) and os.path.isfile(train_calib):
                raise SystemExit(rc)
            if rc:
                print("    (advisory only: synthetic calibration, mismatch expected)")
    elif stage <= 4:
        print("==> Stage 4: quantize", flush=True)
        argv = ["--run_mode", "f32", "--save_quant", "--calib_in", calib_out, "--quant_out",
                quant_out, "--synthetic", "1"] + _opt("--model", model if os.path.isfile(model)
                                                      else "")
        stages.main("4", "run.sh", argv + _device(env))
    if stage <= 5:
        samples = dev_clean if os.path.isfile(dev_clean) else ""
        out = f"{work}/out"
        common = dict(env, QUANT=quant_out, SAMPLE_FILE=samples)
        print("==> Stage 5: Offline accuracy (packed path)", flush=True)
        stages.offline(dict(common, OUTPUT_DIR=f"{out}/offline_acc", ACCURACY="true",
                            PACKED=_get(env, "PACKED", "true")), "5")
        print("==> Stage 5: Offline performance", flush=True)
        stages.offline(dict(common, OUTPUT_DIR=f"{out}/offline_perf",
                            NATIVE=_get(env, "NATIVE", "true")), "5")
        print("==> Stage 5: Server accuracy", flush=True)
        stages.server(dict(common, OUTPUT_DIR=f"{out}/server_acc", ACCURACY="true"), "5")
        print("==> Stage 5: Server performance", flush=True)
        stages.server(dict(common, OUTPUT_DIR=f"{out}/server_perf",
                           NATIVE=_get(env, "NATIVE", "true")), "5")
        print(f"==> Done.  Results under {out}/")


COMMANDS = ("all", "calibrate", "eval", "offline", "server")


def run(command: str = "all", env: Optional[Env] = None) -> List[dict]:
    """Run ``command`` ("all" is run.sh) with ``env`` (os.environ by
    default); returns the records of its ``main`` calls."""
    if command not in COMMANDS:
        raise SystemExit(f"unknown command {command!r}: one of {', '.join(COMMANDS)}")
    env = dict(os.environ if env is None else env)
    stages = Stages()
    if command == "all":
        run_all(env, stages)
    else:
        _refuse_debug(env)
        getattr(stages, command)(env)
    return stages.records


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "all")
