"""The port's counterparts of the repository's entry scripts
(rnnt_inference_tpu_torch/tools/eval_accuracy.py, check_calib.py,
server_probe.py, run_stages.py) against the JAX package's scripts, on the
CPU.

Tolerance: none.  eval_accuracy prints the same line and writes a
byte-equal hypotheses.log; check_calib prints the same table and exits
with the same code; every ladder level's verdict dict equals the JAX
package's validate_report on the same metrics and settings; every stage's
argument list equals the one the JAX shell scripts build (each list is
written out below with the script lines it comes from, and the scripts
themselves are run with a stand-in ``python`` that records its arguments).

A real QUICK run of stages 3-5 is not here: at the MLPerf widths on the
CPU it takes minutes, past the 90 s this file may take.  It runs on the
card, in chip_smoke.py's run_stages phase.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(args, **kw):
    return subprocess.run(args, capture_output=True, text=True, cwd=REPO, env=CPU_ENV,
                          timeout=300, **kw)


# --------------------------------------------------------------- eval_accuracy


def test_eval_accuracy_matches_jax_script(tmp_path):
    """An accuracy log with qsl_idx out of order and an empty token
    sequence, a manifest with one utterance over max_duration: the JAX
    script and the port's module print the same line and write byte-equal
    hypotheses logs."""
    from rnnt_inference_tpu_torch.runtime.harness import tokens_to_hex
    from rnnt_inference_tpu_torch.utils.labels import sen_to_seq

    hyps = ["the cat sat", "", "a dog's day", "on the mat", "seven rivers"]
    refs = ["the cat sat", "an empty one", "a dog day", "on a mat", "seven quiet rivers"]
    log = [{"qsl_idx": i, "data": tokens_to_hex(np.asarray(sen_to_seq(hyps[i]), np.int32))}
           for i in (3, 0, 4, 1, 2)]
    (tmp_path / "acc.json").write_text(json.dumps(log))
    manifest = [{"audio_filepath": f"u{i}.wav", "duration": 2.0 + i, "transcript": r}
                for i, r in enumerate(refs)]
    manifest.insert(2, {"audio_filepath": "long.wav", "duration": 16.5,
                        "transcript": "too long to score"})
    (tmp_path / "m.json").write_text(json.dumps(manifest))
    outs = {}
    port = [sys.executable, "-m", "rnnt_inference_tpu_torch.tools.eval_accuracy"]
    for name, cmd in (("jax", [sys.executable, "eval_accuracy.py"]), ("port", port)):
        r = _run(cmd + ["--log_path", str(tmp_path / "acc.json"), "--manifest_path",
                        str(tmp_path / "m.json"), "--hypotheses_out",
                        str(tmp_path / f"{name}.log")])
        assert r.returncode == 0, r.stderr
        outs[name] = r.stdout
    assert outs["port"] == outs["jax"] and outs["port"].startswith("Word Error Rate: ")
    got, want = (tmp_path / "port.log").read_bytes(), (tmp_path / "jax.log").read_bytes()
    assert got == want and got.startswith(b"0::the cat sat\n1::\n")


def test_eval_accuracy_agrees_with_the_in_run_scorer(tmp_path, capsys):
    """The tool's WER is runtime/harness.py eval_accuracy_log's."""
    from rnnt_inference_tpu_torch.data.manifest import Manifest
    from rnnt_inference_tpu_torch.runtime.harness import eval_accuracy_log, tokens_to_hex
    from rnnt_inference_tpu_torch.tools import eval_accuracy
    from rnnt_inference_tpu_torch.utils.labels import sen_to_seq

    log = [{"qsl_idx": i, "data": tokens_to_hex(np.asarray(sen_to_seq(h), np.int32))}
           for i, h in enumerate(["speech model", "reads quiet"])]
    (tmp_path / "acc.json").write_text(json.dumps(log))
    (tmp_path / "m.json").write_text(json.dumps(
        [{"audio_filepath": "a.wav", "duration": 1.0, "transcript": "speech models"},
         {"audio_filepath": "b.wav", "duration": 1.0, "transcript": "reads quiet"}]))
    wer = eval_accuracy.main(["--log_path", str(tmp_path / "acc.json"), "--manifest_path",
                              str(tmp_path / "m.json"), "--hypotheses_out",
                              str(tmp_path / "h.log")])
    refs = Manifest([str(tmp_path / "m.json")], max_duration=15.0).transcripts
    assert wer == eval_accuracy_log(str(tmp_path / "acc.json"), refs) == 0.25
    assert "Word Error Rate: 25.0%, accuracy=75.0%" in capsys.readouterr().out


# ---------------------------------------------------------------- check_calib


def _trt_cache(path):
    """A TRT MinMax cache as tests/test_misc.py builds one: input amax 5.84,
    hiddens about 0.9-1, outputs about 1 (scale = amax / 127, big-endian
    hex)."""
    hx = lambda v: struct.pack(">f", v).hex()
    vals = {"input": 5.84}
    for pre in range(2):
        vals[f"encoder.pre_rnn.lstm{pre}_hidden"] = 0.95 + 0.01 * pre
        vals[f"encoder.pre_rnn.lstm{pre}_output"] = 1.0 + 0.01 * pre
    for post in range(3):
        vals[f"encoder.post_rnn.lstm{post}_hidden"] = 0.9 + 0.01 * post
        vals[f"encoder.post_rnn.lstm{post}_output"] = 1.02 + 0.01 * post
    path.write_text("\n".join(["TRT-8001-MinMaxCalibration"]
                              + [f"{k}: {hx(v / 127.0)}" for k, v in vals.items()]))


@pytest.mark.parametrize("first_amax,rc", [(5.84, 0), (50.0, 1)])
def test_check_calib_matches_jax_script(tmp_path, first_amax, rc):
    """The same cache and calibration npz (written by the JAX package's
    save_calib, as main.py saves it) through the JAX script and the port's
    module: equal stdout, and exit code 0 in range, 1 out of range."""
    from rnnt_inference_tpu.models.checkpoint import save_calib
    from rnnt_inference_tpu.models.quant import CalibState

    _trt_cache(tmp_path / "nv.cache")
    save_calib(str(tmp_path / "calib.npz"), CalibState(
        pre_amax=np.array([first_amax, max(1.0, 0.96)]),
        post_amax=np.array([max(1.01, 0.9), max(1.02, 0.91), max(1.03, 0.92)])))
    args = ["--cache", str(tmp_path / "nv.cache"), "--calib", str(tmp_path / "calib.npz"),
            "--rtol", "0.05"]
    jax_run = _run([sys.executable, "scripts/check_calib.py"] + args)
    port_run = _run([sys.executable, "-m", "rnnt_inference_tpu_torch.tools.check_calib"] + args)
    assert jax_run.returncode == port_run.returncode == rc, (jax_run.stderr, port_run.stderr)
    assert port_run.stdout == jax_run.stdout
    assert ("OK" in port_run.stdout) == (rc == 0)


# --------------------------------------------------------------- server_probe


JAX_PROBE_KEYS = {"device_step_cadence_ms", "split_len", "slots", "ladder"}


@pytest.mark.parametrize("native", [False, True])
def test_server_probe_verdicts_match_jax(tmp_path, native):
    """The probe's library function on the CPU at the golden bundle's
    widths (int8, 8 slots), two levels of 1 s: the first held to a user.conf
    that a 1 s level can meet, the second to one that asks 10,000 queries.
    Every level's verdict dict equals the JAX package's validate_report on
    the same metrics and the same conf files, completed = issued, and the
    JSON keys are the JAX probe's plus highest_valid_qps and rules."""
    import dataclasses

    from rnnt_inference_tpu.runtime.config import TestSettings as JTestSettings
    from rnnt_inference_tpu.runtime.config import validate_report as jvalidate_report
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.config import TestSettings
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner
    from rnnt_inference_tpu_torch.tools import server_probe
    from rnnt_inference_tpu_torch.utils.golden import small_params

    torch.set_num_threads(1)
    params = dataclasses.replace(small_params(), max_res_len=64)
    confs = {}
    for qps, (min_q, latency) in {4.0: (2, 60000), 8.0: (10000, 1000)}.items():
        confs[qps] = str(tmp_path / f"user{qps:g}.conf")
        with open(confs[qps], "w") as f:
            f.write(f"rnnt.Server.min_duration = 1000\nrnnt.Server.min_query_count = {min_q}\n"
                    f"rnnt.Server.target_latency = {latency}\n")
    mlperf = os.path.join(REPO, "configs", "mlperf.conf")
    w = server_probe.probe_weights(params, "quant", "cpu")
    store = SampleStore.synthetic(n=12, seed=0, min_seconds=0.4, max_seconds=1.5,
                                  mean_seconds=0.8)
    runner = ServerRunner(w, params, slots=8, split_len=24, device="cpu")
    runner.warmup()
    out = server_probe.probe(runner, store, [4.0, 8.0], 1.0,
                             lambda q: TestSettings.from_conf(mlperf, confs[q], "rnnt", "Server"),
                             native=native, cadence_steps=2)
    line = {k: v for k, v in out.items() if k != "cadence"}
    assert set(line) == JAX_PROBE_KEYS | {"highest_valid_qps", "rules"}
    json.dumps(line)  # the printed line is JSON
    assert [lv["target_qps"] for lv in out["ladder"]] == [4.0, 8.0]
    for level, rule in zip(out["ladder"], out["rules"]):
        qps = level["target_qps"]
        assert level["clock"] == ("native" if native else "python")
        assert level["completed"] == level["issued"] >= int(qps * 1.0)
        metrics = {k: v for k, v in level.items()
                   if k not in ("result_validity", "invalid_reasons", "target_qps", "clock",
                                "launches")}
        want = jvalidate_report(JTestSettings.from_conf(mlperf, confs[qps], "rnnt", "Server"),
                                metrics)
        assert {k: level[k] for k in want} == want
        assert rule == {"target_qps": qps, "min_duration_ms": 1000.0,
                        "min_query_count": {4.0: 2, 8.0: 10000}[qps],
                        "target_latency_ms": {4.0: 60000.0, 8.0: 1000.0}[qps],
                        "target_latency_percentile": 99.0}
    assert [lv["result_validity"] for lv in out["ladder"]] == ["VALID", "INVALID"]
    assert out["highest_valid_qps"] == 4.0
    cad = out["cadence"]
    assert cad["steps"] == 2 and cad["wall_ms_per_step"] > 0
    assert cad["event_ms_per_step"] is None and cad["kernel_busy_ms_per_step"] is None
    assert cad["trace_kernels"] is None  # no trace on the CPU
    assert runner.n_active == 0 and len(runner.free_slots) == runner.slots


def test_server_probe_stops_after_the_first_invalid_level(tmp_path):
    """stop_after_invalid: the ladder ends at its first INVALID level once
    min_levels have run."""
    import dataclasses

    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.runtime.config import TestSettings
    from rnnt_inference_tpu_torch.runtime.server import ServerRunner
    from rnnt_inference_tpu_torch.tools import server_probe
    from rnnt_inference_tpu_torch.utils.golden import small_params

    torch.set_num_threads(1)
    params = dataclasses.replace(small_params(), max_res_len=64)
    runner = ServerRunner(server_probe.probe_weights(params, "bf16", "cpu"), params, slots=4,
                          split_len=24, device="cpu")
    store = SampleStore.synthetic(n=4, seed=1, min_seconds=0.4, max_seconds=0.8,
                                  mean_seconds=0.6)
    never = TestSettings(scenario="Server", min_duration_ms=1e9, min_query_count=1)
    out = server_probe.probe(runner, store, [2.0, 4.0, 8.0], 0.5, lambda q: never,
                             cadence_steps=1, stop_after_invalid=True, min_levels=2)
    assert [lv["target_qps"] for lv in out["ladder"]] == [2.0, 4.0]
    assert out["highest_valid_qps"] is None


# ----------------------------------------------------------------- run_stages

# A stand-in for ``python`` that records each call's arguments, one line per
# call, the arguments separated by \x1f; and a wget that fails (no stage
# below reaches it: SYNTHETIC_ONLY=true).
FAKE_PYTHON = """#!/bin/sh
for a in "$@"; do printf '%s\\037' "$a"; done >> "$RECORD"
printf '\\n' >> "$RECORD"
"""


def _shell_lists(tmp_path, env, script="run.sh", stdout=None):
    """The argument lists of ``python -m rnnt_inference_tpu.main`` that the
    JAX shell script builds under ``env``, with ``--platform cpu`` written as
    the port's ``--device cpu``; and every python call recorded.  The
    script's stdout is appended to ``stdout`` when a list is given."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name, body in (("python", FAKE_PYTHON), ("wget", "#!/bin/sh\nexit 1\n")):
        (bin_dir / name).write_text(body)
        (bin_dir / name).chmod(0o755)
    record = tmp_path / "record.txt"
    record.write_text("")
    full = {"PATH": f"{bin_dir}:{os.environ['PATH']}", "HOME": str(tmp_path),
            "RECORD": str(record), **env}
    r = subprocess.run(["bash", os.path.join(REPO, "scripts", script)], env=full,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    if stdout is not None:
        stdout.append(r.stdout)
    calls = [line.split("\x1f")[:-1] for line in record.read_text().splitlines()]
    mains = []
    for c in calls:
        if c[:2] == ["-m", "rnnt_inference_tpu.main"]:
            a = c[2:]
            if "--platform" in a:
                i = a.index("--platform")
                a[i] = "--device"
            mains.append(a)
    return mains, calls


def _port_lists(monkeypatch, env, command="all", aux=None):
    """The port's ``main`` argument lists under ``env``, and the stage -1
    hooks called; with ``aux`` (a dict), also the argument lists the port
    passes to data/download.py's and tools/convert_librispeech.py's
    ``main`` (both recorded, not run), under "download" and "convert"."""
    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.data import download
    from rnnt_inference_tpu_torch.tools import convert_librispeech, run_stages

    calls, hooks = [], []
    monkeypatch.setattr(cli, "main", lambda argv: calls.append(list(argv)))
    if aux is not None:
        for key, mod in (("download", download), ("convert", convert_librispeech)):
            aux[key] = []
            monkeypatch.setattr(mod, "main", lambda argv, k=key: aux[k].append(list(argv)))
    if command == "all":
        stages = run_stages.Stages()
        run_stages.run_all(env, stages, prepare=lambda e: hooks.append("prepare"),
                           gate=lambda: hooks.append("golden"))
        assert [r["argv"] for r in stages.records] == calls
    else:
        run_stages.run(command, env)
    return calls, hooks


def _files(tmp_path, *names):
    """Empty files, and directories for names that end in "/"."""
    for n in names:
        if n.endswith("/"):
            (tmp_path / n).mkdir(parents=True)
        else:
            (tmp_path / n).write_bytes(b"")


def _without(argv, flag):
    """argv with ``flag`` and its value taken out."""
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


def _expected(case, w):
    """The lists the JAX scripts build for each case (w: WORK_DIR)."""
    q = f"{w}/quick.conf"
    cl = f"{w}/quick_calib_list.txt"
    calib, quant = f"{w}/rnnt_calib.npz", f"{w}/rnnt_quant.npz"
    if case in ("stage0_fetch_fails", "stage1_corpus_absent"):
        # STAGE=0 or 1, QUICK=true, SYNTHETIC_ONLY=false, no PLATFORM: stage
        # 0 fetches nothing (run.sh:83-93), stage 1 calls the download
        # (run.sh:95-107, recorded, not run), so stage 2 finds no corpus
        # (run.sh:109-126): quick_cpu_all's lists, with no --device (no
        # PLATFORM, no --platform)
        return [_without(a, "--device") for a in _expected("quick_cpu_all", w)]
    if case.startswith("stage2_corpus"):
        # STAGE=2, both subset directories present, no QUICK: stage 2
        # converts (recorded, not run, so no TRAIN_CALIB appears), stage 3
        # calibrates on synthetic data (calibrate.sh:12-23, CALIB_LIST
        # passed where it is set), stage 5 as in stage4_model
        cal = ["--run_mode", "f32", "--calibration", "--calib_out", calib, "--synthetic", "500"]
        cal += ["--calib_list", "calib_files.txt"] if case.endswith("calib_list") else []
        return [cal, ["--run_mode", "f32", "--save_quant", "--calib_in", calib, "--quant_out",
                      quant, "--synthetic", "1"]] + _expected("stage4_model", w)[1:]
    if case == "quick_cpu_all":
        # STAGE=-1 QUICK=true PLATFORM=cpu: run.sh:43-65 (quick.conf,
        # SYNTHETIC=64, CALIB_LIST), no MODEL or TRAIN_CALIB file
        return [
            # run.sh:128-131 -> calibrate.sh:12-17 and :19-23
            ["--run_mode", "f32", "--calibration", "--calib_out", calib, "--device", "cpu",
             "--synthetic", "64", "--calib_list", cl],
            ["--run_mode", "f32", "--save_quant", "--calib_in", calib, "--quant_out", quant,
             "--device", "cpu", "--synthetic", "1"],
            # run.sh:157-158 -> run_offline.sh:19-31 (ACCURACY, PACKED=true)
            ["--scenario", "Offline", "--benchmark", "--batch_size", "256", "--split_len", "-1",
             "--output_dir", f"{w}/out/offline_acc", "--packed", "--user_conf", q, "--device",
             "cpu", "--quant_in", quant, "--synthetic", "64", "--accuracy"],
            # run.sh:162-163 (NATIVE=true)
            ["--scenario", "Offline", "--benchmark", "--batch_size", "256", "--split_len", "-1",
             "--output_dir", f"{w}/out/offline_perf", "--native_loadgen", "--user_conf", q,
             "--device", "cpu", "--quant_in", quant, "--synthetic", "64"],
            # run.sh:165-166 -> run_server.sh:19-27 (ACCURACY)
            ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
             "--response_size", "9", "--output_dir", f"{w}/out/server_acc", "--mlperf_conf",
             "configs/mlperf.conf", "--user_conf", q, "--device", "cpu", "--quant_in", quant,
             "--accuracy", "--synthetic", "64"],
            # run.sh:168-169 (NATIVE=true)
            ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
             "--response_size", "9", "--output_dir", f"{w}/out/server_perf", "--mlperf_conf",
             "configs/mlperf.conf", "--user_conf", q, "--native_loadgen", "--device", "cpu",
             "--quant_in", quant, "--synthetic", "64"],
        ]
    if case == "stage3_model_train_calib":
        # STAGE=3, MODEL and TRAIN_CALIB files present, NATIVE=false and
        # PACKED=false exported, no QUICK: run.sh:128-131 pass MODEL and
        # CALIB_FILE to calibrate.sh:12-23; stage 5 (run.sh:151-171) sees
        # no MODEL (run.sh never exports it) and inherits PACKED and NATIVE
        m, t = f"{w}/rnnt.pt", f"{w}/train-calib.npz"
        return [
            ["--run_mode", "f32", "--calibration", "--calib_out", calib, "--model", m,
             "--calib_file", t],
            ["--run_mode", "f32", "--save_quant", "--calib_in", calib, "--quant_out", quant,
             "--model", m, "--synthetic", "1"],
            ["--scenario", "Offline", "--benchmark", "--batch_size", "256", "--split_len", "-1",
             "--output_dir", f"{w}/out/offline_acc", "--no_packed", "--quant_in", quant,
             "--synthetic", "1024", "--accuracy"],
            ["--scenario", "Offline", "--benchmark", "--batch_size", "256", "--split_len", "-1",
             "--output_dir", f"{w}/out/offline_perf", "--no_packed", "--quant_in", quant,
             "--synthetic", "1024"],
            ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
             "--response_size", "9", "--output_dir", f"{w}/out/server_acc", "--mlperf_conf",
             "configs/mlperf.conf", "--user_conf", "configs/user.conf", "--quant_in", quant,
             "--accuracy", "--synthetic", "512"],
            ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
             "--response_size", "9", "--output_dir", f"{w}/out/server_perf", "--mlperf_conf",
             "configs/mlperf.conf", "--user_conf", "configs/user.conf", "--quant_in", quant,
             "--synthetic", "512"],
        ]
    if case == "stage4_model":
        # STAGE=4, MODEL present (not exported): run.sh:147-150, then stage 5
        return [
            ["--run_mode", "f32", "--save_quant", "--calib_in", calib, "--quant_out", quant,
             "--synthetic", "1", "--model", f"{w}/rnnt.pt"],
            ["--scenario", "Offline", "--benchmark", "--batch_size", "256", "--split_len", "-1",
             "--output_dir", f"{w}/out/offline_acc", "--packed", "--quant_in", quant,
             "--synthetic", "1024", "--accuracy"],
            ["--scenario", "Offline", "--benchmark", "--batch_size", "256", "--split_len", "-1",
             "--output_dir", f"{w}/out/offline_perf", "--native_loadgen", "--quant_in", quant,
             "--synthetic", "1024"],
            ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
             "--response_size", "9", "--output_dir", f"{w}/out/server_acc", "--mlperf_conf",
             "configs/mlperf.conf", "--user_conf", "configs/user.conf", "--quant_in", quant,
             "--accuracy", "--synthetic", "512"],
            ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
             "--response_size", "9", "--output_dir", f"{w}/out/server_perf", "--mlperf_conf",
             "configs/mlperf.conf", "--user_conf", "configs/user.conf", "--native_loadgen",
             "--quant_in", quant, "--synthetic", "512"],
        ]
    # STAGE=5 QUICK=true, DEV_CLEAN present, NATIVE=true and PACKED=true
    # exported, BATCH_SIZE=64: run.sh:151-171, SAMPLE_FILE=DEV_CLEAN
    d = f"{w}/dev-clean.npz"
    return [
        ["--scenario", "Offline", "--benchmark", "--batch_size", "64", "--split_len", "-1",
         "--output_dir", f"{w}/out/offline_acc", "--native_loadgen", "--packed", "--user_conf",
         q, "--quant_in", quant, "--sample_file", d, "--accuracy"],
        ["--scenario", "Offline", "--benchmark", "--batch_size", "64", "--split_len", "-1",
         "--output_dir", f"{w}/out/offline_perf", "--native_loadgen", "--packed",
         "--user_conf", q, "--quant_in", quant, "--sample_file", d],
        ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
         "--response_size", "9", "--output_dir", f"{w}/out/server_acc", "--mlperf_conf",
         "configs/mlperf.conf", "--user_conf", q, "--native_loadgen", "--quant_in", quant,
         "--accuracy", "--sample_file", d],
        ["--scenario", "Server", "--benchmark", "--server_slots", "128", "--split_len", "24",
         "--response_size", "9", "--output_dir", f"{w}/out/server_perf", "--mlperf_conf",
         "configs/mlperf.conf", "--user_conf", q, "--native_loadgen", "--quant_in", quant,
         "--sample_file", d],
    ]


def _expected_aux(case, w):
    """The argument lists of the download (run.sh:99-101, ``python -m
    rnnt_inference_tpu.data.download``) and of the conversions
    (run.sh:111-124, ``python scripts/convert_librispeech.py``)."""
    downloads, converts = [], []
    if case in ("stage0_fetch_fails", "stage1_corpus_absent"):
        downloads = [["--download_dir", f"{w}/LibriSpeech", "--subsets", "dev-clean",
                      "train-clean-100"]]
    if case.startswith("stage2_corpus"):
        corpus = f"{w}/LibriSpeech/LibriSpeech"
        converts = [["--input_dir", f"{corpus}/dev-clean", "--output", f"{w}/dev-clean.npz",
                     "--features", "--workers", "8"],
                    ["--input_dir", f"{corpus}/train-clean-100", "--output",
                     f"{w}/train-calib.npz", "--workers", "8"]]
        if case.endswith("calib_list"):
            converts[1] += ["--calib_list", "calib_files.txt"]
    return downloads, converts


CORPUS = ("LibriSpeech/LibriSpeech/dev-clean/", "LibriSpeech/LibriSpeech/train-clean-100/")


@pytest.fixture
def loopback_only(monkeypatch):
    """No proxy from the environment may take a loopback fetch off the host."""
    for k in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
              "ALL_PROXY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
SKIP_MODEL = "    no network access — skipping (runs will use random weights;"

CASES = {
    "quick_cpu_all": (dict(STAGE="-1", QUICK="true", PLATFORM="cpu"), ()),
    # the stand-in wget fails; the port's MODEL_URL is a loopback server
    # that has no such file
    "stage0_fetch_fails": (dict(STAGE="0", QUICK="true", SYNTHETIC_ONLY="false"), ()),
    "stage1_corpus_absent": (dict(STAGE="1", QUICK="true", SYNTHETIC_ONLY="false"), ()),
    "stage2_corpus": (dict(STAGE="2"), CORPUS),
    "stage2_corpus_calib_list": (dict(STAGE="2", CALIB_LIST="calib_files.txt"), CORPUS),
    "stage3_model_train_calib": (dict(STAGE="3", NATIVE="false", PACKED="false"),
                                 ("rnnt.pt", "train-calib.npz")),
    "stage4_model": (dict(STAGE="4"), ("rnnt.pt",)),
    "stage5_quick_native_packed": (dict(STAGE="5", QUICK="true", NATIVE="true", PACKED="true",
                                        BATCH_SIZE="64"), ("dev-clean.npz",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_stages_argv_match_shell_scripts(tmp_path, monkeypatch, capsys, loopback_only,
                                             case):
    """Every stage's argument list, with main.main replaced by a recorder,
    equals the list written out in _expected and the list the JAX shell
    scripts build under the same environment (run with a stand-in python);
    so do the download's and the conversions' (the port's recorded, not
    run).  Stage -1 prepares the environment and, with QUICK, runs the
    golden gate, in both.  A stage 0 whose fetch fails prints run.sh's skip
    notice in both and leaves no file at MODEL."""
    from test_torch_download import Loopback

    knobs, files = CASES[case]
    w = str(tmp_path / "work")
    os.makedirs(w)
    _files(tmp_path / "work", *files)
    (tmp_path / "empty").mkdir()
    with Loopback(tmp_path / "empty") as srv:
        env = dict(dict(SYNTHETIC_ONLY="true", TRT_CACHE=str(tmp_path / "none.cache")),
                   **knobs, WORK_DIR=w, MODEL_URL=srv.url("rnnt.pt"))
        want = _expected(case, w)
        out = []
        shell, calls = _shell_lists(tmp_path, env, stdout=out)
        aux = {}
        port, hooks = _port_lists(monkeypatch, env, aux=aux)
    assert port == want
    assert shell == want
    downloads, converts = _expected_aux(case, w)
    assert aux["download"] == downloads
    assert [c[2:] for c in calls if c[:2] == ["-m", "rnnt_inference_tpu.data.download"]] == downloads
    assert aux["convert"] == converts
    assert [c[1:] for c in calls if c[:1] == ["scripts/convert_librispeech.py"]] == converts
    fetch = int(knobs["STAGE"]) <= 0 and knobs.get("SYNTHETIC_ONLY") == "false"
    assert srv.requests == ({"/rnnt.pt": 1} if fetch else {})
    if fetch:
        assert SKIP_MODEL in out[0].splitlines() and SKIP_MODEL in capsys.readouterr().out
        assert not any((tmp_path / "work").glob("rnnt.pt*"))
    # stage -1: prepare_env.sh's python calls, then (QUICK) the golden gate
    prepared = any(c == ["-"] for c in calls)
    gated = any(c[:2] == ["-m", "pytest"] for c in calls)
    assert prepared == (knobs["STAGE"] == "-1")
    assert gated == (prepared and knobs.get("QUICK") == "true")
    assert hooks == ["prepare"] * prepared + ["golden"] * gated
    if knobs.get("QUICK") == "true":
        assert (tmp_path / "work" / "quick.conf").read_text().startswith("rnnt.*.min_duration = 0")


def test_run_stages_stage4_and_eval_take_platform(tmp_path, monkeypatch):
    """Where the JAX scripts pass no --platform (run.sh:147-150, and
    eval_model.sh:17-22), PLATFORM=cpu still reaches main as --device cpu."""
    w = str(tmp_path / "work")
    os.makedirs(w)
    port, _ = _port_lists(monkeypatch, dict(STAGE="4", PLATFORM="cpu", WORK_DIR=w,
                                             SYNTHETIC_ONLY="true"))
    shell, _ = _shell_lists(tmp_path, dict(STAGE="4", PLATFORM="cpu", WORK_DIR=w,
                                           SYNTHETIC_ONLY="true"))
    assert port[0] == shell[0] + ["--device", "cpu"]
    assert port[1:] == shell[1:]
    env = dict(PLATFORM="cpu", QUANT="q.npz", MANIFEST=str(tmp_path / "m.json"),
               OUTPUT_DIR=str(tmp_path / "eval"))
    shell, calls = _shell_lists(tmp_path, env, "eval_model.sh")
    # eval_model.sh:17-22, then its eval_accuracy.py pass (:35-38)
    assert shell == [["--scenario", "Offline", "--accuracy", "--batch_size", "128",
                      "--output_dir", str(tmp_path / "eval"), "--quant_in", "q.npz",
                      "--synthetic", "256", "--manifest", str(tmp_path / "m.json")]]
    assert calls[-1][0] == "eval_accuracy.py"
    from rnnt_inference_tpu_torch.tools import eval_accuracy, run_stages

    scored = []
    monkeypatch.setattr(eval_accuracy, "main", lambda argv: scored.append(argv))
    port, _ = _port_lists(monkeypatch, env, "eval")
    assert port == [shell[0] + ["--device", "cpu"]]
    assert scored == [calls[-1][1:]]
    assert run_stages.eval_argv(env) == port[0]


@pytest.mark.parametrize("command,script,synthetic", [("calibrate", "calibrate.sh", "500"),
                                                      ("offline", "run_offline.sh", "1024"),
                                                      ("server", "run_server.sh", "512")])
def test_run_stages_commands_match_stage_scripts(tmp_path, monkeypatch, command, script,
                                                 synthetic):
    """Each stage script alone, at its defaults and with every knob it
    reads set: the port's command builds its lists."""
    base = {}
    full = dict(MODEL="m.pt", QUANT="q.npz", SAMPLE_FILE="s.npz", CALIB_FILE="c.npz",
                CALIB_LIST="l.txt", BATCH_SIZE="32", SPLIT_LEN="12", OUTPUT_DIR="o",
                ACCURACY="true", NATIVE="true", PACKED="false", MLPERF_CONF="mp.conf",
                USER_CONF="u.conf", MANIFEST="m.json", SLOTS="16", RESPONSE_SIZE="3",
                PLATFORM="cpu", CALIB_OUT="co.npz", QUANT_OUT="qo.npz", SYNTHETIC="7")
    for env in (base, full):
        shell, _ = _shell_lists(tmp_path, env, script)
        port, _ = _port_lists(monkeypatch, env, command)
        assert port == shell
        if env is base:
            assert shell[0][shell[0].index("--synthetic") + 1] == synthetic


def test_run_stages_rejects_debug(monkeypatch):
    from rnnt_inference_tpu_torch.tools import run_stages

    with pytest.raises(SystemExit, match="DEBUG"):
        run_stages.run("offline", {"DEBUG": "pdb"})
    with pytest.raises(SystemExit, match="PLATFORM"):
        run_stages.offline_argv({"PLATFORM": "tpu"})


def test_run_stages_prepare_env_on_cpu(capsys):
    """Stage -1 with PLATFORM=cpu: no kernel built (the twins run), the
    native loadgen built with g++, FLAC round-tripped."""
    from rnnt_inference_tpu_torch.tools import run_stages

    run_stages.prepare_env({"PLATFORM": "cpu"})
    out = capsys.readouterr().out
    assert "PLATFORM=cpu: no kernel built" in out
    assert "built OK" in out and "round-trip OK" in out and out.endswith("environment ready\n")


def test_run_stages_fetch_and_convert_from_loopback(tmp_path, monkeypatch, capsys,
                                                    loopback_only):
    """Stages 0-2 for real, on the CPU, from a loopback server: a seeded
    zenodo-layout rnnt.pt at MODEL_URL, and dev-clean (8 utterances of 1-2
    s) and train-clean-100 (4) as LibriSpeech tarballs at the URLs and md5s
    of data/download.py's LIBRISPEECH_SETS (pointed at the server).  Stage
    0 fetches the checkpoint byte for byte, stage 1 each tarball once with
    its md5 checked, stage 2 converts: dev-clean.npz (and its features
    store) holds the 8 utterances bit-equal to their 16-bit samples / 2**15
    with their normalized transcripts, train-calib.npz the 3 that
    CALIB_LIST names.  The calibration and serving calls that follow (main
    recorded, not run) take rnnt.pt, train-calib.npz and dev-clean.npz.
    A second run from STAGE=0 fetches nothing."""
    from test_torch_download import Loopback, write_subset

    from rnnt_inference_tpu_torch import main as cli
    from rnnt_inference_tpu_torch.data import download
    from rnnt_inference_tpu_torch.data.dataset import SampleStore
    from rnnt_inference_tpu_torch.data.text import normalize_transcript
    from rnnt_inference_tpu_torch.models.weights import init_weights, torch_state_dict_from_weights
    from rnnt_inference_tpu_torch.tools import run_stages
    from rnnt_inference_tpu_torch.utils.golden import small_params
    from rnnt_inference_tpu_torch.utils.labels import LABELS

    src, w = tmp_path / "src", str(tmp_path / "work")
    src.mkdir()
    weights = init_weights(small_params(), torch.Generator().manual_seed(3), device="cpu")
    torch.save({"state_dict": torch_state_dict_from_weights(weights), "epoch": 0},
               src / "rnnt.pt")
    utts = {"dev-clean": write_subset(src, "dev-clean", 8, seed=1, seconds=(1.0, 2.0)),
            "train-clean-100": write_subset(src, "train-clean-100", 4, seed=2,
                                            seconds=(1.0, 2.0))}
    listed = sorted(utts["train-clean-100"])[:3]
    calib_list = tmp_path / "calibration_files.txt"
    calib_list.write_text("".join(f"LibriSpeech/train-clean-100/{u.split('-')[0]}/"
                                  f"{u.split('-')[1]}/{u}.flac\n" for u in listed))
    calls = []
    monkeypatch.setattr(cli, "main", lambda argv: calls.append(list(argv)))
    with Loopback(src) as srv:
        monkeypatch.setattr(download, "LIBRISPEECH_SETS", [
            (s, srv.url(f"{s}.tar.gz"), download.md5_checksum(str(src / f"{s}.tar.gz")))
            for s in utts])
        env = dict(STAGE="0", WORK_DIR=w, MODEL_URL=srv.url("rnnt.pt"), PLATFORM="cpu",
                   CALIB_LIST=str(calib_list), WORKERS="1", TRT_CACHE=str(tmp_path / "none"))
        run_stages.run_all(env, run_stages.Stages())
        fetched = dict(srv.requests)
        first = list(calls)
        calls.clear()
        run_stages.run_all(env, run_stages.Stages())
        again = dict(srv.requests)
    out = capsys.readouterr().out
    assert fetched == again == {"/rnnt.pt": 1, "/dev-clean.tar.gz": 1,
                                "/train-clean-100.tar.gz": 1}
    assert f"    fetched {w}/rnnt.pt" in out and f"    {w}/rnnt.pt already present" in out
    assert (tmp_path / "work" / "rnnt.pt").read_bytes() == (src / "rnnt.pt").read_bytes()
    for s in utts:
        assert download.md5_checksum(f"{w}/LibriSpeech/{s}.tar.gz") == \
            download.md5_checksum(str(src / f"{s}.tar.gz"))
    stores = {"dev-clean": SampleStore.load(f"{w}/dev-clean.npz"),
              "train-clean-100": SampleStore.load(f"{w}/train-calib.npz")}
    assert sorted(stores["train-clean-100"].names) == [f"{u}.flac" for u in listed]
    assert len(stores["dev-clean"]) == 8
    for s, store in stores.items():
        for name, x, text in zip(store.names, store.samples, store.transcripts):
            q, want_text = utts[s][name[:-len(".flac")]]
            assert x.dtype == np.float32
            np.testing.assert_array_equal(x, q.astype(np.float32) / 32768.0)
            assert text == normalize_transcript(want_text, LABELS)
    assert len(SampleStore.load(f"{w}/dev-clean-input.npz")) == 8
    assert first == calls  # the second run serves the same files
    cal = first[0]
    assert cal[cal.index("--model") + 1] == f"{w}/rnnt.pt"
    assert cal[cal.index("--calib_file") + 1] == f"{w}/train-calib.npz"
    assert cal[cal.index("--calib_list") + 1] == str(calib_list)
    assert [a[a.index("--sample_file") + 1] for a in first[2:]] == [f"{w}/dev-clean.npz"] * 4
    assert all(a[a.index("--device") + 1] == "cpu" for a in first)


def test_run_stages_golden_gate_says_when_it_does_not_run(monkeypatch, capsys):
    """Where jax does not import, the gate prints one line saying so and
    why, and runs nothing."""
    import importlib.util

    from rnnt_inference_tpu_torch.tools import run_stages

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "jax" else real(name, *a))
    monkeypatch.setattr(run_stages.subprocess, "run",
                        lambda *a, **k: pytest.fail("the gate ran without jax"))
    run_stages.golden_gate()
    assert "golden gate NOT RUN" in capsys.readouterr().out


def test_compare_fproj_lanes_on_twins():
    """tools/decode_divergence.py compare_fproj_lanes on the CPU (kernel B's
    twin): equal projections, decoded in 1 and in 3 lanes, never part and
    decode as the symbol loop does;
    a projection moved far past a summation-order difference parts, and
    not at a near-tie (its logit shift exceeds the product tie tolerance)."""
    from rnnt_inference_tpu_torch.models.decoder import greedy_decode_chunk, init_decode_state
    from rnnt_inference_tpu_torch.models.weights import init_weights
    from rnnt_inference_tpu_torch.ops import decode_cuda
    from rnnt_inference_tpu_torch.ops.lstm import dot_f32
    from rnnt_inference_tpu_torch.tools.decode_divergence import compare_fproj_lanes
    from rnnt_inference_tpu_torch.utils.golden import small_params

    params = small_params()
    w = init_weights(params, torch.Generator().manual_seed(3), dtype=torch.bfloat16, device="cpu")
    f = torch.randn((24, 1, params.trans_hidden_size), generator=torch.Generator().manual_seed(4))
    fproj = dot_f32(f.to(torch.bfloat16), w.joint.w1_trans)[:, 0]
    dw = decode_cuda.decode_weights(w)
    same = compare_fproj_lanes(fproj, fproj.clone(), 20, dw, params, lane_counts=(1, 3))
    state = greedy_decode_chunk(w, init_decode_state(1, params, torch.bfloat16, torch.bfloat16,
                                                     "cpu"), f[:20], torch.tensor([20]), params)
    want = state.res[0, : int(state.res_idx[0]) + 1].numpy()
    assert not same["parted"] and same["near_tie"] is None and len(want)
    for t in same["tokens"]:
        np.testing.assert_array_equal(t, want)
    moved = fproj + torch.randn(fproj.shape, generator=torch.Generator().manual_seed(5))
    far = compare_fproj_lanes(fproj, moved, 20, dw, params)
    assert far["parted"] and far["near_tie"] is False
    assert far["hg_drift"] == far["cg_drift"] == 0.0  # the twin at any lane count
    assert far["logit_shift"] > far["product_tie_tolerance"]
    assert far["symbols"][0] != far["symbols"][1]
    np.testing.assert_array_equal(far["tokens"][0], want)


def test_run_stages_golden_gate_raises_when_it_fails(monkeypatch, capsys):
    """A failing golden gate raises with pytest's output, and never passes
    silently."""
    import importlib.util

    from rnnt_inference_tpu_torch.tools import run_stages

    if importlib.util.find_spec("jax") is None:  # the gate would print NOT RUN
        monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: object())
    monkeypatch.setattr(run_stages.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a[0], 1, stdout="1 failed\n", stderr="boom"))
    with pytest.raises(RuntimeError, match="golden gate failed"):
        run_stages.golden_gate()
    assert "1 failed" in capsys.readouterr().out
