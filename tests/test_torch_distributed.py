"""The port's multi-process serving (parallel/distributed.py and
tools/multihost_probe.py) on the CPU: a real 2-process torch.distributed
group over gloo, as tests/test_distributed.py runs a 2-process
jax.distributed cluster, and the probe's per-rank serves against a
single-process run on the same indices.

Tolerance: indices, merged reports and tokens equal.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rnnt_inference_tpu.parallel.distributed import host_shard_indices as jhost_shard_indices
from rnnt_inference_tpu_torch.parallel import distributed as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, os.environ["RNNT_REPO"])
    import numpy as np
    from rnnt_inference_tpu_torch.parallel.distributed import (
        all_hosts_report, host_shard_indices, initialize, process_count, process_index,
    )

    pid = int(os.environ["PROC_ID"])
    initialize(os.environ["COORD"], 2, pid, backend="gloo")
    assert process_count() == 2 and process_index() == pid

    lengths = np.arange(11) * 7 % 11  # deterministic, distinct
    mine = host_shard_indices(11, lengths)
    print("SHARD", pid, ",".join(map(str, sorted(mine.tolist()))), flush=True)

    local = dict(audio_seconds_per_second=100.0 * (pid + 1), samples=5 * (pid + 1))
    merged = all_hosts_report(local)
    print("MERGED", pid, merged["audio_seconds_per_second"], merged["samples"],
          merged["hosts"], flush=True)
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group(tmp_path):
    """A real 2-process gloo group: initialize, host_shard_indices (a
    disjoint cover of range(11)) and all_hosts_report (both ranks see
    300.0, 15, 2 hosts), 120 s per process."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, RNNT_REPO=REPO, COORD=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen([sys.executable, str(script)], env=dict(env, PROC_ID=str(pid)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    shards, merged = {}, {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SHARD"):
                _, pid, idxs = line.split(" ")
                shards[int(pid)] = [int(v) for v in idxs.split(",")]
            if line.startswith("MERGED"):
                _, pid, aps, n, hosts = line.split(" ")
                merged[int(pid)] = (float(aps), int(n), int(hosts))
    assert sorted(shards[0] + shards[1]) == list(range(11))
    assert not set(shards[0]) & set(shards[1])
    # the striping of the JAX package: order[rank::world]
    order = np.argsort(-(np.arange(11) * 7 % 11))
    assert shards == {0: sorted(order[0::2].tolist()), 1: sorted(order[1::2].tolist())}
    for pid in (0, 1):
        assert merged[pid] == (300.0, 15, 2)


@pytest.mark.parametrize("lengths", [[5, 3, 9, 1, 7], [4, 4, 2, 8, 8, 1, 0]])
def test_host_shard_indices_single_process_matches_jax(lengths):
    """One process: the JAX package's striping (the whole length-sorted
    order); with no group, all_hosts_report returns the report as it is."""
    got = tdist.host_shard_indices(len(lengths), np.asarray(lengths))
    np.testing.assert_array_equal(got, jhost_shard_indices(len(lengths), np.asarray(lengths)))
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    local = {"audio_seconds_per_second": 1.5, "samples": 3}
    assert tdist.all_hosts_report(local) is local
    np.testing.assert_array_equal(tdist.all_gather_floats([1.0, 2.0]), [[1.0, 2.0]])


def test_initialize_one_process_is_a_noop():
    tdist.initialize("127.0.0.1:1", 1, 0)
    tdist.initialize()
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert tdist.local_devices() == [tdist.torch.device("cpu")]
    assert tdist.local_data_mesh().shape == {"data": 1, "model": 1}


def test_multihost_probe_ranks_match_single_process(tmp_path):
    """tools/multihost_probe.py with 2 gloo ranks on the CPU: the ranks'
    indices cover the store without overlap, the merged report is the sum
    of the ranks', and each rank's tokens equal a single-process run of
    the same int8 model on the same indices."""
    import torch

    from rnnt_inference_tpu_torch.config import FeaturizerConfig
    from rnnt_inference_tpu_torch.runtime.harness import hex_to_tokens, run_offline
    from rnnt_inference_tpu_torch.tools import multihost_probe as probe

    torch.set_num_threads(1)
    n = 11
    rep = probe.run_cluster(2, n, batch=4, hidden=64, device="cpu", backend="gloo",
                            out_dir=str(tmp_path), min_s=0.0, timeout=120)
    ranks = rep["ranks"]
    idx = [r["indices"] for r in ranks]
    assert sorted(idx[0] + idx[1]) == list(range(n)) and not set(idx[0]) & set(idx[1])
    assert rep["hosts"] == 2 and rep["samples"] == sum(r["samples"] for r in ranks) == n
    assert rep["audio_seconds_per_second"] == pytest.approx(
        sum(r["audio_seconds_per_second"] for r in ranks), rel=1e-12)
    assert 0 < rep["load_balance_efficiency"] <= 1

    params = probe.probe_params(64)
    w = probe.probe_weights(params, "cpu")
    store = probe.probe_store(n)
    for r, mine in enumerate(idx):
        with open(tmp_path / f"rank{r}" / "accuracy_log.json") as f:
            got = [hex_to_tokens(e["data"]) for e in json.load(f)]
        single = run_offline(w, store.select(mine), params, FeaturizerConfig(), batch_size=4,
                             warmup=False, device="cpu", output_dir=str(tmp_path / f"one{r}"))
        with open(tmp_path / f"one{r}" / "accuracy_log.json") as f:
            want = [hex_to_tokens(e["data"]) for e in json.load(f)]
        assert len(got) == len(want) == len(mine)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
        assert single.hypotheses
