"""Where one K-iteration launch of kernel B parts from K iterations of its
twin, and why, on the card.

    python -m rnnt_inference_tpu_torch.tools.decode_divergence [--n 64 1024]

From random lane states at full width (P = 320, J = 512; the card tests'
cases, ``decode_case``, seeds 12 and 21), one launch of K = 64 iterations
(the symbol loop's K) and K twin iterations are compared, in the bucketed
mode and in packed mode with the budget gate off and at 4.  The kernel is launched again from the
same state with 1, 2, ... K iterations (it sums in a fixed order, so a
launch of k iterations repeats the first k of a longer one; the script
checks that two launches of K agree bit for bit), and every lane is
traced to the first iteration where it parts from the twin.  There, on
the state both reached before it, a lane reports

  twin_symbol, kernel_symbol   what each chose
  gap                 the twin's logit of its symbol minus its logit of the
                      kernel's symbol, on the twin's own state
  margin              the twin's top-two logit gap there
  twin_on_kernel_state the twin's argmax on the kernel's state
  logit_shift         max |twin logits on the kernel's state - on its own|
  hg_drift, cg_drift  max |kernel - twin| of the lane's h and c

A lane parts where its lane row (the step's symbol included), tokens or
res_base first differ, also where the end shows no trace of it (an
emission held by the budget or dropped past R changes only h and c).  It
parts at a near-tie when the symbols differ there, its drift is within
kernel B's per-step tolerances (bf16: hg 2**-8, cg 1e-3; f32: 1e-5) and
the twin, given the kernel's state, chooses the kernel's symbol: the
kernel computed the right function of a state within tolerance, and the
runs part only because the twin's own choice was that close.  Any other
parting is a fault.  Lanes that never part report their end drift, which
must be within the same tolerances.  Prints one JSON object per case and
exits 1 if any case holds a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import RNNTParams
from rnnt_inference_tpu_torch.models.decoder import DEFAULT_STEPS_PER_CHECK
from rnnt_inference_tpu_torch.models.weights import init_weights
from rnnt_inference_tpu_torch.ops import decode_cuda as dc


def tolerances(wdtype: torch.dtype):
    """Kernel B's per-step tolerances (hg, cg) for a weight type."""
    return (2 ** -8, 1e-3) if wdtype == torch.bfloat16 else (1e-5, 1e-5)


def decode_case(dev, wdtype, N, P=320, J=512, seed=12, packed=False):
    """Full-width decode weights and N lanes in random states over T2 = 6
    frames: (params, dw, fproj, [lanes, hg, cg, res]) and, with packed,
    also starts (utterance starts on about half the frames) and res_base
    (each lane's current utterance begun 0-9 tokens before its res_idx)."""
    params = RNNTParams(trans_hidden_size=256, pred_hidden_size=P, joint_hidden_size=J,
                        max_res_len=128)
    w = init_weights(params, torch.Generator().manual_seed(seed), dtype=wdtype, device=dev)
    dw = dc.decode_weights(w)
    T2, L, R = 6, params.pred_num_layers, params.max_res_len
    rng = np.random.RandomState(seed)
    f_lens = rng.randint(0, T2 + 1, N)
    eos = np.maximum(f_lens - 1, 0)
    lanes = np.stack([
        rng.randint(-1, 28, N), np.minimum(rng.randint(0, T2, N), eos),
        rng.choice([0, 3, 30], N), rng.choice([-1, 5, R - 1], N), f_lens == 0,
        f_lens, eos, np.zeros(N),
    ]).astype(np.int32)
    fproj = torch.from_numpy(rng.randn(T2, N, J).astype(np.float32)).to(dev)
    hg = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev, wdtype)
    cg = torch.from_numpy(rng.randn(L, N, P).astype(np.float32) * 0.5).to(dev)
    res = torch.full((N, R), -1, dtype=torch.int8, device=dev)
    case = (params, dw, fproj, [torch.from_numpy(lanes).to(dev), hg, cg, res])
    if not packed:
        return case
    rng = np.random.RandomState(seed + 1)
    starts = rng.rand(T2, N) < 0.5
    starts[0] = True
    rb = np.maximum(lanes[dc.RES_IDX] - rng.randint(0, 10, N), -1)
    return case + (torch.from_numpy(starts).to(dev),
                   torch.from_numpy(rb.astype(np.int32)).to(dev))


def _snap(state, rb):
    return [t.clone() for t in state] + [None if rb is None else rb.clone()]


def _differs(a, b):
    """(N,) bool: the lanes whose lane row, res row or res_base differ."""
    d = (a[0] != b[0]).any(0) | (a[3] != b[3]).any(1)
    return d if a[4] is None else d | (a[4] != b[4])


def compare_k_launch(fproj, state, dw, params: RNNTParams, K: int,
                     starts: Optional[torch.Tensor] = None, res_base: Optional[torch.Tensor] = None,
                     utt_budget: int = 0) -> dict:
    """One K-iteration launch of kernel B against K twin iterations from
    ``state`` (left as it is): the report described in the module's
    docstring."""
    wdt = dw.embed.dtype
    tol_h, tol_c = tolerances(wdt)
    packed = dict(starts=starts, utt_budget=utt_budget) if starts is not None else {}

    def kernel(k):
        s = _snap(state, res_base)
        dc.decode_step_cuda(fproj, *s[:4], dw, params, k, res_base=s[4], **packed)
        return s

    twin = [_snap(state, res_base)]
    for _ in range(K):
        s = _snap(twin[-1][:4], twin[-1][4])
        dc.decode_step_reference(fproj, *s[:4], dw, params, res_base=s[4], **packed)
        twin.append(s)
    full, again = kernel(K), kernel(K)
    deterministic = all(x is None or torch.equal(x, y) for x, y in zip(full, again))
    # a lane parts at the first iteration after which its lane row (the
    # step's symbol included), tokens or res_base differ, even where that
    # leaves no trace at the end (an emission over the budget or past R)
    first = {}
    prev = _snap(state, res_base)
    for k in range(1, K + 1):
        cur = full if k == K else kernel(k)
        for n in torch.nonzero(_differs(cur, twin[k])).flatten().tolist():
            first.setdefault(n, (k, prev, cur))
        prev = cur
    kept = torch.ones(fproj.shape[1], dtype=torch.bool, device=fproj.device)
    kept[list(first)] = False
    drift_h = (full[1].float() - twin[K][1].float()).abs().amax(dim=(0, 2))
    drift_c = (full[2] - twin[K][2]).abs().amax(dim=(0, 2))
    report = dict(
        N=int(fproj.shape[1]), K=K, weights=str(wdt).replace("torch.", ""),
        mode="bucketed" if starts is None else f"packed, budget {utt_budget}",
        deterministic=deterministic, lanes_parted=len(first),
        lanes_differing_at_end=int(_differs(full, twin[K]).sum()),
        end_hg_drift_kept_lanes=float(drift_h[kept].max()) if kept.any() else 0.0,
        end_cg_drift_kept_lanes=float(drift_c[kept].max()) if kept.any() else 0.0,
        end_worst_kept_lane=int(torch.argmax(torch.where(kept, drift_c, -1.0))),
        lanes=[],
    )
    report["end_drift_within_tolerance"] = (report["end_hg_drift_kept_lanes"] <= tol_h
                                            and report["end_cg_drift_kept_lanes"] <= tol_c)
    for n, (k, kb, ka) in sorted(first.items()):  # the kernel's state before and after k
        tb = twin[k - 1]
        lt = dc.decode_logits_reference(fproj, tb[0], tb[1], tb[2], dw, params)[0][n]
        lk = dc.decode_logits_reference(fproj, kb[0], kb[1], kb[2], dw, params)[0][n]
        ts, ks = int(twin[k][0][dc.SYMBOL, n]), int(ka[0][dc.SYMBOL, n])
        top2 = torch.topk(lt, 2).values
        hd = float((kb[1][:, n].float() - tb[1][:, n].float()).abs().max())
        cd = float((kb[2][:, n] - tb[2][:, n]).abs().max())
        tk = int(torch.argmax(lk))
        report["lanes"].append(dict(
            lane=n, iteration=k, twin_symbol=ts, kernel_symbol=ks,
            gap=float(lt[ts] - lt[ks]), margin=float(top2[0] - top2[1]),
            twin_on_kernel_state=tk, logit_shift=float((lk - lt).abs().max()),
            hg_drift=hd, cg_drift=cd, differs_at_end=bool(_differs(full, twin[K])[n]),
            near_tie=bool(hd <= tol_h and cd <= tol_c and tk == ks and ts != ks)))
    report["faults"] = (sum(not r["near_tie"] for r in report["lanes"])
                        + (not report["end_drift_within_tolerance"]) + (not deterministic))
    return report


def run_case(dev, wdtype, N, seed, mode, K=DEFAULT_STEPS_PER_CHECK) -> dict:
    """compare_k_launch on decode_case's lanes; mode "bucketed", or the
    packed mode's utt_budget (0: the gate off)."""
    if mode == "bucketed":
        params, dw, fproj, state = decode_case(dev, wdtype, N, seed=seed)
        return compare_k_launch(fproj, state, dw, params, K)
    params, dw, fproj, state, starts, rb = decode_case(dev, wdtype, N, seed=seed, packed=True)
    return compare_k_launch(fproj, state, dw, params, K, starts, rb, mode)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1024], help="lane counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_divergence: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    faults = 0
    for N in args.n:
        for seed in (12, 21):
            for wdt in (torch.bfloat16, torch.float32):
                for mode in ("bucketed", 0, 4):
                    r = run_case(dev, wdt, N, seed, mode)
                    faults += r["faults"]
                    print(json.dumps(dict(seed=seed, **r)), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
