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

compare_run_launches does the same for every launch of a whole run (a
runner's run_device), and counts a second kind of tie: a parting from
the same state whose twin gap is within the product tie tolerance.
compare_tp_run_launches does it for every call of a tensor-parallel run
(parallel/tensor.py): each call's k ranks (kernel B's rank mode, or the
plain one) against the one-device twin on the joined state.
summed_in_halves gives a second plain version of the twin, summing in
another order, to measure how far two plain versions part on a model.
compare_fproj_lanes finds where two decodes of one utterance part when
their joint projection and lane count differ (two runs that batch it
differently), and whether that is a near-tie.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Callable, Optional

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
                     utt_budget: int = 0, run_k: Optional[Callable] = None) -> dict:
    """One K-iteration launch of kernel B against K twin iterations from
    ``state`` (left as it is): the report described in the module's
    docstring.  ``run_k(s, k)`` replaces the launch: k iterations of the
    path under test on the state list s ([lanes, hg, cg, res]), in place."""
    wdt = dw.embed.dtype
    tol_h, tol_c = tolerances(wdt)
    packed = dict(starts=starts, utt_budget=utt_budget) if starts is not None else {}

    def kernel(k):
        s = _snap(state, res_base)
        if run_k is not None:
            run_k(s, k)
        else:
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


def product_tie_tolerance(wdtype: torch.dtype) -> float:
    """The largest twin logit gap at which kernel B may choose the other
    symbol from the same state: its products sum in another order than the
    twin's, and in bf16 one flipped rounding of the joint's hidden z moves
    a logit by about |w2| ulp(z) (0.044 x 2**-9 at full width)."""
    return 1e-4 if wdtype == torch.bfloat16 else 1e-5


@contextlib.contextmanager
def summed_in_halves():
    """Inside the block, kernel B's twin sums each product's K terms in two
    halves: a second plain version of the same function that differs from
    the twin only in summation order, to measure how far two plain
    versions part on a given model."""
    plain = dc.dot_f32

    def halves(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        k = a.shape[-1] // 2
        return (torch.matmul(a[..., :k].float(), b[:k].float())
                + torch.matmul(a[..., k:].float(), b[k:].float()))

    dc.dot_f32 = halves
    try:
        yield
    finally:
        dc.dot_f32 = plain


def compare_run_launches(run: Callable[[], object]) -> dict:
    """Calls ``run()`` (for example a runner's run_device on the card) with
    every kernel-B launch it makes first compared with K twin iterations
    from the state that launch starts from (compare_k_launch; the run goes
    on along the kernel's own states).  Returns (run's result, summary):
    the launches compared, the lanes that parted in each, how many of
    those partings were near-ties and how many product ties (drift within
    tolerance, the twin on the kernel's state keeps its own symbol, and its
    logit gap within product_tie_tolerance: the two sums of the same
    products rank the two symbols apart), the largest gap and logit shift
    at a parting, the largest end drift of the lanes that did not part,
    and the faults (any other parting, a launch that does not repeat bit
    for bit, an end drift out of tolerance)."""
    from rnnt_inference_tpu_torch.models import decoder

    reports, tie = [], {}
    launch = decoder.dc.decode_step

    def compared(fproj, lanes, hg, cg, res, dw, params, steps=1, impl=None, starts=None,
                 res_base=None, utt_budget=0):
        if impl is None and lanes.is_cuda:
            reports.append(compare_k_launch(fproj, [lanes, hg, cg, res], dw, params, steps,
                                            starts, res_base, utt_budget))
            tie["tolerances"] = tolerances(dw.embed.dtype)
            tie["gap"] = product_tie_tolerance(dw.embed.dtype)
        launch(fproj, lanes, hg, cg, res, dw, params, steps, impl, starts=starts,
               res_base=res_base, utt_budget=utt_budget)

    decoder.dc.decode_step = compared
    try:
        result = run()
    finally:
        decoder.dc.decode_step = launch
    return result, _summary(reports, tie)


def _summary(reports, tie) -> dict:
    """compare_run_launches' summary of the launches' reports."""
    parted = [lane for r in reports for lane in r["lanes"]]
    tol_h, tol_c = tie.get("tolerances", (0.0, 0.0))
    for lane in parted:
        lane["product_tie"] = bool(
            not lane["near_tie"] and lane["twin_symbol"] != lane["kernel_symbol"]
            and lane["hg_drift"] <= tol_h and lane["cg_drift"] <= tol_c
            and lane["twin_on_kernel_state"] == lane["twin_symbol"]
            and abs(lane["gap"]) <= tie["gap"])
    unexplained = [lane for lane in parted if not (lane["near_tie"] or lane["product_tie"])]
    return dict(
        launches=len(reports), lanes_parted=len(parted),
        near_ties=sum(lane["near_tie"] for lane in parted),
        product_ties=sum(lane["product_tie"] for lane in parted),
        product_tie_tolerance=tie.get("gap"),
        lanes_parted_by_launch=[r["lanes_parted"] for r in reports],
        max_gap=max((abs(lane["gap"]) for lane in parted), default=0.0),
        logit_shift_range=[min((lane["logit_shift"] for lane in parted), default=0.0),
                           max((lane["logit_shift"] for lane in parted), default=0.0)],
        gap_under_shift=sum(abs(lane["gap"]) <= lane["logit_shift"] for lane in parted),
        end_hg_drift_kept_lanes=max((r["end_hg_drift_kept_lanes"] for r in reports),
                                    default=0.0),
        end_cg_drift_kept_lanes=max((r["end_cg_drift_kept_lanes"] for r in reports),
                                    default=0.0),
        faults=len(unexplained) + sum((not r["end_drift_within_tolerance"])
                                      + (not r["deterministic"]) + (not r.get("ranks_equal", True))
                                      for r in reports),
        partings_unexplained=unexplained[:20],
    )


def joined_decode_weights(dws) -> dc.DecodeWeights:
    """The one-device DecodeWeights of k model ranks' slices
    (parallel/mesh.py join_units / join_columns), on rank 0's device."""
    from rnnt_inference_tpu_torch.parallel.mesh import join_columns, join_units

    dev = dws[0].w2.device
    units = lambda name: join_units([getattr(d, name).to(dev) for d in dws]).contiguous()
    cols = lambda name: join_columns([getattr(d, name).to(dev) for d in dws]).contiguous()
    return dc.DecodeWeights(embed=dws[0].embed, w_ih=units("w_ih"), w_hh=units("w_hh"),
                            b=units("b"), w1p=cols("w1p"), b1=cols("b1"), w2=dws[0].w2,
                            b2=dws[0].b2)


def compare_tp_call(fproj, lanes, hg, cg, res, dws, params: RNNTParams, K: int,
                    impl: Optional[str] = None, step: Optional[Callable] = None) -> dict:
    """One tensor-parallel call of K iterations (ops/decode_cuda.py
    decode_step_tp on the k ranks' lists, left as they are) against K
    iterations of the one-device twin from the joined state (rank 0's
    lanes, hg and tokens, the ranks' cg and fproj columns joined, the
    weights joined): compare_k_launch's report.  The ranks' copies of the
    lane state must stay equal: ``ranks_equal`` says whether they did.
    ``step`` is the decode_step_tp to run (that function by default)."""
    step = step or dc.decode_step_tp
    k, dev = len(lanes), lanes[0].device
    fp = torch.cat([f.to(dev) for f in fproj], dim=-1)
    state = [lanes[0], hg[0], torch.cat([c.to(dev) for c in cg], dim=-1), res[0]]
    Pl = cg[0].shape[-1]
    equal = []

    def run_k(s, steps):
        ln = [s[0].to(t.device).clone() for t in lanes]
        h = [s[1].to(t.device).clone() for t in hg]
        c = [s[2][..., r * Pl:(r + 1) * Pl].to(t.device).contiguous() for r, t in enumerate(cg)]
        rs = [s[3].to(t.device).clone() for t in res]
        step(fproj, ln, h, c, rs, dws, params, steps, impl)
        equal.append(all(torch.equal(a.to(dev), b) for xs in (ln, h, rs) for a, b in
                         zip(xs[1:], [xs[0]] * (k - 1))))
        s[0].copy_(ln[0])
        s[1].copy_(h[0])
        s[2].copy_(torch.cat([t.to(dev) for t in c], dim=-1))
        s[3].copy_(rs[0])

    report = compare_k_launch(fp, state, joined_decode_weights(dws), params, K, run_k=run_k)
    report["ranks_equal"] = all(equal)
    report["faults"] += not report["ranks_equal"]
    return report


def compare_tp_run_launches(run: Callable[[], object]) -> dict:
    """``compare_run_launches`` for a tensor-parallel run: calls ``run()``
    (for example parallel/tensor.py greedy_decode_tp on a mesh) with every
    decode_step_tp call it makes first compared with the one-device twin
    from the same joined state (``compare_tp_call``).  Returns (run's
    result, summary) as compare_run_launches."""
    reports, tie = [], {}
    launch = dc.decode_step_tp

    def compared(fproj, lanes, hg, cg, res, dws, params, steps=1, impl=None):
        reports.append(compare_tp_call(fproj, lanes, hg, cg, res, dws, params, steps, impl,
                                       launch))
        tie["tolerances"] = tolerances(dws[0].embed.dtype)
        tie["gap"] = product_tie_tolerance(dws[0].embed.dtype)
        launch(fproj, lanes, hg, cg, res, dws, params, steps, impl)

    dc.decode_step_tp = compared
    try:
        result = run()
    finally:
        dc.decode_step_tp = launch
    return result, _summary(reports, tie)


def _one_lane(fproj: torch.Tensor, f_len: int, n: int, dw: dc.DecodeWeights,
              params: RNNTParams):
    """An n-lane decode state from SOS whose lane 0 decodes ``fproj`` (T2,
    J) for f_len frames; the other lanes are finished (f_len 0)."""
    dev, (T2, J) = fproj.device, fproj.shape
    fp = torch.zeros((T2, n, J), dtype=fproj.dtype, device=dev)
    fp[:, 0] = fproj
    f_lens = torch.zeros((n,), dtype=torch.int32, device=dev)
    f_lens[0] = f_len
    lanes = torch.zeros((dc.N_LANE_ROWS, n), dtype=torch.int32, device=dev)
    lanes[dc.PRE_G] = params.SOS
    lanes[dc.RES_IDX] = -1
    lanes[dc.FINISH] = (f_lens == 0).int()
    lanes[dc.F_LENS] = f_lens
    lanes[dc.EOS] = torch.clamp(f_lens - 1, min=0)
    L, P = params.pred_num_layers, params.pred_hidden_size
    return [fp, lanes, torch.zeros((L, n, P), dtype=dw.embed.dtype, device=dev),
            torch.zeros((L, n, P), dtype=torch.float32, device=dev),
            torch.full((n, params.max_res_len), -1, dtype=torch.int8, device=dev)]


def compare_fproj_lanes(fproj_a: torch.Tensor, fproj_b: torch.Tensor, f_len: int,
                        dw: dc.DecodeWeights, params: RNNTParams, lane_counts=(1, 1),
                        impl: Optional[str] = None) -> dict:
    """Two decodes of one utterance from the same encoder output, as two runs
    that batch it differently make them: decode a projects it as
    ``fproj_a`` (T2, J) and runs it as lane 0 of ``lane_counts[0]`` lanes,
    decode b with ``fproj_b`` in ``lane_counts[1]`` lanes.  The projection's products, and
    kernel B's, may sum in an order that depends on the batch's shape.  Both
    run in lockstep, one kernel-B launch of one iteration each (the twin for
    CPU tensors or impl="reference").  The prediction net's state follows
    the symbols emitted, so until the decodes part their time is equal and
    their h and c differ by rounding alone.  At the first iteration after
    which their lane rows differ: both symbols, the twin's gap there (on
    decode a's state and input, its logit of a's symbol minus b's), the
    logit shift (max |twin logits on a's input - on b's|), the frame's
    fproj drift and the h and c drift before the iteration.  The parting is
    a near-tie when the symbols differ, the drift is within kernel B's
    per-step tolerances (``tolerances``), the shift within the product tie
    tolerance (the inputs differ as two summation orders do) and |gap|
    within that tolerance plus the shift.  Both decodes run to their end;
    returns their tokens too."""
    sides = [_one_lane(fp, f_len, n, dw, params)
             for fp, n in ((fproj_a, lane_counts[0]), (fproj_b, lane_counts[1]))]
    rows = [dc.PRE_G, dc.TIME, dc.SYMADD, dc.RES_IDX, dc.FINISH]
    tol = product_tie_tolerance(dw.embed.dtype)
    tol_h, tol_c = tolerances(dw.embed.dtype)
    out = dict(parted=False, near_tie=None, lane_counts=list(lane_counts))
    for it in range(fproj_a.shape[0] * (params.max_symbols_per_step + 1) + 1):
        if all(bool(sd[1][dc.FINISH].all()) for sd in sides):
            break
        before = [t[:, :1].clone() for t in sides[0][1:4]]  # lane 0's lanes, hg, cg
        hb, cb = sides[1][2][:, :1].clone(), sides[1][3][:, :1].clone()
        for fp, ln, hg, cg, res in sides:
            dc.decode_step(fp, ln, hg, cg, res, dw, params, 1, impl)
        a, b = sides[0][1][rows, 0], sides[1][1][rows, 0]
        if out["parted"] or torch.equal(a, b):
            continue
        ln0, hg0, cg0 = before
        fp2 = torch.stack([fproj_a, fproj_b], dim=1).contiguous()
        logits, _, _ = dc.decode_logits_reference(fp2, ln0.expand(-1, 2).contiguous(),
                                                  hg0.expand(-1, 2, -1).contiguous(),
                                                  cg0.expand(-1, 2, -1).contiguous(), dw, params)
        sym = [int(sides[0][1][dc.SYMBOL, 0]), int(sides[1][1][dc.SYMBOL, 0])]
        t = int(ln0[dc.TIME, 0])
        shift = float((logits[0] - logits[1]).abs().max())
        gap = float(logits[0, sym[0]] - logits[0, sym[1]])
        hd = float((hg0.float() - hb.float()).abs().max())
        cd = float((cg0 - cb).abs().max())
        out.update(parted=True, iteration=it, frame=t, symbols=sym, gap=gap, logit_shift=shift,
                   fproj_drift=float((fproj_a[t] - fproj_b[t]).abs().max()), hg_drift=hd,
                   cg_drift=cd, product_tie_tolerance=tol,
                   near_tie=bool(sym[0] != sym[1] and hd <= tol_h and cd <= tol_c
                                 and shift <= tol and abs(gap) <= tol + shift))
    out["tokens"] = []
    for _, ln, _, _, res in sides:
        n = min(int(ln[dc.RES_IDX, 0]) + 1, params.max_res_len)
        out["tokens"].append(res[0, :n].cpu().numpy().astype(np.int32))
    return out


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
