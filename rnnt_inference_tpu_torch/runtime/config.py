"""mlperf.conf / user.conf style test settings (a copy of
rnnt_inference_tpu/runtime/config.py).

Parses the loadgen config format — lines of `model.scenario.key = value`
with `*` wildcards, user.conf overlaying mlperf.conf — the same two-file
layering the reference applies via TestSettings::FromConfig
(reference: csrc/main.cpp:108-115, configs/mlperf.conf, configs/user.conf).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


def parse_conf(path: str) -> Dict[Tuple[str, str, str], float]:
    """Parse one conf file -> {(model, scenario, key): value}."""
    out: Dict[Tuple[str, str, str], float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            lhs, rhs = (s.strip() for s in line.split("=", 1))
            parts = lhs.split(".")
            if len(parts) != 3:
                continue
            model, scenario, key = parts
            try:
                value = float(rhs)
            except ValueError:
                continue
            out[(model, scenario, key)] = value
    return out


def lookup(
    conf: Dict[Tuple[str, str, str], float], model: str, scenario: str, key: str
) -> Optional[float]:
    """Wildcard-aware lookup: exact > model.* > *.scenario > *.*"""
    for m, s in ((model, scenario), (model, "*"), ("*", scenario), ("*", "*")):
        if (m, s, key) in conf:
            return conf[(m, s, key)]
    return None


@dataclasses.dataclass
class TestSettings:
    scenario: str = "Offline"
    target_qps: float = 1.0
    target_latency_ms: float = 1000.0
    target_latency_percentile: float = 99.0
    min_duration_ms: float = 600000.0
    min_query_count: int = 1
    performance_sample_count: int = 2513
    samples_per_query: int = 1

    @classmethod
    def from_conf(
        cls,
        mlperf_conf: Optional[str],
        user_conf: Optional[str],
        model: str = "rnnt",
        scenario: str = "Offline",
    ) -> "TestSettings":
        merged: Dict[Tuple[str, str, str], float] = {}
        if mlperf_conf:
            merged.update(parse_conf(mlperf_conf))
        if user_conf:
            merged.update(parse_conf(user_conf))  # user.conf overlays

        def g(key, default):
            # explicit None check: a conf value of 0 (e.g. min_duration = 0
            # in a user.conf) is a legitimate setting, not "use the default"
            v = lookup(merged, model, scenario, key)
            return default if v is None else v

        pct = lookup(merged, model, scenario, "target_latency_percentile")
        return cls(
            scenario=scenario,
            target_qps=g("target_qps", 1.0),
            target_latency_ms=g("target_latency", 1000.0),
            target_latency_percentile=pct if pct is not None else 99.0,
            min_duration_ms=g("min_duration", 600000.0),
            min_query_count=int(g("min_query_count", 1)),
            performance_sample_count=int(
                g("performance_sample_count_override", 2513)
            ),
            samples_per_query=int(g("samples_per_query", 1)),
        )


def validate_report(settings: TestSettings, report: dict) -> dict:
    """Append a loadgen-style VALID/INVALID verdict to a run report
    (the pass/fail block of mlperf_log_summary; reference: loadgen rules
    applied via configs/mlperf.conf — Server gates on target_latency at
    target_latency_percentile, every scenario gates on min_duration and
    min_query_count).

    `report` needs: completed, wall_seconds, and latency_ms_p{50,90,99} for
    latency-bound scenarios.  Returns a new dict with `result_validity` and
    `invalid_reasons` added.
    """
    reasons = []
    completed = report.get("completed", report.get("samples", 0))
    wall = report.get("wall_seconds", 0.0)
    if completed < settings.min_query_count:
        reasons.append(
            f"min_query_count not met: {completed} < {settings.min_query_count}"
        )
    if wall * 1e3 < settings.min_duration_ms:
        reasons.append(
            f"min_duration not met: {wall*1e3:.0f} ms < {settings.min_duration_ms:.0f} ms"
        )
    if settings.scenario in ("Server", "SingleStream"):
        if report.get("completed_live", completed) == 0:
            reasons.append(
                "no live (non-deferred) completions in the measured window"
            )
        pct = settings.target_latency_percentile
        key = f"latency_ms_p{int(pct)}"
        lat = report.get(key)
        if lat is None or lat != lat:  # missing or NaN
            reasons.append(f"missing {key} in report")
        elif settings.scenario == "Server" and lat > settings.target_latency_ms:
            reasons.append(
                f"p{int(pct)} latency {lat:.1f} ms > target "
                f"{settings.target_latency_ms:.0f} ms"
            )
    out = dict(report)
    out["result_validity"] = "VALID" if not reasons else "INVALID"
    out["invalid_reasons"] = reasons
    return out
