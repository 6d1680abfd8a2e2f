"""Serving metrics: JCT / TTFT / throughput summaries over completed
requests (the quantities the paper's §4 tables report)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.request import Request


def _pct(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) if xs else float("nan")


def summarize(requests: List[Request], wall_time: Optional[float] = None,
              audio_frames: Optional[int] = None,
              frame_seconds: float = 0.02) -> Dict[str, float]:
    jcts = [r.jct for r in requests if r.jct is not None]
    ttfts = [r.first_output_time - r.arrival_time for r in requests
             if r.first_output_time is not None]
    out = {
        "n": len(requests),
        "jct_mean": float(np.mean(jcts)) if jcts else float("nan"),
        "jct_p50": _pct(jcts, 50),
        "jct_p95": _pct(jcts, 95),
        "ttft_p50": _pct(ttfts, 50),
        "ttft_p95": _pct(ttfts, 95),
    }
    if wall_time:
        out["req_per_s"] = len(jcts) / wall_time
    if audio_frames:
        out["rtf_mean"] = out["jct_mean"] / (audio_frames * frame_seconds)
    return out


def summarize_queueing(requests: List[Request]) -> Dict[str, Dict[str, float]]:
    """Per-stage queueing delay (submit -> engine admission) percentiles
    over a set of requests — the §3.1 disaggregation win shows up here:
    a slow stage's queue grows while other stages' delays stay flat."""
    per_stage: Dict[str, List[float]] = {}
    for r in requests:
        for stage, delays in r.queue_delays.items():
            per_stage.setdefault(stage, []).append(float(sum(delays)))
    return {stage: {
        "mean": float(np.mean(ds)),
        "p50": _pct(ds, 50),
        "p95": _pct(ds, 95),
        "max": float(np.max(ds)),
    } for stage, ds in per_stage.items()}


def _report_row(label: str, m: Dict[str, float], cols: List[str]) -> str:
    cells = []
    for c in cols:
        v = m.get(c, 0)
        cells.append((f"{v:.4f}" if isinstance(v, float)
                      else str(v)).rjust(18))
    return label.ljust(12) + "".join(cells)


def stage_report(stage_metrics: Dict[str, Dict[str, float]]) -> str:
    """Render Orchestrator.stage_metrics() as an aligned text table.
    Multi-replica stages get one aggregate row plus an indented
    ``stage/<rid>`` sub-row per replica (retired ids keep their row —
    their counters are still part of the aggregate)."""
    cols = ["admitted", "finished", "steps", "busy_time", "busy_frac",
            "finished_per_s", "queue_delay_p50", "queue_delay_p95",
            "max_inbox_depth"]
    if any("prefix_hit_rate" in m for m in stage_metrics.values()):
        cols += ["cached_tokens", "computed_tokens", "full_block_tokens",
                 "partial_tokens", "prefix_hit_rate"]
    # only widen the table when a process replica actually died
    if any(m.get("replica_failures") for m in stage_metrics.values()):
        cols += ["replica_failures"]
    head = "stage".ljust(12) + "".join(c.rjust(18) for c in cols)
    lines = [head]
    for stage, m in stage_metrics.items():
        lines.append(_report_row(stage, m, cols))
        for rid, rm in sorted(m.get("replicas", {}).items()):
            mark = "" if rm.get("live") else " (retired)"
            lines.append(_report_row(f" {stage}/{rid}{mark}", rm, cols))
    return "\n".join(lines)
