"""Arithmetic the metric readers (``metrics/<name>.py``) share."""
from __future__ import annotations

import math
from types import ModuleType
from typing import Optional

from omnibench import counts, spec, stats


def spans(measured, kind: str, engine: Optional[str] = None) -> list:
    """The run's spans of ``kind`` (of ``engine``) that started in the window."""
    return [s for s in measured.spans if s.kind == kind and measured.in_window(s.t0)
            and (engine is None or s.engine == engine)]


def idle_pct(measured) -> Optional[float]:
    """Share of the profiled slice in which no device op ran."""
    p = measured.profile
    if p is None or not p.complete:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def per_request_tpot_s(measured, r) -> float:
    """Mean gap between a request's streamed tokens: over its whole answer
    in an open loop (inf if it failed or never finished), over the tokens
    that arrived inside the window in a closed loop (nan with fewer than two)."""
    if measured.window.loop == "open":
        if r.failed or not r.done or r.n_tokens < 2:
            return math.inf
        pts = r.stamps
    else:
        pts = [(t, n) for t, n in r.stamps if measured.in_window(t)]
        if sum(n for _, n in pts) < 2:
            return math.nan
    n = sum(n for _, n in pts)
    return (pts[-1][0] - pts[0][0]) / (n - 1)


def family(measured) -> ModuleType:
    """The cell's architecture family (``families/<family>.py``)."""
    return spec.family(measured.cell.family)


def decode_bound_s(measured, contexts, routed_experts=None) -> float:
    """The least time of a decode step whose active rows hold ``contexts``
    tokens, by the family's counts (``routed_experts``: distinct experts
    per MoE layer)."""
    return counts.bound_s(*family(measured).decode_step(measured.model, contexts,
                                                        routed_experts))


def pct_finite(values, p: float) -> Optional[float]:
    vals = [v for v in values if not math.isnan(v)]
    return stats.pct(vals, p) if vals else None
