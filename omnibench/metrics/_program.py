"""What the metric readers of the program's own spans share: the spans
that ``repro_torch.core.metrics`` recorded in this process, of the
output stage's engine, that started in the window.

A program without that tracer (an older checkout) has no spans to give:
every reader then returns None.  The readers of host time leave out
spans that overlap the profiled slice, whose profiler slows the host."""
from __future__ import annotations


def recorded() -> list:
    """Every span the program's tracer holds; [] without a tracer."""
    try:
        from repro_torch.core import metrics
        return list(metrics.spans)
    except (ImportError, AttributeError):
        return []


def _stage(measured):
    return measured.records[0].stage if measured.records else None


def in_slice(measured, s) -> bool:
    """Whether span ``s`` overlaps the profiled slice."""
    p = measured.profile
    return p is not None and s.t0 < p.t1 and s.t1 > p.t0


def spans(measured, name: str, slice_too: bool = False) -> list:
    """The output stage's spans called ``name`` that started in the
    window, outside the profiled slice unless ``slice_too``."""
    stage = _stage(measured)
    return [s for s in recorded() if s.name == name and s.engine == stage
            and measured.in_window(s.t0) and (slice_too or not in_slice(measured, s))]


def mean_ms(values: list):
    return 1e3 * sum(values) / len(values) if values else None
