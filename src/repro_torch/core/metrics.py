"""Serving metrics: JCT / TTFT / throughput summaries over completed
requests (the quantities the paper's §4 tables report), and the tracer
of the AR engine's step.

The tracer
----------
``AREngine.step`` runs under a ``StepTrace``: the step and its phases
(``engine.schedule``, ``engine.admit``, ``engine.prefill``,
``engine.decode_inputs``, ``model.decode``, ``engine.sample``,
``engine.emit``) follow one another, each phase closed and the next
opened at one read of ``time.perf_counter()``, the clock of
``Request``'s stamps and of ``torch.profiler``'s host events.  Every
device->host read the engine and its runner make goes through
``to_cpu``, which times and counts it on the step (``wait_s``,
``syncs``) or, outside a step, on what ``reads_into`` names.  The
decode layer loop's host time (``attn_host_s``, ``ffn_host_s``) reaches
the ``model.decode`` phase through ``note``, and so does each prefill
chunk of a model with Mamba layers to ``engine.prefill``: ``mamba_resets``
(it began a prompt from a zero state) or ``mamba_carries`` (it went on
from the state the chunk before left); device tensors a phase
made, read only once the work is over, reach its span through ``keep``
(``routed_experts``, the distinct experts a decode step routed to).

Costs are clock reads: no CUDA event, no synchronisation, no lock.  The
engine's cumulative counters (``StepTotals``: seconds per phase, the
step's and ``enqueue``'s reads) are kept always, as ``busy_time`` is.
With ``enabled`` true (the default) each step that did work also
appends its ``Span`` records to ``spans``, a bounded deque (appending
is atomic in CPython; the oldest spans go first), and while a
``torch.profiler`` runs, the step and each phase open a
``record_function`` range of the same name, so that the profiler's
trace shows them as ``user_annotation`` events on its own clock.
``enabled`` is a switch for tests and for measuring the tracer's cost.

Spans live in the process whose engine recorded them: a spawned
(``isolation="process"``) engine keeps its spans and counters in its
child.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

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


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

#: record spans and profiler ranges (the engine's counters are kept either way)
enabled = True
#: the most spans kept
MAX_SPANS = 1 << 16
#: every engine's spans, oldest first
spans: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()      # .step: the StepTrace this thread runs; .reads


@dataclass
class Span:
    """One timed piece of an engine's work on ``time.perf_counter()``."""
    name: str
    engine: str
    t0: float
    t1: float
    id: int
    parent: int = 0                     # the enclosing span's id; 0: none
    req_id: Optional[int] = None
    counts: Dict[str, float] = field(default_factory=dict)
    #: device tensors the phase kept (``keep``): reading one waits for the device
    kept: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Reads:
    """Device->host reads: how many, and the host time they blocked."""
    __slots__ = ("syncs", "wait_s")

    def __init__(self) -> None:
        self.syncs = 0
        self.wait_s = 0.0


def to_cpu(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """``t`` on the host.  From a device this waits for the kernels that
    make ``t``: the read is timed and counted on this thread's step, or on
    the ``Reads`` that ``reads_into`` names."""
    t0 = time.perf_counter()
    out = t.to("cpu", copy=copy)
    reads = getattr(_local, "reads", None)
    if reads is not None:
        reads.wait_s += time.perf_counter() - t0
        reads.syncs += 1
    return out


class reads_into:
    """Count this thread's ``to_cpu`` reads on ``reads`` inside the block."""
    __slots__ = ("reads", "outer")

    def __init__(self, reads: Reads) -> None:
        self.reads = reads

    def __enter__(self) -> Reads:
        self.outer = getattr(_local, "reads", None)
        _local.reads = self.reads
        return self.reads

    def __exit__(self, *exc) -> None:
        _local.reads = self.outer


def note(**counts: float) -> None:
    """Add ``counts`` to the running phase of this thread's step, if any."""
    step = getattr(_local, "step", None)
    if step is not None:
        step.note(counts)


def keeping() -> bool:
    """Whether this thread runs a step phase whose span will be recorded."""
    step = getattr(_local, "step", None)
    return enabled and step is not None and step._phase is not None


def keep(**tensors: torch.Tensor) -> None:
    """Keep ``tensors`` on the span of the running phase of this thread's
    step, if one will be recorded (``keeping``)."""
    if keeping():
        _local.step._phase[4].update(tensors)


def _range(name: str):
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class StepTotals:
    """One engine's cumulative counters: seconds of each step phase (and
    the counts its phases noted, as ``<phase>.<count>``), the reads of
    the steps that did work, and the reads of ``enqueue``."""

    def __init__(self) -> None:
        self.phase_s: Dict[str, float] = {}
        self.step_reads = Reads()
        self.enqueue_reads = Reads()

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.phase_s)
        out.update(step_syncs=self.step_reads.syncs, step_wait_s=self.step_reads.wait_s,
                   enqueue_syncs=self.enqueue_reads.syncs,
                   enqueue_wait_s=self.enqueue_reads.wait_s)
        return out


class StepTrace:
    """One engine step, on the engine's thread: the step from creation to
    ``finish``, its phases one after another (``first`` opened with the
    step), and its device->host reads.
    The engine sets ``worked`` once the step has work; a step without
    work leaves no span and adds nothing to the totals."""
    __slots__ = ("engine", "totals", "t0", "reads", "worked", "counts", "_phase",
                 "_closed", "_ranges", "_outer")

    def __init__(self, engine: str, totals: StepTotals,
                 first: Optional[str] = None) -> None:
        self.engine = engine
        self.totals = totals
        self.reads = Reads()
        self.worked = False
        self.counts: Dict[str, float] = {}
        self._phase: Optional[list] = None       # [name, t0, req_id, counts, kept]
        self._closed: list = []
        self._outer = (getattr(_local, "step", None), getattr(_local, "reads", None))
        _local.step, _local.reads = self, self.reads
        self._ranges = ([_range("engine.step")] if enabled
                        and _autograd_profiler._is_profiler_enabled else None)
        self.t0 = time.perf_counter()
        if first is not None:                   # opened at the step's own start
            self._phase = [first, self.t0, None, {}, {}]
            if self._ranges is not None:
                self._ranges.append(_range(first))

    def phase(self, name: Optional[str], req_id: Optional[int] = None) -> float:
        """Close the running phase and open ``name`` (None: none) at one
        clock read; returns the closed phase's seconds (0.0: none ran)."""
        t = time.perf_counter()
        done = self._close(t)
        if name is not None:
            self._phase = [name, t, req_id, {}, {}]
            if self._ranges is not None:
                self._ranges.append(_range(name))
        return done

    def _close(self, t: float) -> float:
        ph = self._phase
        if ph is None:
            return 0.0
        self._phase = None
        self._closed.append((ph[0], ph[1], t, ph[2], ph[3], ph[4]))
        if self._ranges is not None and len(self._ranges) > 1:
            self._ranges.pop().__exit__(None, None, None)
        return t - ph[1]

    def note(self, counts: Dict[str, float]) -> None:
        ph = self._phase
        if ph is not None:
            c = ph[3]
            for k, v in counts.items():
                c[k] = c.get(k, 0) + v

    def finish(self) -> float:
        """End the step: its seconds if it did work, else 0.0."""
        t1 = time.perf_counter()
        self._close(t1)
        _local.step, _local.reads = self._outer
        if self._ranges is not None:
            for rf in reversed(self._ranges):
                rf.__exit__(None, None, None)
        if not self.worked:
            return 0.0
        tot = self.totals
        for name, a, b, _, counts, _kept in self._closed:
            tot.phase_s[name] = tot.phase_s.get(name, 0.0) + (b - a)
            for k, v in counts.items():
                key = f"{name}.{k}"
                tot.phase_s[key] = tot.phase_s.get(key, 0.0) + v
        tot.step_reads.syncs += self.reads.syncs
        tot.step_reads.wait_s += self.reads.wait_s
        if enabled:
            sid = next(_ids)
            out = [Span("engine.step", self.engine, self.t0, t1, sid,
                        counts={"syncs": self.reads.syncs, "wait_s": self.reads.wait_s,
                                **self.counts})]
            out += [Span(name, self.engine, a, b, next(_ids), sid, rid, counts, kept)
                    for name, a, b, rid, counts, kept in self._closed]
            spans.extend(out)
        return t1 - self.t0
