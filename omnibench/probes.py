"""What a run records: the benchmark's own spans around calls into the
program's layers, the program's counters, and a profiler slice.

Spans wrap the program's objects from outside (instance attributes that
shadow a method), record host clock times and, on the card, a pair of
CUDA events on the calling thread's current stream, which inside
``AREngine.step`` is the engine's own.  No span synchronises: the events
are read once the run is over.  Only a runner with a page pool
(``PagedRunner``) is wrapped; the readers of its spans read nothing in a
run whose runners keep no paged KV (``StateRunner``).

The token stamps, one per streamed token as the router hands it to the
request (``Orchestrator._route``), are what the end-to-end metrics are
taken from; they are recorded in every run, and so is the most KV each
engine held (``KvPeak``).  The runner and connector spans and the
profiler are recorded only with ``--trace 1``.
"""
from __future__ import annotations

import json
from collections import deque
import os
import pathlib
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch


@dataclass
class Span:
    kind: str                 # prefill_chunk | decode | extract_kv | inject_kv | send | recv
    engine: str
    t0: float                 # host clock at the call
    t1: float                 # host clock at the return
    events: Optional[tuple] = None       # CUDA start/end events
    meta: dict = field(default_factory=dict)
    device_s: Optional[float] = None     # start event to end event, once resolved

    @property
    def host_s(self) -> float:
        return self.t1 - self.t0

    @property
    def seconds(self) -> float:
        """Device span where there is one (the call's start to its last
        kernel's end on its stream), the host span otherwise."""
        return self.device_s if self.device_s is not None else self.host_s


class Recorder:
    """Installs the wrappers and keeps what they record."""

    def __init__(self, output_stage: str, cuda: bool):
        self.output_stage = output_stage
        self.cuda = cuda
        # (host time, req_id, tokens) per streamed chunk; appended by the
        # router thread, taken from the left by the main thread
        self.stamps: deque = deque()
        self.spans: list = []
        self._undo: list = []

    # ---- installation ------------------------------------------------------
    def _shadow(self, obj, name: str, wrapper) -> None:
        setattr(obj, name, wrapper)
        self._undo.append(lambda: delattr(obj, name))

    def watch_tokens(self, orch) -> None:
        orig = orch._route
        stage = self.output_stage

        def route(ev):
            orig(ev)
            if ev.kind == "chunk" and ev.stage == stage:
                self.stamps.append((time.perf_counter(), ev.req_id,
                                    len(ev.payload["tokens"])))

        self._shadow(orch, "_route", route)

    def watch_layers(self, orch, engines: dict) -> None:
        for name, eng in engines.items():
            runner = eng.runner
            if not has_pool(runner):
                continue
            for kind in ("prefill_chunk", "decode", "extract_kv", "inject_kv"):
                self._shadow(runner, kind, self._timed(kind, name, getattr(runner, kind)))
        for kind, conn in orch.connectors.items():
            for op in ("send", "recv"):
                self._shadow(conn, op, self._timed(op, kind, getattr(conn, op),
                                                   device=False))

    def _timed(self, kind: str, engine: str, fn, device: bool = True):
        use_events = device and self.cuda

        def call(*args, **kwargs):
            span = Span(kind, engine, time.perf_counter(), 0.0, meta=_meta(kind, args))
            if use_events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            try:
                return fn(*args, **kwargs)
            finally:
                if use_events:
                    ev[1].record()
                    span.events = ev
                span.t1 = time.perf_counter()
                self.spans.append(span)

        return call

    def uninstall(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def resolve(self) -> None:
        """Read the CUDA events (after the card has finished)."""
        for s in self.spans:
            if s.events is not None:
                s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
                s.events = None


def _meta(kind: str, args: tuple) -> dict:
    """The host-side shape of a call, from its arguments."""
    if kind == "prefill_chunk":
        return {"start": int(args[2]), "valid": int(args[3])}
    if kind == "decode":
        positions = np.asarray(args[2], np.int64)
        active = np.asarray(args[3], bool)
        return {"contexts": (positions[active] + 1).tolist()}
    return {}


def has_pool(runner) -> bool:
    """Whether the runner keeps its KV in a page pool."""
    return getattr(runner, "k_pages", None) is not None


class KvPeak:
    """The most pages of its KV pool each engine held at once, from the
    pool's free list (read without a lock, as the router's own probe
    does), beside the pages reserved.  An engine whose runner has no
    page pool is named with nothing to read."""

    def __init__(self, engines: dict):
        self.allocs = {}
        self.page_bytes = {}
        self.peak = {}
        self.pool_less = []
        for name, eng in engines.items():
            runner = eng.runner
            if not has_pool(runner):
                self.pool_less.append(name)
                continue
            alloc = eng.scheduler.allocator
            self.allocs[name] = alloc
            self.page_bytes[name] = (runner.k_pages.nbytes + runner.v_pages.nbytes) // alloc.num_pages
            self.peak[name] = 0

    def sample(self) -> None:
        for name, alloc in self.allocs.items():
            held = alloc.num_pages - alloc.free_pages
            if held > self.peak[name]:
                self.peak[name] = held

    def summary(self) -> dict:
        """Per engine: pages and bytes held at the peak, and reserved; None
        for an engine with no page pool."""
        out: dict = {name: None for name in self.pool_less}
        out.update({name: {"peak_pages": self.peak[name], "pages": a.num_pages,
                           "peak_bytes": self.peak[name] * self.page_bytes[name],
                           "reserved_bytes": a.num_pages * self.page_bytes[name]}
                    for name, a in self.allocs.items()})
        return out


# ---------------------------------------------------------------------------
# profiler slice
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host calls that each launch one kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
#: host events looked at, backwards from a gap's middle, for one still running
SCAN_BACK = 64


@dataclass
class Profile:
    """What a profiled slice of the window shows."""
    window_s: float
    t0: float                     # host clock at the slice's start and end
    t1: float
    busy_s: float                 # union of device-op intervals
    op_seconds: dict              # device op name -> seconds
    op_counts: dict               # device op name -> launches
    kernels: int                  # kernels the device recorded
    launches: int                 # kernel launches the host recorded
    idle_gaps: list               # (host activity, seconds) of every gap

    @property
    def complete(self) -> bool:
        """Whether the device's records hold the kernels the host launched:
        CUPTI has dropped every kernel record of a slice (the MoE cell), and
        the kernel records of one engine's thread (the PD cell), keeping the
        host's launch calls."""
        return self.kernels > 0 and self.kernels >= self.launches / 2


class Profiler:
    """torch.profiler over a slice of the window.  ``warm`` runs it once
    during set-up, so that starting it inside the window is quick; the
    trace is exported, parsed and its file removed in ``finish``, after
    the window."""

    def __init__(self, trace_dir: pathlib.Path):
        self.trace_dir = trace_dir
        self.prof = None
        self.t0 = self.t1 = None
        self.result: Optional[Profile] = None

    def _open(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def warm(self) -> None:
        prof = self._open()
        torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum().item()
        prof.__exit__(None, None, None)

    def start(self) -> None:
        self.prof = self._open()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def finish(self) -> None:
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        path = self.trace_dir / "profile.json"
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        self.result = summarize(trace, self.t1 - self.t0, self.t0, self.t1)
        self.prof = None


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(trace: Any, window_s: float, t0: float, t1: float) -> Profile:
    """Device time by op, busy time and the idle gaps labelled with the
    host's innermost activity at each gap's middle (microsecond times)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, host = [], []
    op_seconds: dict = {}
    op_counts: dict = {}
    kernels = launches = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((a, b))
            name = e.get("name", "?")
            op_seconds[name] = op_seconds.get(name, 0.0) + float(e["dur"]) / 1e6
            op_counts[name] = op_counts.get(name, 0) + 1
            kernels += cat == "kernel"
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            name = e.get("name", "?")
            host.append((a, b, name))
            launches += name.startswith(LAUNCH_CALLS)
    merged = _union(dev)
    busy = sum(b - a for a, b in merged) / 1e6
    return Profile(window_s, t0, t1, busy, op_seconds, op_counts, kernels, launches,
                   _label_gaps(merged, host))


def _latest_covering(starts: np.ndarray, ends: np.ndarray, names: list, t: float,
                     default: str) -> str:
    """The name of the event that started last among those running at t."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - SCAN_BACK, -1), -1):
        if ends[j] >= t:
            return names[j]
    return default


def _label_gaps(merged: list, host: list) -> list:
    """Every idle gap between device ops, labelled with the host op (an
    operator or a CUDA runtime or driver call, on any thread) that had
    started last among those running at the gap's middle; "python" where
    none was: the host was running Python between ops."""
    evts = sorted(host)
    starts = np.array([e[0] for e in evts])
    ends = np.array([e[1] for e in evts])
    names = [e[2] for e in evts]
    out = []
    for i in range(len(merged) - 1):
        a, b = merged[i][1], merged[i + 1][0]
        out.append((_latest_covering(starts, ends, names, (a + b) / 2, "python"),
                    (b - a) / 1e6))
    return out
