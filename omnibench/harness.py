"""One run of one cell: set-up, the measured window, the check, the result.

``run.py`` calls ``main``.  The run:

1. reads the cell from ``BENCHMARK.json`` and the files it names, and
   stops (exit 1, no result) without as many cards as the cell asks for;
2. draws the weights on the card from ``--seed`` in the layout of the
   configuration's family (``families/<family>.py``), builds
   the cell's graph from the port's parts (``graphs/<graph>.py``) and
   its threaded ``Orchestrator`` through ``ServeConfig``;
3. warms up with two requests of its own through the same entry (the
   shapes are fixed by the configuration: every prefill chunk is padded
   to the chunk size, every decode step runs ``max_batch`` rows), then
   starts the traffic: an open loop's pre-roll, or a closed loop's
   clients, which start before the window so that the batch is full
   when it opens;
4. measures for ``--seconds``: requests go in through
   ``Orchestrator.submit``; each streamed token is stamped as the
   router hands it to its request, and finished requests show on
   ``Request.completion_time`` (``Orchestrator.completions``' stamp);
5. after the window: an open loop's requests due in it are followed to
   their end (arrivals go on meanwhile), the card's peak memory is read,
   the program is stopped and freed, and the plain reference judges a
   sample of the served requests (``judge.py``, through the family's
   plain reference);
6. prints the metrics of ``--trace 0`` (end to end) or ``--trace 1``
   (per layer) as the last line of standard output.

Two modes outside the run contract share the same set-up: ``--sweep``
(the knee of an open-loop cell) and ``--calibrate`` (the readings that
a cell's limits are set from, with the lower-precision control).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from omnibench import judge, probes, spec, stats
from omnibench.traffic import Traffic

#: seconds of the window the profiler covers in a traced run, at most
PROFILE_S = 5.0
#: longest the clients' ramp may take before a closed loop's window opens
RAMP_LIMIT_S = 240.0
WARM_PROMPT, WARM_OUT = 80, 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def card(chips: int) -> dict:
    """The card's name, count and power limit; raises without enough cards."""
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false: this benchmark runs on the card")
    n = torch.cuda.device_count()
    if n < chips:
        raise RunError(f"the cell asks for {chips} cards, {n} are visible")
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        limit = out[0].split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"kind": torch.cuda.get_device_name(0), "count": chips, "power_limit": limit}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

@dataclass
class System:
    graph_mod: object
    orch: object
    engines: dict
    params: dict


def build(cell: spec.Cell, seed: int, device, model: dict, serve: dict) -> System:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.orchestrator import Orchestrator

    cfg = ModelConfig(**model)
    params = spec.family(cell.family).program_params(model, seed, device)
    graph_mod = spec.load_module("graphs", cell.config["graph"])
    graph, engines = graph_mod.build(cfg, params, serve, seed)
    orch = Orchestrator(graph, engines, config=ServeConfig(backend="threaded"))
    return System(graph_mod, orch, engines, params)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass
class Record:
    """One request the run sent: when it was due, what it asked for, and
    the host time and size of each piece of its answer as it arrived."""
    req: object
    due: float                     # host clock: the instant it was due
    sent: float                    # host clock: when submit was called
    out_len: int
    counted: bool
    stage: str                     # the output stage, whose chunks are the answer
    stamps: list = field(default_factory=list)     # (host time, tokens)

    @property
    def n_tokens(self) -> int:
        return sum(n for _, n in self.stamps)

    @property
    def done(self) -> bool:
        return self.req.completion_time is not None

    @property
    def failed(self) -> bool:
        return self.req.failed is not None

    def served(self) -> list:
        out = self.req.outputs.get(self.stage, [])
        return [int(t) for chunk in out for t in np.asarray(chunk["tokens"]).ravel()]


class Sender:
    """Submits requests and keeps their records."""

    def __init__(self, sys_: System, rec: probes.Recorder):
        self.sys = sys_
        self.rec = rec
        self.records: dict = {}
        self.stage = sys_.graph_mod.OUTPUT_STAGE
        self.kv = probes.KvPeak(sys_.engines)

    def send(self, tokens: np.ndarray, out_len: int, due: float, counted: bool) -> Record:
        from repro_torch.core.request import Request
        req = Request(inputs={"tokens": tokens},
                      sampling={"max_new_tokens": out_len, "temperature": 0.0})
        req.arrival_time = due
        r = Record(req, due, time.perf_counter(), out_len, counted, self.stage)
        self.records[req.req_id] = r
        self.sys.orch.submit(req)
        return r

    def collect(self) -> None:
        """File the token stamps recorded so far under their requests."""
        stamps = self.rec.stamps
        while stamps:
            t, rid, n = stamps.popleft()
            r = self.records.get(rid)
            if r is not None:
                r.stamps.append((t, n))


def warm_up(sys_: System, sender: Sender, seed: int, vocab: int) -> None:
    """Two requests through the whole graph before anything is measured:
    the kernels build and load, and every shape of the cell runs once."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 99]))
    now = time.perf_counter()
    warm = [sender.send(rng.integers(0, vocab, WARM_PROMPT, dtype=np.int32),
                        WARM_OUT, now, counted=False) for _ in range(2)]
    while not all(r.done for r in warm):
        _check_alive(sys_)
        time.sleep(0.01)
    failed = [r.req.failed for r in warm if r.failed]
    if failed:
        raise RunError(f"warm-up request failed: {failed[0]}")
    for r in warm:
        del sender.records[r.req.req_id]


def _check_alive(sys_: System) -> None:
    err = sys_.orch.worker_error
    if err:
        raise RunError(f"stage worker died: {err}")


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

@dataclass
class Window:
    t_open: float
    t_close: float
    loop: str
    lateness: list
    profile: Optional[probes.Profile] = None


class _ProfileSlot:
    """Profiles the last ``PROFILE_S`` seconds of the window (a third of a
    short one).  The profiler stops, and its trace is read, as the window
    closes: turning its events into a trace holds the interpreter for
    seconds, which inside the window would stall the engines' threads.
    A slice whose device records miss most of the kernels the host
    launched (``Profile.complete``) is profiled once more, right after
    the window, with the traffic going on."""

    def __init__(self, profiler: Optional[probes.Profiler], seconds: float):
        self.p = profiler
        self.length = min(PROFILE_S, seconds / 3)
        self.start_at = seconds - self.length
        self.stop_at = None
        self.state = 0
        self.retried = False

    def tick(self, now: float, t_open: Optional[float], t_close: Optional[float]) -> None:
        if self.p is None or t_open is None:
            return
        if self.state == 0 and now >= t_open + self.start_at:
            self.p.start()
            self.stop_at = t_close
            self.state = 1
        elif self.state == 1 and now >= self.stop_at:
            self.p.stop()
            self.p.finish()
            self.state = 2
            r = self.p.result
            if not r.complete and not self.retried:
                log(f"the profiler recorded {r.kernels} kernels for {r.launches} launches "
                    f"in the slice: profiling once more")
                self.retried = True
                self.p.start()
                self.stop_at = time.perf_counter() + self.length
                self.state = 1


def drive_open(sys_: System, sender: Sender, traffic: Traffic, seconds: float,
               grace: float, slot: _ProfileSlot) -> Window:
    """Arrivals at their due instants (stamped with the due instant, not
    when the loop noticed them), from the pre-roll on; after the window,
    arrivals go on until every request due in it has finished, or
    ``grace`` seconds have passed."""
    arrivals = traffic.arrivals()
    nxt = next(arrivals)
    pre = float(traffic.spec.get("pre_s", 0.0))
    t_open = time.perf_counter() + pre + 0.05
    t_close = t_open + seconds
    lateness = []
    counted = []
    while True:
        now = time.perf_counter()
        while t_open + nxt.due <= now:
            r = sender.send(nxt.tokens, nxt.out_len, t_open + nxt.due, counted=nxt.cycle == 1)
            lateness.append(r.sent - r.due)
            if r.counted:
                counted.append(r)
            nxt = next(arrivals)
            now = time.perf_counter()
        slot.tick(now, t_open, t_close)
        sender.kv.sample()
        _check_alive(sys_)
        if now >= t_close and slot.state != 1:
            if now >= t_close + grace or (counted and all(r.done for r in counted)
                                          and len(counted) == traffic.window_count):
                break
        time.sleep(max(0.0, min(0.002, t_open + nxt.due - time.perf_counter())))
    return Window(t_open, t_close, "open", lateness)


def drive_closed(sys_: System, sender: Sender, traffic: Traffic, seconds: float,
                 slot: _ProfileSlot) -> Window:
    """``clients`` clients, each sending its next request when its last
    one has come back; the window opens once every client's first
    request is being served (its first token arrived)."""
    n = int(traffic.spec["clients"])
    streams = [traffic.client(c) for c in range(n)]
    live = {}
    t0 = time.perf_counter()
    for c in range(n):
        it = next(streams[c])
        live[c] = sender.send(it.tokens, it.out_len, t0, counted=False)
    t_open = t_close = None
    while True:
        now = time.perf_counter()
        sender.collect()
        if t_open is None and all(r.stamps for r in live.values()):
            t_open, t_close = now, now + seconds
        if t_open is None and now - t0 > RAMP_LIMIT_S:
            raise RunError(f"the clients' first tokens took over {RAMP_LIMIT_S} s")
        for c, r in list(live.items()):
            if r.done and (t_close is None or now < t_close or slot.state == 1):
                it = next(streams[c])
                live[c] = sender.send(it.tokens, it.out_len, r.req.completion_time,
                                      counted=False)
        slot.tick(now, t_open, t_close)
        sender.kv.sample()
        _check_alive(sys_)
        if t_close is not None and now >= t_close and slot.state != 1:
            break
        time.sleep(0.002)
    for r in sender.records.values():
        r.counted = any(t_open <= t < t_close for t, _ in r.stamps) or (
            r.due >= t_open and r.due < t_close)
    return Window(t_open, t_close, "closed", [0.0])


# ---------------------------------------------------------------------------
# what a run measured
# ---------------------------------------------------------------------------

@dataclass
class Measured:
    """What the metric readers (``metrics/<name>.py``) read."""
    cell: spec.Cell
    model: dict
    serve: dict
    seconds: float
    window: Window
    setup_s: float
    records: list                 # every request sent after the warm-up
    spans: list                   # probes.Span, --trace 1 only
    stage_metrics: dict
    connector_stats: dict
    moe_drops: Optional[int]
    kv_held: dict = field(default_factory=dict)    # probes.KvPeak.summary()

    @property
    def counted(self) -> list:
        return [r for r in self.records if r.counted]

    @property
    def failed(self) -> int:
        """Counted requests that failed; in an open loop also those still
        unfinished once the grace after the window had passed."""
        if self.window.loop == "open":
            return sum(1 for r in self.counted if r.failed or not r.done)
        return sum(1 for r in self.counted if r.failed)

    @property
    def profile(self) -> Optional[probes.Profile]:
        return self.window.profile

    def latency(self, r: Record, which: str) -> float:
        """Seconds from a counted request's due instant to its first or
        last token; inf where it failed or never finished."""
        if r.failed or not r.done or not r.stamps:
            return math.inf
        t = r.stamps[0][0] if which == "first" else r.stamps[-1][0]
        return t - r.due

    def in_window(self, t: float) -> bool:
        return self.window.t_open <= t < self.window.t_close


def serve_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
               t_start: float, model: dict, serve: dict,
               traffic_spec: Optional[dict] = None):
    """Set up, warm up and serve the cell's traffic; returns (system, measured)."""
    cuda = torch.device(device).type == "cuda"
    sys_ = build(cell, seed, device, model, serve)
    rec = probes.Recorder(sys_.graph_mod.OUTPUT_STAGE, cuda)
    rec.watch_tokens(sys_.orch)
    moe_counter = None
    from repro_torch.models import moe as moe_module
    if model.get("num_experts", 0):
        moe_counter = torch.zeros((), dtype=torch.long, device=device)
        moe_module.drop_counter = moe_counter
    if trace:
        rec.watch_layers(sys_.orch, sys_.engines)
    sender = Sender(sys_, rec)
    traffic = Traffic(traffic_spec or cell.traffic, model["vocab_size"], seed, seconds)
    slot = _ProfileSlot(probes.Profiler(spec.ROOT / "build" / "omnibench") if trace else None,
                        seconds)
    try:
        if slot.p is not None:
            slot.p.warm()
        sys_.orch.start()
        warm_up(sys_, sender, seed, model["vocab_size"])
        rec.spans.clear()
        if moe_counter is not None:
            moe_counter.zero_()
        if traffic.loop == "open":
            window = drive_open(sys_, sender, traffic, seconds,
                                float(traffic.spec.get("grace_s", 60.0)), slot)
        else:
            window = drive_closed(sys_, sender, traffic, seconds, slot)
    finally:
        sys_.orch.shutdown(drain=False)
        rec.uninstall()
        moe_module.drop_counter = None
    if cuda:
        torch.cuda.synchronize()
    if slot.p is not None:
        window.profile = slot.p.result
    rec.resolve()
    sender.collect()
    measured = Measured(
        cell=cell, model=model, serve=serve, seconds=seconds, window=window,
        setup_s=window.t_open - t_start, records=list(sender.records.values()),
        spans=rec.spans,
        stage_metrics=sys_.orch.stage_metrics(),
        connector_stats={k: vars(v) for k, v in sys_.orch.connector_stats().items()},
        moe_drops=int(moe_counter.item()) if moe_counter is not None else None,
        kv_held=sender.kv.summary())
    return sys_, measured


def free(sys_: System) -> None:
    """Drop the program's state, so the reference runs on a card that holds
    nothing of it."""
    for eng in sys_.engines.values():
        eng.runner = None
    sys_.engines.clear()
    sys_.params.clear()
    sys_.orch = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def read_metrics(entries, measured: Measured) -> dict:
    """Each metric's reader, by name; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = spec.load_module("metrics", m["name"]).read(measured)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RunError(f"{m['name']} is {value}: a request due in the window "
                           f"never finished, at the percentile's rank")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(p: probes.Profile) -> dict:
    ops = sorted(p.op_seconds.items(), key=lambda kv: -kv[1])[:10]
    gaps: dict = {}
    for label, s in p.idle_gaps:
        gaps[label] = gaps.get(label, 0.0) + s
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None, metavar="RATES",
                    help="outside the run contract: comma-separated arrival rates of an "
                         "open-loop cell, served one after another in one process")
    ap.add_argument("--schedules", default=None, metavar="SEEDS",
                    help="with --sweep: comma-separated schedule seeds, each swept in turn")
    ap.add_argument("--calibrate", default=None, metavar="SEEDS",
                    help="outside the run contract: comma-separated seeds, each served "
                         "and judged, with the fp8 control's reading beside the program's")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_once(args, t_start: float, device="cuda", model_override=None,
             serve_override=None, traffic_override=None, require_card: bool = True,
             check_modules: bool = True) -> dict:
    """One run of the contract; returns the result line's object.  The
    overrides, ``require_card=False`` and ``check_modules=False`` serve
    the tests on the CPU, at small sizes, in a process where the JAX
    package may be loaded by another test."""
    bench = spec.load_benchmark()
    spec.validate(bench)
    cell = spec.cell(bench, args.workload)
    info = card(cell.chips) if require_card else {"kind": "cpu", "count": 1,
                                                  "power_limit": "n/a"}
    log(f"card: {info['kind']} x{info['count']}, power limit {info['power_limit']}")
    model = {**cell.config["model"], **(model_override or {})}
    serve = {**cell.config["serve"], **(serve_override or {})}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    traffic = {**cell.traffic, **(traffic_override or {})}
    sys_, measured = serve_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                t_start, model, serve, traffic)
    found = forbidden_modules() if check_modules else []
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = read_metrics(entries, measured)
    log(f"metrics on {info['kind']} at power limit {info['power_limit']}: "
        + json.dumps({k: v["value"] for k, v in metrics.items()}))
    report(measured)
    free(sys_)
    verdict = judge.judge(measured, args.seed, device)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": info["kind"],
                   "count": info["count"], "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.correct, "attempted": len(measured.counted),
              "failed": measured.failed,
              "metrics": metrics, "device": device_info}
    if args.trace and measured.profile is not None:
        device_info["busy_s"] = measured.profile.busy_s
        device_info["window_s"] = measured.profile.window_s
        result["breakdown"] = breakdown(measured.profile)
    result["compared"] = verdict.compared
    for name, c in verdict.compared.items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    return result


def report(measured: Measured) -> None:
    """What the result line does not carry, on standard error."""
    w = measured.window
    late = w.lateness
    log(f"window: {measured.seconds} s, {len(measured.counted)} requests counted, "
        f"{sum(r.n_tokens for r in measured.records)} tokens served in all; "
        f"generator late by p90 {stats.pct(late, 90) * 1e3:.3f} ms, "
        f"max {max(late) * 1e3:.3f} ms")
    if w.loop == "open":
        parts = []
        for name, vals in (("ttft_s", [measured.latency(r, "first") for r in measured.counted]),
                           ("jct_s", [measured.latency(r, "last") for r in measured.counted])):
            parts.append(f"{name} p50 {stats.pct(vals, 50)!r} p75 {stats.pct(vals, 75)!r} "
                         f"p90 {stats.pct(vals, 90)!r}")
        log("open loop: " + "; ".join(parts))
    for name, kv in measured.kv_held.items():
        if kv is None:
            log(f"kv held by {name}: no page pool (its runner keeps no paged KV)")
            continue
        log(f"kv held by {name}: peak {kv['peak_pages']} of {kv['pages']} pages, "
            f"{kv['peak_bytes']} of {kv['reserved_bytes']} bytes reserved")
    if measured.moe_drops is not None:
        log(f"moe dropped (token, expert) pairs after the warm-up: {measured.moe_drops}")
    for name, sm in measured.stage_metrics.items():
        log(f"stage {name}: " + json.dumps({k: v for k, v in sm.items()
                                            if not isinstance(v, dict)}))
    log(f"connectors: {json.dumps(measured.connector_stats, default=str)}")


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        if args.sweep:
            from omnibench import modes
            modes.sweep(args, t_start)
            return 0
        if args.calibrate:
            from omnibench import modes
            modes.calibrate(args, t_start)
            return 0
        result = run_once(args, t_start)
    except (RunError, spec.SpecError) as e:
        log(f"error: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0
