"""Metrics-driven dynamic replica scaling (paper §3.2: flexible resource
allocation at runtime).

The :class:`ScalingController` runs in its own thread and, every
``interval`` seconds, consumes one window of WorkerMetrics-derived
signals per stage:

  - ``busy``   — engine busy seconds this window / (interval × replicas):
    the fraction of the stage's replica capacity that was computing;
  - ``backlog`` — live queue depth (inboxes + admitted-but-unfinished)
    normalized per replica;
  - ``queue_delay_p95`` — p95 of the queue delays observed this window
    (logged with every decision for the stage report).

``pressure = busy + min(backlog / backlog_norm, backlog_cap)`` ranks the
stages.  When the hottest stage's pressure exceeds ``hi`` the controller
adds it a replica — from free budget headroom if any, otherwise by
*moving* one from the coldest stage whose pressure is under ``lo`` and
which has replicas to spare (``scale_down(drain=True)`` first, so no
in-flight request is lost, then ``scale_up`` on the bottleneck).  A
cooldown of ``cooldown`` windows follows every action so a move's effect
is observed before the next one.

Every action is appended to ``actions`` (kind, stage, donor, pressures,
wall time) — benchmarks and tests assert on that trace.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class ScalingConfig:
    interval: float = 0.25        # seconds between decision windows
    replica_budget: Optional[int] = None   # None: current total replicas
    min_replicas: int = 1         # floor per stage
    hi: float = 0.75              # pressure above which a stage is hot
    lo: float = 0.40              # pressure below which a stage can donate
    cooldown: int = 2             # windows to hold after an action
    backlog_norm: float = 8.0     # per-replica depth that counts as 1.0
    backlog_cap: float = 2.0      # backlog contribution ceiling


@dataclass
class StageWindow:
    """One decision window's signals for one stage."""
    replicas: int
    busy: float                   # busy fraction of replica capacity
    backlog: float                # live queue depth (absolute)
    queue_delay_p95: float        # p95 of delays observed this window
    pressure: float = field(init=False)

    def __post_init__(self) -> None:
        pass                      # pressure set by the controller


class ScalingController:
    """Moves replicas between stages under a global replica budget."""

    def __init__(self, orch: Any, config: Optional[ScalingConfig] = None):
        self.orch = orch
        self.cfg = config or ScalingConfig()
        # the controller thread appends; benchmarks and tests read the
        # trace live — take a copy via action_log() while serving
        self._lock = threading.Lock()
        self.actions: List[Dict[str, Any]] = []   # guarded-by: _lock
        self.windows = 0
        self._prev_busy: Dict[str, float] = {}
        self._prev_delay_len: Dict[str, Dict[int, int]] = {}
        self._prev_t: Optional[float] = None
        self._cooldown = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        orch._scaler = self          # orch.shutdown() stops us first

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ScalingController":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="scaling-controller",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def action_log(self) -> List[Dict[str, Any]]:
        """Copy of the decision trace, safe to read while serving."""
        with self._lock:
            return list(self.actions)

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval):
            if not getattr(self.orch, "_started", False):
                continue              # backend not serving yet
            try:
                self.tick()
            except Exception:         # noqa: BLE001 — advisory subsystem:
                pass                  # never kill serving over a scale step

    # -- one decision window ----------------------------------------------
    def _measure(self) -> Dict[str, StageWindow]:
        now = time.perf_counter()
        dt = (now - self._prev_t) if self._prev_t is not None \
            else self.cfg.interval
        self._prev_t = now
        out: Dict[str, StageWindow] = {}
        for name in self.orch.graph.stages:
            rs = self.orch._workers.get(name)
            if rs is None:
                continue
            n = max(rs.n_replicas, 1)
            busy_now = sum(getattr(e, "busy_time", 0.0) for e in rs.engines)
            busy_d = max(0.0, busy_now - self._prev_busy.get(name, busy_now))
            self._prev_busy[name] = busy_now
            # windowed queue-delay p95: only the samples added since the
            # previous window (per replica-id, so scale events don't skew)
            seen = self._prev_delay_len.setdefault(name, {})
            fresh: List[float] = []
            for rid, metrics in self.orch._stage_metrics[name].items():
                raw = metrics.raw_delays()
                fresh.extend(raw[seen.get(rid, 0):])
                seen[rid] = len(raw)
            qd95 = (float(np.percentile(np.asarray(fresh), 95))
                    if fresh else 0.0)
            win = StageWindow(replicas=n,
                              busy=busy_d / (dt * n) if dt > 0 else 0.0,
                              backlog=float(rs.queue_depth()),
                              queue_delay_p95=qd95)
            win.pressure = win.busy + min(
                win.backlog / (self.cfg.backlog_norm * n),
                self.cfg.backlog_cap)
            out[name] = win
        return out

    def tick(self) -> Optional[Dict[str, Any]]:
        """One decision window; returns the action taken, if any."""
        wins = self._measure()
        self.windows += 1
        if not wins:
            return None
        if self.windows == 1:
            # priming window: busy deltas are zero by construction, so
            # pressure is pure backlog — a submit burst that hasn't been
            # processed yet is not evidence of a bottleneck.  Never act on
            # the first measurement.
            return None
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        cfg = self.cfg
        total = sum(w.replicas for w in wins.values())
        budget = cfg.replica_budget if cfg.replica_budget is not None \
            else total
        hot_name = max(wins, key=lambda n: wins[n].pressure)
        hot = wins[hot_name]
        if hot.pressure <= cfg.hi:
            return None
        if self.orch.engine_factories.get(hot_name) is None:
            return None           # can't build replicas for this stage
        action: Optional[Dict[str, Any]] = None
        rs = self.orch._workers.get(hot_name)
        n_seeds = len(getattr(rs, "seed_events", ())) if rs else 0
        if total < budget and self.orch.scale_up(hot_name):
            action = {"kind": "add", "stage": hot_name}
        else:
            donors = [n for n, w in wins.items()
                      if n != hot_name and w.replicas > cfg.min_replicas
                      and w.pressure < cfg.lo]
            if donors:
                donor = min(donors, key=lambda n: wins[n].pressure)
                # drain the donor's replica fully (loses nothing), then
                # hand its slot to the bottleneck stage
                if self.orch.scale_down(donor, drain=True) \
                        and self.orch.scale_up(hot_name):
                    action = {"kind": "move", "stage": hot_name,
                              "donor": donor,
                              "donor_pressure": wins[donor].pressure}
        if action is not None:
            if rs is not None and len(rs.seed_events) > n_seeds:
                # the scale_up above warm-seeded the new replica's prefix
                # cache from a sibling — record it with the decision
                action["warm_seed"] = dict(rs.seed_events[-1])
            action.update({
                "t": time.perf_counter(),
                "pressure": hot.pressure,
                "busy": hot.busy,
                "backlog": hot.backlog,
                "queue_delay_p95": hot.queue_delay_p95,
                "replicas": self.orch.replica_counts(),
            })
            with self._lock:
                self.actions.append(action)
            self._cooldown = cfg.cooldown
        return action
