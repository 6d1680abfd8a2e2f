"""Per-stage execution workers (paper §3.1: fully disaggregated stages).

A :class:`StageWorker` owns exactly one stage engine and runs it in a
dedicated thread, so every stage of an any-to-any pipeline batches and
steps independently — a slow DiT stage no longer stalls the AR decoder in
front of it.  The worker's interface to the rest of the system is two
queues:

  - **inbox** — bounded queue of :class:`StageInput` items.  Bounded puts
    are the per-edge backpressure mechanism: when a consumer stage falls
    behind, the router blocks on (and accounts for) the full inbox instead
    of buffering unboundedly.
  - **emit** — callback onto the router's event queue; every StageEvent
    the engine produces is forwarded there.

Inputs can carry either resolved model inputs or a lazy ``resolve``
closure (connector ``recv`` + edge transfer), so payload deserialization
runs in the *destination* stage's thread, overlapping transfers with other
stages' compute.

Lifecycle: ``start`` → (``submit`` | engine steps)* → ``stop(drain=...)``
→ ``join``.  ``stop(drain=True)`` lets the worker finish everything
already admitted or queued; ``drain=False`` exits after the current step.

Multi-replica stages (paper §3.2, flexible GPU allocation): a
:class:`ReplicaSet` puts N independently-stepping engine replicas behind
one ``submit`` — a pluggable routing policy picks the replica, and
``scale_up`` / ``scale_down(drain=True)`` grow or shrink the set at
runtime without dropping in-flight requests.  The router only ever sees
the set's queues, so multi-replica serving is invisible to the graph.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.request import Request, StageEvent


@dataclass
class StageInput:
    """One unit of admission into a stage engine."""
    request: Request
    sampling: Any                                   # SamplingParams
    inputs: Optional[Dict[str, Any]] = None         # resolved inputs, or
    resolve: Optional[Callable[[], Optional[dict]]] = None  # lazy recv+transfer
    origin: str = "admission"                       # edge id or "admission"
    # run if the item is discarded unadmitted (e.g. non-draining shutdown):
    # releases the connector entry the resolve closure would have consumed
    cleanup: Optional[Callable[[], None]] = None
    # block-hash chain for cache-affinity routing; None = not yet probed
    affinity_hints: Optional[Any] = None
    # per-request monotonic sequence number, stamped at the connector
    # boundary on streamed chunks (None = unordered item).  The destination
    # worker asserts strictly-increasing delivery per request; the replica
    # set routes all seq-carrying items of one request to one replica.
    seq: Optional[int] = None
    seq_last: bool = False              # final chunk: tracker entry drops
    t_submit: float = field(default_factory=time.perf_counter)


class WorkerMetrics:
    """Per-stage serving metrics; survives worker restarts (the
    orchestrator passes the same object into each generation of worker)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.queue_delays: List[float] = []   # guarded-by: _lock
        self.admitted = 0                     # guarded-by: _lock
        self.filtered = 0                     # guarded-by: _lock
        self.finished = 0                     # guarded-by: _lock
        self.events = 0                       # guarded-by: _lock
        self.steps = 0                        # guarded-by: _lock
        self.errors = 0                       # guarded-by: _lock
        # out-of-order streamed chunks seen
        self.order_violations = 0             # guarded-by: _lock
        # process replicas died/killed/wedged
        self.replica_failures = 0             # guarded-by: _lock
        self.max_inbox_depth = 0              # guarded-by: _lock
        self.first_active: Optional[float] = None    # guarded-by: _lock
        self.last_active: Optional[float] = None     # guarded-by: _lock
        # busy seconds banked from engines this replica no longer runs
        # (scale_down drops the engine object, its dwell must survive)
        self.retired_busy = 0.0               # guarded-by: _lock

    def note_admit(self, delay: float) -> None:
        with self._lock:
            self.queue_delays.append(delay)
            self.admitted += 1

    def note_active(self) -> None:
        now = time.perf_counter()
        with self._lock:
            if self.first_active is None:
                self.first_active = now
            self.last_active = now

    def note_depth(self, depth: int) -> None:
        with self._lock:
            self.max_inbox_depth = max(self.max_inbox_depth, depth)

    def note_retired_busy(self, busy_time: float) -> None:
        with self._lock:
            self.retired_busy += busy_time

    def note_replica_failure(self) -> None:
        with self._lock:
            self.replica_failures += 1

    def note_filtered(self) -> None:
        with self._lock:
            self.filtered += 1

    def note_error(self) -> None:
        with self._lock:
            self.errors += 1

    def note_order_violation(self) -> None:
        with self._lock:
            self.order_violations += 1
            self.errors += 1

    def note_steps(self, n: int = 1) -> None:
        if n:
            with self._lock:
                self.steps += n

    def note_event(self, ev: StageEvent) -> None:
        """Count one emitted event.  One request-finish per request: the
        last streamed chunk, or a "finished" event that wasn't preceded
        by chunks (an AR stage that streamed emits BOTH — count once)."""
        streamed = (isinstance(ev.payload, dict)
                    and ev.payload.get("n_chunks", 0) > 0)
        finish = (ev.kind == "finished" and not streamed) or (
            ev.kind == "chunk" and ev.is_last)
        with self._lock:
            self.events += 1
            if finish:
                self.finished += 1

    def raw_delays(self) -> List[float]:
        """Copy of the raw queue-delay samples (merged percentiles across
        replicas, windowed deltas in the scaling controller)."""
        with self._lock:
            return list(self.queue_delays)

    def snapshot(self, busy_time: float = 0.0) -> Dict[str, float]:
        with self._lock:
            busy_time = busy_time + self.retired_busy
            qd = np.asarray(self.queue_delays, np.float64)
            span = ((self.last_active - self.first_active)
                    if self.first_active is not None else 0.0)
            return {
                "admitted": self.admitted,
                "filtered": self.filtered,
                "finished": self.finished,
                "events": self.events,
                "steps": self.steps,
                "errors": self.errors,
                "order_violations": self.order_violations,
                "replica_failures": self.replica_failures,
                "max_inbox_depth": self.max_inbox_depth,
                "queue_delay_mean": float(qd.mean()) if qd.size else 0.0,
                "queue_delay_p50": (float(np.percentile(qd, 50))
                                    if qd.size else 0.0),
                "queue_delay_p95": (float(np.percentile(qd, 95))
                                    if qd.size else 0.0),
                "busy_time": busy_time,
                "active_span": span,
                "busy_frac": (busy_time / span) if span > 0 else 0.0,
                "finished_per_s": (self.finished / span) if span > 0 else 0.0,
            }


class StageWorker:
    """Runs one StageEngine in its own thread with an inbox/emit loop."""

    isolation = "thread"
    _IDLE_WAIT = 0.02            # idle block on the inbox (stop() wakes it)

    def __init__(self, name: str, engine: Any,
                 emit: Callable[[str, StageEvent], None], *,
                 capacity: int = 64,
                 metrics: Optional[WorkerMetrics] = None,
                 label: Optional[str] = None) -> None:
        self.name = name                 # stage name (routing + metrics)
        self.label = label or name       # thread label (replica-qualified)
        self.engine = engine
        self.emit = emit
        self.inbox: "queue.Queue[Optional[StageInput]]" = queue.Queue(
            maxsize=capacity)
        self.metrics = metrics or WorkerMetrics()
        self.error: Optional[str] = None            # fatal engine failure
        self._last_seq: Dict[int, int] = {}         # req_id -> last chunk seq
        self._stop = threading.Event()
        self._drain_on_stop = True
        self._stepping = False
        self._thread = threading.Thread(target=self._loop,
                                        name=f"stage-{self.label}",
                                        daemon=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def stop(self, drain: bool = True) -> None:
        self._drain_on_stop = drain
        self._stop.set()
        try:                                 # wake an idle-blocked loop
            self.inbox.put_nowait(None)
        except queue.Full:
            pass

    def join(self, timeout: Optional[float] = None) -> None:
        if self._started:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def active(self) -> bool:
        """True while the worker is admitting or stepping (quiescence)."""
        return self._stepping

    def load(self) -> int:
        """Live load proxy for routing: queued + admitted-but-unfinished
        work plus one if mid-step.  Advisory (read cross-thread)."""
        return (self.inbox.qsize() + getattr(self.engine, "queue_depth", 0)
                + (1 if self._stepping else 0))

    # -- producer side -----------------------------------------------------
    def submit(self, item: StageInput,
               timeout: Optional[float] = None) -> bool:
        """Bounded put → per-edge backpressure. Blocks until space (or
        ``timeout``); returns False if the worker stopped or timed out."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            try:
                self.inbox.put(item, timeout=0.05)
                self.metrics.note_depth(self.inbox.qsize())
                return True
            except queue.Full:
                # a stopped or crashed worker will never drain its inbox —
                # report unavailable instead of blocking the router forever
                if self._stop.is_set() or self.error is not None or (
                        self._started and not self._thread.is_alive()):
                    return False
                if deadline is not None and time.perf_counter() > deadline:
                    return False

    # -- worker thread -----------------------------------------------------
    def _admit(self, item: StageInput) -> None:
        req = item.request
        delay = time.perf_counter() - item.t_submit
        self.metrics.note_admit(delay)
        req.note_queue_delay(self.name, delay)
        if item.seq is not None:
            # per-request FIFO assertion: streamed chunks must arrive in
            # the order the connector stamped them.  Strictly-increasing
            # (not +1) so a replica handoff mid-stream stays legal while
            # reorders and duplicates within one worker are caught.
            last = self._last_seq.get(req.req_id)
            if last is not None and item.seq <= last:
                self.metrics.note_order_violation()
                self.emit(self.name, StageEvent(
                    req.req_id, "error",
                    {"error": f"{item.origin}: out-of-order chunk "
                              f"seq={item.seq} after {last}"},
                    stage=self.name))
                return
            if item.seq_last:
                self._last_seq.pop(req.req_id, None)
            else:
                self._last_seq[req.req_id] = item.seq
        try:
            inputs = item.inputs
            if item.resolve is not None:
                inputs = item.resolve()
            if inputs is None:               # transfer fn filtered this event
                self.metrics.note_filtered()
                return
            req.mark_stage_start(self.name)
            self.engine.enqueue(req.req_id, inputs, item.sampling, req.data)
        except Exception as e:               # noqa: BLE001 — fault isolation
            self.metrics.note_error()
            self.emit(self.name, StageEvent(
                req.req_id, "error",
                {"error": f"{item.origin}: {type(e).__name__}: {e}"},
                stage=self.name))

    def _loop(self) -> None:
        eng = self.engine
        while True:
            drained = 0
            while True:                      # drain the inbox
                try:
                    if drained == 0 and not eng.has_work:
                        item = self.inbox.get(timeout=self._IDLE_WAIT)
                    else:
                        item = self.inbox.get_nowait()
                except queue.Empty:
                    break
                drained += 1
                if item is not None:
                    self._stepping = True
                    self.metrics.note_active()
                    self._admit(item)
                    self._stepping = False
            if self._stop.is_set():
                if (not self._drain_on_stop
                        or (self.inbox.empty() and not eng.has_work)):
                    break
            if not eng.has_work:
                continue
            self._stepping = True
            self.metrics.note_active()
            try:
                events = eng.step()
            except Exception as e:           # noqa: BLE001 — engine died
                self.error = f"{type(e).__name__}: {e}"
                self._stepping = False
                break
            self.metrics.note_steps()
            for ev in events:
                ev.stage = ev.stage or self.name
                self.metrics.note_event(ev)
                self.emit(self.name, ev)
            self.metrics.note_active()
            self._stepping = False
        self._discard_inbox()

    def _discard_inbox(self) -> None:
        """On a non-draining (or aborted) exit, run queued items' cleanups
        so connector entries they would have consumed are released."""
        while True:
            try:
                item = self.inbox.get_nowait()
            except queue.Empty:
                return
            if item is not None and item.cleanup is not None:
                try:
                    item.cleanup()
                except Exception:            # noqa: BLE001 — best effort
                    pass


class ReplicaSet:
    """N :class:`StageWorker` replicas behind one logical stage.

    Each replica owns a private engine (its own scheduler, KV pool and
    thread); the set's ``submit`` picks a replica through a routing policy
    (``select(stage, [(rid, worker), ...], item) -> rid``) and forwards
    the bounded put, so per-edge backpressure semantics are unchanged.

    ``scale_up`` adds a replica (a given engine, or one from the stage's
    engine factory) and ``scale_down(drain=True)`` retires the least
    loaded replica without losing requests: the victim is removed from
    the routing set first, in-flight submits targeting it are allowed to
    land, and only then is its worker stopped with ``drain=True`` — it
    finishes everything queued plus everything its engine already admitted
    before the thread exits.

    Replica ids are small integers; a retired id is reused by the next
    ``scale_up`` so the per-replica metrics bank stays bounded by the
    maximum concurrent replica count (and keeps accumulating across
    worker generations, like single-replica restarts always have).
    """

    def __init__(self, stage: str, engines: List[Any],
                 emit: Callable[[str, StageEvent], None], *,
                 capacity: int = 64,
                 metrics_bank: Optional[Dict[int, WorkerMetrics]] = None,
                 policy: Any = None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 warm_seed: bool = True,
                 isolation: str = "thread",
                 engine_spec: Optional[Any] = None,
                 seed_connector: Optional[Any] = None,
                 n_replicas: Optional[int] = None,
                 process_opts: Optional[Dict[str, Any]] = None) -> None:
        if isolation not in ("thread", "process"):
            raise ValueError(f"unknown isolation {isolation!r}")
        if isolation == "process" and engine_spec is None:
            raise ValueError(
                f"stage {stage!r}: isolation='process' needs an "
                f"engine_spec (picklable 'module:callable' recipe)")
        if not engines and isolation != "process":
            raise ValueError(f"stage {stage!r} needs at least one engine")
        self.stage = stage
        self.emit = emit
        self.capacity = capacity
        self.policy = policy
        self.engine_factory = engine_factory
        self.warm_seed = warm_seed
        self.isolation = isolation
        self.engine_spec = engine_spec
        #: connector carrying warm-seed snapshots (channel API); None
        #: falls back to the direct engine-to-engine hand-off
        self.seed_connector = seed_connector
        self.process_opts = dict(process_opts or {})
        #: audit trail of warm scale-ups:
        #: {"rid", "donor_pages", "pages", "via"}
        self.seed_events: List[Dict[str, Any]] = []      # guarded-by: _lock
        #: audit trail of replica deaths:
        #: {"rid", "reason", "readmitted"}
        self.failure_events: List[Dict[str, Any]] = []   # guarded-by: _lock
        self.metrics_bank = metrics_bank if metrics_bank is not None else {}
        self._lock = threading.Lock()
        self._replicas: Dict[int, Any] = {}  # guarded-by: _lock
        self._order: List[int] = []          # guarded-by: _lock (routable)
        # in-flight submit() puts
        self._pending: Dict[int, int] = {}   # guarded-by: _lock
        # seq-carrying (streamed-chunk) items stick to one replica per
        # request — splitting a chunk stream across replicas would admit
        # it out of order at two engines at once
        self._sticky: Dict[int, int] = {}    # guarded-by: _lock
        self._rr = 0                         # guarded-by: _lock (rr cursor)
        self._seed_seq = 0                   # guarded-by: _lock (seed keys)
        self._started = False                # guarded-by: _lock
        if isolation == "process":
            for rid in range(n_replicas or max(1, len(engines))):
                self._install(rid, None)
        else:
            for rid, eng in enumerate(engines):
                self._install(rid, eng)

    def _install(self, rid: int, engine: Any,
                 routable: bool = True) -> Any:  # requires-lock: _lock
        metrics = self.metrics_bank.setdefault(rid, WorkerMetrics())
        label = f"{self.stage}#{rid}"
        if self.isolation == "process":
            from repro_torch.core.proc_worker import ProcessStageWorker
            w: Any = ProcessStageWorker(
                self.stage, self.engine_spec, self.emit,
                capacity=self.capacity, metrics=metrics, label=label,
                on_failure=self._on_replica_failure, **self.process_opts)
        else:
            w = StageWorker(self.stage, engine, self.emit,
                            capacity=self.capacity, metrics=metrics,
                            label=label)
        self._replicas[rid] = w
        if routable:
            self._order.append(rid)
        return w

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            self._started = True
            workers = list(self._replicas.values())
        for w in workers:
            w.start()

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            workers = list(self._replicas.values())
        for w in workers:
            w.stop(drain=drain)

    def join(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            workers = list(self._replicas.values())
        for w in workers:
            w.join(timeout)

    # -- introspection -----------------------------------------------------
    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._order)

    @property
    def replica_ids(self) -> List[int]:
        with self._lock:
            return list(self._order)

    @property
    def engines(self) -> List[Any]:
        with self._lock:
            return [self._replicas[r].engine for r in self._order]

    def workers(self) -> List[Tuple[int, StageWorker]]:
        with self._lock:
            return [(r, self._replicas[r]) for r in self._order]

    @property
    def alive(self) -> bool:
        with self._lock:
            return any(w.alive for w in self._replicas.values())

    @property
    def active(self) -> bool:
        with self._lock:
            return any(w.active for w in self._replicas.values())

    def inbox_empty(self) -> bool:
        with self._lock:
            return all(w.inbox.empty() for w in self._replicas.values())

    @property
    def error(self) -> Optional[str]:
        with self._lock:
            return next((w.error for w in self._replicas.values()
                         if w.error), None)

    def queue_depth(self) -> int:
        """Total live load across replicas (inboxes + engines)."""
        with self._lock:
            return sum(w.load() for w in self._replicas.values())

    # -- producer side -----------------------------------------------------
    def submit(self, item: StageInput,
               timeout: Optional[float] = None) -> bool:
        """Route one item to a replica (policy-chosen) and forward the
        bounded put.  The pending counter pins the chosen replica against
        a concurrent ``scale_down`` until the put lands."""
        with self._lock:
            if not self._order:
                return False
            cands = [(r, self._replicas[r]) for r in self._order]
            sticky = (self._sticky.get(item.request.req_id)
                      if item.seq is not None else None)
            if sticky is not None and sticky in self._order:
                rid = sticky                       # keep the chunk stream
            elif self.policy is not None and len(cands) > 1:
                rid = self.policy.select(self.stage, cands, item)
                if rid not in self._replicas:      # policy bug: fall back
                    rid = cands[0][0]
            elif len(cands) > 1:
                rid = cands[self._rr % len(cands)][0]
                self._rr += 1
            else:
                rid = cands[0][0]
            if item.seq is not None:
                # pin the rest of this request's chunk stream here —
                # FIFO only holds within one replica's inbox
                self._sticky[item.request.req_id] = rid
            self._pending[rid] = self._pending.get(rid, 0) + 1
            w = self._replicas[rid]
        try:
            return w.submit(item, timeout=timeout)
        finally:
            with self._lock:
                self._pending[rid] -= 1

    def forget(self, req_id: int) -> None:
        """Drop a finished/failed request's sticky chunk-stream pin."""
        with self._lock:
            self._sticky.pop(req_id, None)

    # -- replica failure (process isolation) -------------------------------
    def _on_replica_failure(self, worker: Any,
                            items: List[StageInput]) -> None:
        """A process replica died or wedged (detected by its pump thread,
        which calls here): retire it from the routing set and re-admit its
        in-flight items to the survivors.  Requests that no survivor can
        take fail cleanly instead of hanging."""
        with self._lock:
            rid = next((r for r, w in self._replicas.items()
                        if w is worker), None)
            if rid is not None:
                if rid in self._order:
                    self._order.remove(rid)
                del self._replicas[rid]
                for req_id in [k for k, v in self._sticky.items()
                               if v == rid]:
                    del self._sticky[req_id]
                self.failure_events.append({
                    "rid": rid,
                    "reason": getattr(worker, "failure_reason", None),
                    "readmitted": len(items)})
            survivors = bool(self._order)
        if rid is not None:
            # bank the dead engine's last-reported dwell, like scale_down
            self.metrics_bank[rid].note_retired_busy(
                getattr(worker.engine, "busy_time", 0.0))
        for item in items:
            ok = survivors and self.submit(item, timeout=5.0)
            if not ok:
                self.emit(self.stage, StageEvent(
                    item.request.req_id, "error",
                    {"error": f"{self.stage}: replica failed and no "
                              f"survivor accepted the request"},
                    stage=self.stage))

    # -- dynamic scaling ---------------------------------------------------
    def _warm_seed(self, engine: Any) -> Optional[Dict[str, Any]]:
        """Seed a new engine's prefix index from the warmest sibling.

        With a ``seed_connector`` the snapshot travels through the
        connector channel API: the donor's snapshot is ``send``-published
        under a warm-seed key and the receiver ``recv``s it (a process
        receiver takes the zero-extra-copy manifest route when the
        connector can export one).  Advisory either way: any failure
        (engines without snapshot support, pool too small, transfer
        timeout, mid-extract eviction) degrades to a cold start.  The
        donor snapshot pins its pages only for the duration of the
        extract, so the sibling keeps serving."""
        if not (hasattr(engine, "seed_prefixes")
                and hasattr(engine, "prefix_hint")):
            return None
        with self._lock:
            siblings = [self._replicas[r].engine for r in self._order]
        donor = None
        best = 0
        for eng in siblings:
            pages = getattr(eng, "cached_prefix_pages", 0)
            if pages > best and hasattr(eng, "prefix_snapshot"):
                donor, best = eng, pages
        if donor is None:
            return None
        try:
            snap = donor.prefix_snapshot()
            if not snap:
                return None
            if self.seed_connector is not None:
                seeded, via = self._seed_via_connector(engine, snap)
            else:
                seeded, via = engine.seed_prefixes(snap), "direct"
        except Exception:                        # advisory: cold start
            return None
        if not seeded:
            return None
        return {"donor_pages": best, "pages": seeded, "via": via}

    def _seed_via_connector(self, engine: Any,
                            snap: Any) -> Tuple[int, str]:
        """Route one warm-seed snapshot through the connector channel
        API (send on the donor side, recv/manifest on the receiver)."""
        conn = self.seed_connector
        with self._lock:
            self._seed_seq += 1
            key = f"warmseed/{self.stage}/{self._seed_seq}"
        conn.send(key, {"paths": snap})
        try:
            seed_rpc = getattr(engine, "seed_prefixes", None)
            manifest_of = getattr(conn, "manifest", None)
            owner = getattr(engine, "_w", None)  # RemoteEngineProxy
            if owner is not None and manifest_of is not None and getattr(
                    conn, "cross_process", False):
                # process receiver + cross-process connector: ship the
                # picklable manifest, payload stays in shared memory
                n = owner.seed_manifest(manifest_of(key))
                return int(n or 0), "manifest"
            payload = conn.recv(key, timeout=30.0)
            return int(seed_rpc(payload["paths"])), "connector"
        finally:
            conn.release(key)

    def scale_up(self, engine: Any = None) -> Optional[int]:
        """Add one replica (given engine, a fresh one from the stage
        factory, or — process isolation — a spawned worker built from the
        stage's engine spec); returns its replica id, or None without a
        source.  With ``warm_seed`` the new engine's prefix cache is
        seeded from the sibling holding the most indexed pages before it
        joins the routing set, so its first requests already score
        affinity hits."""
        if self.isolation == "process":
            return self._scale_up_process()
        if engine is None:
            if self.engine_factory is None:
                return None
            engine = self.engine_factory()       # may be slow: outside lock
        seed = self._warm_seed(engine) if self.warm_seed else None
        with self._lock:
            rid = next(i for i in range(len(self._replicas) + 1)
                       if i not in self._replicas)
            w = self._install(rid, engine)
            started = self._started
            if seed is not None:
                self.seed_events.append({"rid": rid, **seed})
        if started:
            w.start()
        return rid

    def _scale_up_process(self) -> Optional[int]:
        """Spawned replicas join in two steps: install unrouted + start
        (the child needs to be live before the warm-seed RPC), then seed,
        then make routable."""
        with self._lock:
            rid = next(i for i in range(len(self._replicas) + 1)
                       if i not in self._replicas)
            w = self._install(rid, None, routable=False)
            started = self._started
        seed = None
        if started:
            w.start()
            if w.wait_ready(timeout=180.0) and self.warm_seed:
                seed = self._warm_seed(w.engine)
        with self._lock:
            self._order.append(rid)
            if seed is not None:
                self.seed_events.append({"rid": rid, **seed})
        return rid

    def scale_down(self, drain: bool = True) -> Optional[int]:
        """Retire the least-loaded replica; never below one.  With
        ``drain=True`` (the default) the victim finishes its queued and
        admitted work before its thread exits — no request is dropped.
        Returns the retired replica id, or None if the set is at minimum.
        Blocks until the victim has drained; call from a control thread
        (the scaling controller), not from the router."""
        with self._lock:
            if len(self._order) <= 1:
                return None
            rid = min(self._order,
                      key=lambda r: (self._replicas[r].load(), r))
            self._order.remove(rid)              # unroutable from now on
            # grab the worker under the lock: a concurrent
            # _on_replica_failure may delete the entry at any moment
            w = self._replicas[rid]
        while True:                              # let in-flight puts land
            with self._lock:
                if self._pending.get(rid, 0) == 0:
                    break
            time.sleep(0.001)
        w.stop(drain=drain)
        w.join(timeout=60.0)
        # bank the retired engine's dwell so stage busy_time survives
        self.metrics_bank[rid].note_retired_busy(
            getattr(w.engine, "busy_time", 0.0))
        with self._lock:
            # pop, not del: the failure path may have removed it already
            self._replicas.pop(rid, None)
            # unpin chunk streams that stuck to the retired replica
            for req_id in [k for k, v in self._sticky.items() if v == rid]:
                del self._sticky[req_id]
        return rid
