"""Orchestrator (paper §3.1/§3.3): event-driven router over per-stage
workers — the fully disaggregated execution backend.

Two backends share all routing logic:

  - ``threaded`` (default): every stage engine runs in its own
    :class:`~repro_torch.core.worker.StageWorker` thread with a bounded inbox;
    a router thread consumes the shared event queue that all workers emit
    into, applies edge transfer functions through the connector channel
    API (``send`` on the upstream side, lazy ``recv`` inside the
    destination worker), and pushes downstream stage inputs.  Stages
    batch and step concurrently and independently — a slow stage fills
    its own inbox (per-edge backpressure) instead of stalling the whole
    pipeline.  Online arrivals enter through ``submit`` at any time.

  - ``sync``: the original lock-step loop — each ``tick`` steps every
    engine once in topo order and routes synchronously.  Kept as the
    ablation baseline (bench_online measures threaded vs sync) and for
    tests that single-step engines by hand.

``run()`` is the compatibility path: submit-all → drain → return
completed.  It works identically on both backends, so offline callers
never see the threads.

Multi-replica stages: every stage is served by a
:class:`~repro_torch.core.worker.ReplicaSet` of N independently-stepping engine
replicas.  A pluggable routing policy picks the replica per item:

  - ``round_robin``   — cycle replicas (baseline);
  - ``least_loaded``  — lowest live load (inbox depth + engine queue
    depth + mid-step), never a retired replica (retired replicas leave
    the candidate set before they stop);
  - ``affinity``      — cache-affinity: score each replica by the longest
    block-hash prefix match against its PageAllocator index (the cheap
    ``prefix_hint`` probe), so shared-prefix traffic lands on the replica
    already holding the pages; falls back to least-loaded when no replica
    holds anything (or the stage cannot prefix-cache the item).

``scale_up(stage)`` / ``scale_down(stage)`` move replicas at runtime —
the scaling controller (repro_torch.core.scaling) drives them from
WorkerMetrics snapshots under a global replica budget (paper §3.2,
flexible resource allocation).
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.connector import shm_transport
from repro_torch.connector.base import Connector, TransferTimeout
from repro_torch.connector.mooncake import make_connector
from repro_torch.core.config import ServeConfig
from repro_torch.core.graph import StageGraph
from repro_torch.core.request import Request, StageEvent
from repro_torch.core.worker import ReplicaSet, StageInput, WorkerMetrics
from repro_torch.engine.sampling import SamplingParams


# ----------------------------------------------------------------------------
# routing policies (ReplicaSet.submit calls select() under the set lock;
# keep it cheap and side-effect free beyond per-stage cursors)
# ----------------------------------------------------------------------------

class RoutingPolicy:
    """select(stage, [(rid, worker), ...], item) -> rid.  Candidates are
    exactly the live, routable replicas — a stopping replica is removed
    from the list before its worker stops, so no policy can pick it."""

    name = "base"

    def select(self, stage: str, replicas: List[Tuple[int, Any]],
               item: StageInput) -> int:
        raise NotImplementedError


class RoundRobinPolicy(RoutingPolicy):
    name = "round_robin"

    def __init__(self) -> None:
        self._next: Dict[str, int] = {}

    def select(self, stage, replicas, item):
        i = self._next.get(stage, 0) % len(replicas)
        self._next[stage] = i + 1
        return replicas[i][0]


class LeastLoadedPolicy(RoutingPolicy):
    name = "least_loaded"

    def select(self, stage, replicas, item):
        return min(replicas, key=lambda rw: (rw[1].load(), rw[0]))[0]


class CacheAffinityPolicy(LeastLoadedPolicy):
    """Deterministic given fixed hints: highest prefix_hint wins, ties
    break by load then lowest replica id; hint 0 everywhere (or no hints
    computable) falls back to least-loaded."""

    name = "affinity"

    def select(self, stage, replicas, item):
        hints = item.affinity_hints
        if hints is None and item.inputs is not None:
            probe = getattr(replicas[0][1].engine, "affinity_hints", None)
            hints = probe(item.inputs) if probe is not None else None
            item.affinity_hints = hints if hints is not None else []
        if hints:
            scored = []
            for rid, w in replicas:
                hint = getattr(w.engine, "prefix_hint", None)
                scored.append((hint(hints) if hint is not None else 0,
                               rid, w))
            best = max(s for s, _, _ in scored)
            if best > 0:
                return min((rw for rw in scored if rw[0] == best),
                           key=lambda rw: (rw[2].load(), rw[1]))[1]
        return super().select(stage, replicas, item)


ROUTING_POLICIES = {p.name: p for p in
                    (RoundRobinPolicy, LeastLoadedPolicy,
                     CacheAffinityPolicy)}


def make_routing_policy(name: str) -> RoutingPolicy:
    if name not in ROUTING_POLICIES:
        raise ValueError(f"unknown routing policy {name!r} "
                         f"(have {sorted(ROUTING_POLICIES)})")
    return ROUTING_POLICIES[name]()


_LEGACY_KWARGS = ("backend", "queue_capacity", "recv_timeout", "replicas",
                  "routing", "engine_factories", "engine_specs",
                  "isolation", "warm_seed")


class Orchestrator:
    def __init__(self, graph: StageGraph, engines: Dict[str, Any],
                 connectors: Optional[Dict[str, Connector]] = None, *,
                 config: Optional[ServeConfig] = None, **legacy: Any):
        graph.validate()
        if legacy:
            unknown = set(legacy) - set(_LEGACY_KWARGS)
            if unknown:
                raise TypeError(f"Orchestrator() got unexpected keyword "
                                f"argument(s) {sorted(unknown)}")
            if config is not None:
                raise TypeError(
                    "pass config=ServeConfig(...) OR the legacy kwargs, "
                    "not both")
            if set(legacy) - {"backend"}:
                # plain backend= selection predates the kwargs bag and is
                # not worth a warning; everything else is the bag
                warnings.warn(
                    "the Orchestrator(replicas=..., routing=..., "
                    "engine_factories=..., ...) kwargs bag is deprecated; "
                    "build a repro_torch.core.config.ServeConfig and pass "
                    "config=... — it validates eagerly and carries "
                    "per-stage isolation",
                    DeprecationWarning, stacklevel=2)
            config = ServeConfig.from_kwargs(**legacy)
        if config is None:
            config = ServeConfig()
        self.config = config
        backend = config.backend
        self.graph = graph
        for name in graph.stages:
            if name not in engines:
                raise ValueError(f"no engine bound for stage {name!r}")
        for name, sc in config.stages.items():
            if name not in graph.stages and (
                    sc.replicas != 1 or sc.isolation != "thread"):
                raise ValueError(f"replica spec for unknown stage {name!r}")
        self.engine_factories = {
            name: sc.engine_factory for name, sc in config.stages.items()
            if sc.engine_factory is not None}
        self.engine_specs = {
            name: sc.engine_spec for name, sc in config.stages.items()
            if sc.engine_spec is not None}
        # thread stages bind one engine or a list of engine replicas; the
        # replica spec grows a stage to N via its engine factory.  Process
        # stages keep only the given engine(s) parent-side (compat views)
        # and spawn ``replicas`` child workers from the engine spec.
        self.stage_replicas: Dict[str, List[Any]] = {
            name: (list(e) if isinstance(e, (list, tuple)) else [e])
            for name, e in engines.items() if name in graph.stages}
        self._proc_replicas: Dict[str, int] = {}   # spawn count per stage
        for name in graph.stages:
            sc = config.stage(name)
            if sc.isolation == "process":
                self._proc_replicas[name] = max(
                    sc.replicas, len(self.stage_replicas[name]))
                continue
            while len(self.stage_replicas[name]) < sc.replicas:
                fac = self.engine_factories.get(name)
                if fac is None:
                    raise ValueError(
                        f"stage {name!r}: replicas={sc.replicas} needs an "
                        f"engine factory (got "
                        f"{len(self.stage_replicas[name])} engine(s))")
                self.stage_replicas[name].append(fac())
        if backend == "sync" and any(len(l) > 1
                                     for l in self.stage_replicas.values()):
            raise ValueError("sync (lock-step) backend is single-replica")
        self.routing = (config.routing
                        if isinstance(config.routing, RoutingPolicy)
                        else make_routing_policy(config.routing))
        self.warm_seed = config.warm_seed
        # requests admitted before start() for a process-isolated source
        # stage are deferred (the parent-side engine never steps for a
        # process stage) and flushed through the workers at start()
        self._deferred: List[Tuple[str, Request]] = []  # guarded-by: _lock
        # one connector instance per backend kind (shared across edges)
        kinds = {e.connector for e in graph.edges}
        self.connectors = connectors or {k: make_connector(k) for k in kinds}
        self.backend = backend
        self.queue_capacity = config.queue_capacity
        self.recv_timeout = config.recv_timeout
        self._seed_connector: Optional[Connector] = None
        self.requests: Dict[int, Request] = {}        # guarded-by: _lock
        self._outputs_pending: Dict[int, set] = {}    # guarded-by: _lock
        self.completed: List[Request] = []            # guarded-by: _lock
        #: stream of finished Requests, in completion order — the online
        #: front-end consumes this while the backend keeps serving
        self.completions: "queue.Queue[Request]" = queue.Queue()
        self._transfer_log: List[dict] = []
        self._lock = threading.RLock()
        # ---- threaded backend state ----
        self._workers: Dict[str, ReplicaSet] = {}
        # per-stage bank of per-replica metrics; survives worker restarts
        # AND scale_down/scale_up cycles (replica ids are reused)
        self._stage_metrics: Dict[str, Dict[int, WorkerMetrics]] = {
            n: {} for n in graph.stages}
        self.edge_stats = {
            StageGraph.edge_id(e): {"transfers": 0, "backpressure_s": 0.0}
            for e in graph.edges}
        self._events: "queue.Queue[tuple]" = queue.Queue()
        # per-(edge, request) chunk sequence counters, stamped at the
        # connector boundary; destination workers assert per-request FIFO.
        # Router-thread only — no lock needed.
        self._edge_seq: Dict[Tuple[str, int], int] = {}
        self._unrouted = 0                   # guarded-by: _counter_lock
        self._counter_lock = threading.Lock()
        self._router_thread: Optional[threading.Thread] = None
        self._router_stop = threading.Event()
        self._started = False
        self._scaler = None              # attached ScalingController

    @property
    def engines(self) -> Dict[str, Any]:
        """Replica-0 view of the stage engines (single-replica compat:
        the sync backend, pre-start admission and tick() use it)."""
        return {n: lst[0] for n, lst in self.stage_replicas.items()}

    def _live_engines(self, name: str) -> List[Any]:
        if self._started and name in self._workers:
            return self._workers[name].engines
        return self.stage_replicas[name]

    # ------------------------------------------------------------------
    def _sp(self, req: Request) -> SamplingParams:
        return (SamplingParams(**req.sampling) if req.sampling
                else SamplingParams())

    def submit(self, request: Request) -> None:
        """Admit one request: its initial inputs go to every source stage.
        Callable at any time while the threaded backend is serving."""
        with self._lock:
            self.requests[request.req_id] = request
            self._outputs_pending[request.req_id] = set(
                self.graph.output_stages())
        for src in self.graph.sources():
            if self._started:
                ok = self._workers[src].submit(StageInput(
                    request, self._sp(request), inputs=request.inputs))
                if not ok:
                    self._fail(request, f"admission to {src!r} rejected")
            elif src in self._proc_replicas:
                # the parent-side engine of a process stage never steps;
                # hold the admission until start() spawns the workers
                with self._lock:
                    self._deferred.append((src, request))
            else:
                request.mark_stage_start(src)
                self.engines[src].enqueue(
                    request.req_id, request.inputs, self._sp(request),
                    request.data)

    # ------------------------------------------------------------------
    # threaded backend lifecycle
    # ------------------------------------------------------------------
    def _stage_policy(self, name: str) -> RoutingPolicy:
        """Per-stage routing override from the config; stages without one
        share the orchestrator-wide policy instance."""
        r = self.config.stage_routing(name)
        if isinstance(r, RoutingPolicy):
            return r
        if r == self.routing.name:
            return self.routing
        return make_routing_policy(r)

    def start(self) -> None:
        """Spin up one replica set (N worker threads, or N spawned worker
        processes for process-isolated stages) per stage plus the router
        thread."""
        if self.backend != "threaded":
            raise RuntimeError("start() requires backend='threaded'")
        if self._started:
            return
        if self._seed_connector is None and self.warm_seed:
            # warm-seed snapshots ride the connector channel API; the
            # cross-process data plane serves thread and process
            # receivers alike (manifest route for the latter)
            from repro_torch.connector.shm import SharedMemoryConnector
            self._seed_connector = SharedMemoryConnector(
                cross_process=shm_transport.available())
        self._router_stop = threading.Event()
        self._workers = {}
        for name in self.graph.stages:
            sc = self.config.stage(name)
            self._workers[name] = ReplicaSet(
                name, self.stage_replicas[name], self._emit,
                capacity=self.queue_capacity,
                metrics_bank=self._stage_metrics[name],
                policy=self._stage_policy(name),
                engine_factory=self.engine_factories.get(name),
                warm_seed=self.warm_seed,
                isolation=sc.isolation,
                engine_spec=self.engine_specs.get(name),
                seed_connector=self._seed_connector,
                n_replicas=self._proc_replicas.get(name))
        self._started = True
        for w in self._workers.values():
            w.start()
        self._router_thread = threading.Thread(
            target=self._router_loop, name="stage-router", daemon=True)
        self._router_thread.start()
        with self._lock:
            deferred, self._deferred = self._deferred, []
        for src, request in deferred:
            ok = self._workers[src].submit(StageInput(
                request, self._sp(request), inputs=request.inputs))
            if not ok:
                self._fail(request, f"admission to {src!r} rejected")

    # ------------------------------------------------------------------
    # dynamic scaling (called by the ScalingController's thread)
    # ------------------------------------------------------------------
    def replica_counts(self) -> Dict[str, int]:
        return {n: (self._workers[n].n_replicas
                    if self._started and n in self._workers
                    else self._proc_replicas.get(
                        n, len(self.stage_replicas[n])))
                for n in self.graph.stages}

    def scale_up(self, stage: str, engine: Any = None) -> bool:
        """Add one replica to ``stage`` (needs an engine or a factory;
        process-isolated stages spawn one from the engine spec)."""
        if self._started and stage in self._workers:
            return self._workers[stage].scale_up(engine) is not None
        if stage in self._proc_replicas:
            self._proc_replicas[stage] += 1
            return True
        if engine is None:
            fac = self.engine_factories.get(stage)
            if fac is None:
                return False
            engine = fac()
        self.stage_replicas[stage].append(engine)
        return True

    def scale_down(self, stage: str, drain: bool = True) -> bool:
        """Retire the least-loaded replica of ``stage`` (never below one);
        with drain=True its queued and admitted work completes first."""
        if self._started and stage in self._workers:
            return self._workers[stage].scale_down(drain=drain) is not None
        if stage in self._proc_replicas:
            if self._proc_replicas[stage] <= 1:
                return False
            self._proc_replicas[stage] -= 1
            return True
        if len(self.stage_replicas[stage]) <= 1:
            return False
        self.stage_replicas[stage].pop()
        return True

    def _emit(self, stage: str, ev: StageEvent) -> None:
        with self._counter_lock:
            self._unrouted += 1
        self._events.put((stage, ev))

    def _router_loop(self) -> None:
        while True:
            try:
                stage, ev = self._events.get(timeout=0.01)
            except queue.Empty:
                if self._router_stop.is_set():
                    break
                continue
            try:
                self._route(ev)
            except Exception as e:  # noqa: BLE001 — isolate to the request
                with self._lock:
                    req = self.requests.get(ev.req_id)
                if req is not None:
                    self._fail(req, f"router: {type(e).__name__}: {e}")
            finally:
                with self._counter_lock:
                    self._unrouted -= 1

    @property
    def worker_error(self) -> Optional[str]:
        """First fatal stage-engine failure, if any — online front-ends
        should poll this instead of waiting out their time limit."""
        return next((w.error for w in self._workers.values() if w.error),
                    None)

    def _quiescent(self) -> bool:
        with self._counter_lock:
            if self._unrouted:
                return False
        if any(w.active or not w.inbox_empty()
               for w in self._workers.values()):
            return False
        return not any(e.has_work for n in self.graph.stages
                       for e in self._live_engines(n))

    def drain(self, timeout: Optional[float] = None,
              poll: float = 0.005) -> bool:
        """Block until every submitted request completed (True) or the
        system quiesces with requests still unfinished / timeout (False)."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        quiet = 0
        while True:
            with self._lock:
                done = all(r.completion_time is not None
                           for r in self.requests.values())
            if done:
                return True
            if self.worker_error:
                raise RuntimeError(
                    f"stage worker died: {self.worker_error}")
            if deadline is not None and time.perf_counter() > deadline:
                return False
            # a request can legitimately never complete (e.g. a transfer fn
            # filtered its only event) — exit once nothing is in flight,
            # like the lock-step loop's "engines idle" exit
            if self._quiescent():
                quiet += 1
                if quiet >= 3:
                    return False
            else:
                quiet = 0
            time.sleep(poll)

    def shutdown(self, drain: bool = True) -> None:
        """Stop workers (upstream-first when draining, so final events
        cascade downstream) and then the router."""
        if not self._started:
            return
        if self._scaler is not None:         # no scaling mid-teardown
            self._scaler.stop()
            self._scaler.join(timeout=30.0)
            self._scaler = None
        for name in self.graph.topo_order():
            w = self._workers[name]
            w.stop(drain=drain)
            w.join(timeout=30.0)
            while drain:  # flush this stage's last events downstream
                with self._counter_lock:
                    if self._unrouted == 0:
                        break
                time.sleep(0.002)
        # persist any runtime scaling into the engine bindings so a
        # restart reopens with the same replica topology (process sets
        # persist their spawn count — the proxies die with the children)
        for name, w in self._workers.items():
            if w.isolation == "process":
                self._proc_replicas[name] = w.n_replicas
            else:
                self.stage_replicas[name] = w.engines
        self._router_stop.set()
        if self._router_thread is not None:
            self._router_thread.join(timeout=30.0)
        self._started = False

    # ------------------------------------------------------------------
    # routing (runs on the router thread, or on the caller in sync mode)
    # ------------------------------------------------------------------
    def _forget_request(self, req_id: int) -> None:
        """Release per-request routing state: edge chunk-seq counters and
        the replica sets' sticky chunk-stream pins."""
        for k in [k for k in self._edge_seq if k[1] == req_id]:
            self._edge_seq.pop(k, None)
        for w in self._workers.values():
            w.forget(req_id)

    def _fail(self, req: Request, msg: str) -> None:
        with self._lock:
            if req.completion_time is not None:
                req.failed = req.failed or msg
                return
            req.failed = msg
            req.completion_time = time.perf_counter()
            self._outputs_pending.pop(req.req_id, None)
            self.completed.append(req)
        self._forget_request(req.req_id)
        self.completions.put(req)

    def _finish(self, req: Request) -> None:
        with self._lock:
            req.completion_time = time.perf_counter()
            self._outputs_pending.pop(req.req_id, None)
            self.completed.append(req)
        self._forget_request(req.req_id)
        self.completions.put(req)

    @staticmethod
    def _apply_transfer(edge, req: Request, payload, kind: str,
                        chunk_index: int, is_last: bool):
        """Edge transfer + chunk metadata defaulting — the ONE place both
        the sync path and the worker-side resolve closure go through."""
        inputs = edge.transfer(req.data, payload)
        if inputs is None:
            return None                       # transfer fn filtered this event
        if kind == "chunk":
            inputs.setdefault("chunk_index", chunk_index)
            inputs.setdefault("is_last_chunk", is_last)
        return inputs

    def _forward(self, edge, req: Request, ev: StageEvent) -> None:
        conn = self.connectors[edge.connector]
        eid = StageGraph.edge_id(edge)
        key = f"{eid}/{req.req_id}/{ev.chunk_index}"
        self._transfer_log.append({
            "edge": eid, "connector": edge.connector, "req_id": req.req_id})
        if self._started:
            # upstream side publishes; the destination worker receives,
            # deserializes and applies the transfer in ITS thread
            conn.send(key, ev.payload)
            kind, chunk_index, is_last = ev.kind, ev.chunk_index, ev.is_last
            recv_timeout = self.recv_timeout

            def resolve(conn=conn, key=key, edge=edge, req=req, kind=kind,
                        chunk_index=chunk_index, is_last=is_last, eid=eid):
                try:
                    payload = conn.recv(key, timeout=recv_timeout)
                except TransferTimeout as e:
                    # tag the edge so the per-request failure is
                    # attributable (the worker catches + emits an error
                    # event; the worker itself keeps serving)
                    raise e.with_edge(eid) from None
                finally:
                    conn.release(key)
                return self._apply_transfer(edge, req, payload, kind,
                                            chunk_index, is_last)

            item = StageInput(req, self._sp(req), resolve=resolve,
                              origin=f"transfer {eid}",
                              cleanup=lambda: conn.release(key))
            if edge.streaming and kind == "chunk":
                # stamp the connector-boundary sequence number: the
                # destination worker asserts per-request FIFO on it and
                # the replica set pins the stream to one replica
                sk = (eid, req.req_id)
                item.seq = self._edge_seq.get(sk, -1) + 1
                self._edge_seq[sk] = item.seq
                item.seq_last = is_last
                if is_last:
                    self._edge_seq.pop(sk, None)
            t0 = time.perf_counter()
            ok = self._workers[edge.dst].submit(item)
            es = self.edge_stats[eid]
            es["transfers"] += 1
            es["backpressure_s"] += time.perf_counter() - t0
            if not ok:
                conn.release(key)             # never delivered: end lifetime
                self._fail(req, f"{eid}: downstream worker unavailable")
            return
        # ---- sync (lock-step) path ----
        conn.send(key, ev.payload)
        try:
            payload = conn.recv(key, timeout=self.recv_timeout)
        except Exception as e:    # noqa: BLE001 — fail the request, not run()
            self._fail(req, f"{eid}: transfer {type(e).__name__}: {e}")
            return
        finally:
            conn.release(key)     # either way the key's lifetime ends here
        self.edge_stats[eid]["transfers"] += 1
        try:
            inputs = self._apply_transfer(edge, req, payload, ev.kind,
                                          ev.chunk_index, ev.is_last)
        except Exception as e:
            # a broken user transfer fn fails THIS request, not the
            # serving loop: mark failed + complete so callers unblock
            self._fail(req, f"transfer {eid}: {type(e).__name__}: {e}")
            return
        if inputs is None:
            return
        req.mark_stage_start(edge.dst)
        self.engines[edge.dst].enqueue(req.req_id, inputs, self._sp(req),
                                       req.data)

    def _route(self, ev: StageEvent) -> None:
        with self._lock:
            req = self.requests.get(ev.req_id)
        if req is None:
            return                            # unknown/forgotten request
        stage = ev.stage
        if ev.kind == "error":
            # fault isolation: the failing stage input killed one request
            self._fail(req, str(ev.payload.get("error", "stage error")))
            return
        if ev.kind == "finished":
            req.mark_stage_end(stage)
        for edge in self.graph.out_edges(stage):
            if ev.kind == "chunk" and not edge.streaming:
                continue                      # non-streaming edges wait
            if ev.kind == "finished" and edge.streaming and ev.payload.get(
                    "n_chunks", 0) > 0:
                continue                      # chunks already forwarded
            if req.completion_time is not None and req.failed:
                break                         # request already failed
            self._forward(edge, req, ev)

        # terminal output collection (under the lock: _fail() may pop
        # the pending-outputs entry from another thread at any moment;
        # _finish() runs after release so completions.put stays unlocked)
        done = False
        with self._lock:
            outs = self._outputs_pending.get(ev.req_id)
            if outs is None or stage not in outs:
                return
            now = time.perf_counter()
            if req.first_output_time is None:
                req.first_output_time = now
            if ev.kind == "chunk":
                tokens = ev.payload.get("tokens") if isinstance(ev.payload, dict) else None
                req.chunk_times.append((now, ev.t_emit, 0 if tokens is None else len(tokens)))
            if ev.kind == "finished" or (ev.kind == "chunk" and ev.is_last):
                req.outputs.setdefault(stage, []).append(ev.payload)
                req.mark_stage_end(stage)
                outs.discard(stage)
                done = not outs
            elif ev.kind == "chunk":
                req.outputs.setdefault(stage, []).append(ev.payload)
        if done:
            self._finish(req)

    # ------------------------------------------------------------------
    # lock-step compat path
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """Step every engine once; returns number of events processed.
        Only valid while the threaded backend is NOT running."""
        if self._started:
            raise RuntimeError(
                "tick() is the lock-step path; shutdown() the threaded "
                "backend first")
        n = 0
        for name in self.graph.topo_order():
            for ev in self.engines[name].step():
                ev.stage = ev.stage or name
                self._route(ev)
                n += 1
        return n

    def run(self, max_ticks: int = 100_000,
            timeout: Optional[float] = None) -> List[Request]:
        """Compatibility path: drain everything submitted so far and
        return the completed requests (offline inference)."""
        if self.backend == "sync":
            for _ in range(max_ticks):
                # sync backend: offline single-threaded drain loop; no
                # router thread is running
                reqs = self.requests.values()  # noqa: CCY001 — sync drain loop
                if all(r.completion_time is not None for r in reqs):
                    break
                busy = any(self.engines[n].has_work
                           for n in self.graph.stages)
                self.tick()
                if not busy:
                    break
            # returned after the sync loop drained; no concurrent writers remain
            return self.completed  # noqa: CCY001 — the sync loop drained
        self.start()
        try:
            self.drain(timeout=timeout)
        finally:
            # always tear the threads down, even when drain() raises on a
            # dead worker — otherwise the backend stays _started forever
            self.shutdown(drain=False)
        # returned after drain()+shutdown(); worker and router threads are joined
        return self.completed  # noqa: CCY001 — threads joined

    # ------------------------------------------------------------------
    def stage_busy_times(self) -> Dict[str, float]:
        return {n: sum(getattr(e, "busy_time", 0.0)
                       for e in self._live_engines(n))
                for n in self.graph.stages}

    def _replica_snapshots(self, name: str) -> Dict[int, Dict[str, float]]:
        """Per-replica metric snapshots, including retired replica ids
        whose counters still contribute to the stage totals."""
        if self._started and name in self._workers:
            live = {rid: w.engine for rid, w in self._workers[name].workers()}
        elif name in self._proc_replicas:
            # not serving: the children are gone, only the spawn count
            # survives (busy seconds were banked at retirement)
            live = {rid: None for rid in range(self._proc_replicas[name])}
        else:
            live = dict(enumerate(self.stage_replicas[name]))
        out = {}
        for rid, metrics in sorted(self._stage_metrics[name].items()):
            eng = live.get(rid)
            snap = metrics.snapshot(
                busy_time=getattr(eng, "busy_time", 0.0) if eng else 0.0)
            snap["live"] = 1.0 if rid in live else 0.0
            out[rid] = snap
        if not out:                       # never served: synthesize rows
            for rid, eng in live.items():
                out[rid] = WorkerMetrics().snapshot(
                    busy_time=getattr(eng, "busy_time", 0.0))
                out[rid]["live"] = 1.0
        return out

    def _aggregate_stage(self, name: str) -> Dict[str, float]:
        """Merge the per-replica snapshots into one stage row: counters
        sum, inbox high-water maxes, busy_frac is busy over summed active
        spans (per-replica capacity), throughput adds, and queue-delay
        percentiles are recomputed over the merged raw samples."""
        reps = self._replica_snapshots(name)
        agg: Dict[str, float] = {}
        for c in ("admitted", "filtered", "finished", "events", "steps",
                  "errors", "order_violations", "replica_failures",
                  "busy_time", "finished_per_s"):
            agg[c] = sum(r[c] for r in reps.values())
        agg["max_inbox_depth"] = max(
            (r["max_inbox_depth"] for r in reps.values()), default=0)
        span = sum(r["active_span"] for r in reps.values())
        agg["active_span"] = span
        agg["busy_frac"] = agg["busy_time"] / span if span > 0 else 0.0
        qd = np.concatenate([
            np.asarray(m.raw_delays(), np.float64)
            for m in self._stage_metrics[name].values()]) \
            if self._stage_metrics[name] else np.empty(0)
        agg["queue_delay_mean"] = float(qd.mean()) if qd.size else 0.0
        agg["queue_delay_p50"] = (float(np.percentile(qd, 50))
                                  if qd.size else 0.0)
        agg["queue_delay_p95"] = (float(np.percentile(qd, 95))
                                  if qd.size else 0.0)
        agg["n_replicas"] = sum(1 for r in reps.values() if r["live"])
        return agg

    def stage_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-stage serving metrics: queueing delay, busy fraction,
        throughput, inbox high-water mark, prefix-cache hit rates —
        aggregated across replicas, with the per-replica rows under
        ``"replicas"`` when a stage runs more than one."""
        out = {}
        for n in self.graph.stages:
            m = self._aggregate_stage(n)
            cached = computed = lookups = hits = 0
            full_blk = part = 0
            for eng in self._live_engines(n):
                ps = getattr(eng, "prefix_stats", None)
                if ps is not None:
                    lookups += ps.get("lookups", 0)
                    hits += ps.get("hits", 0)
                    cached += ps.get("cached_tokens", 0)
                    computed += ps.get("computed_tokens", 0)
                    full_blk += ps.get("full_block_tokens", 0)
                    part += ps.get("partial_tokens", 0)
            if lookups:
                total = cached + computed
                m["cached_tokens"] = cached
                m["computed_tokens"] = computed
                m["full_block_tokens"] = full_blk
                m["partial_tokens"] = part
                m["prefix_hit_rate"] = cached / total if total else 0.0
                m["full_hit_rate"] = full_blk / total if total else 0.0
                m["partial_hit_rate"] = part / total if total else 0.0
            phases: Dict[str, float] = {}
            for eng in self._live_engines(n):
                totals = getattr(eng, "step_totals", None)
                for k, v in (totals.snapshot().items() if totals else ()):
                    phases[k] = phases.get(k, 0.0) + v
            if phases:
                # AR engines: seconds of each step phase and the host reads
                # (metrics.StepTotals), summed over the live replicas
                m["step_phases"] = phases
            if m["n_replicas"] > 1 or len(self._stage_metrics[n]) > 1:
                m["replicas"] = self._replica_snapshots(n)
            out[n] = m
        return out

    def connector_stats(self) -> Dict[str, Any]:
        return {k: c.stats for k, c in self.connectors.items()}
