"""Process-isolated stage worker (spawn-based StageWorker contract).

A :class:`ProcessStageWorker` serves the same contract as the in-thread
:class:`~repro_torch.core.worker.StageWorker` — bounded inbox, ``submit`` /
``start`` / ``stop(drain)`` / ``join`` lifecycle, shared
:class:`~repro_torch.core.worker.WorkerMetrics` — but runs its engine in a
**spawned child process**, so a stage gets real OS-level isolation (its
own interpreter, its own CUDA context, no GIL sharing with siblings).

Split of responsibilities across the boundary:

  - control plane: two spawn-context queues.  Parent→child carries
    ``item`` / ``seed`` / ``snapshot`` / ``stop`` commands; child→parent
    carries ``ready`` / ``hb`` (heartbeat + status) / ``admit`` / ``ev``
    (StageEvents) / RPC replies / ``err`` / ``bye``.
  - data plane: tensor payloads never ride the pipes.  The parent-side
    *feeder* thread resolves each item (connector ``recv`` + edge
    transfer run in the parent, where the connectors live), writes the
    result into a named shared-memory segment and ships only the
    picklable :class:`~repro_torch.connector.shm_transport.SegmentManifest`.
  - engines: a closure over initialized params cannot cross ``spawn``;
    the child rebuilds its engine from a picklable
    :class:`~repro_torch.core.config.EngineSpec` (deterministic builders give
    byte-identical params from the same seed, on the device the spec
    names).  Only the spawn start method is used: a forked child would
    inherit the parent's CUDA context, which CUDA does not allow.
  - payloads: everything a child puts on its queue is pickled, so it must
    be host data.  The engines emit numpy payloads (``runner.to_host``);
    shm manifests are numpy-only by design.

Failure semantics: the parent *pump* thread detects a dead child (exit)
or a wedged one (no heartbeat within ``heartbeat_timeout``) and hands
every in-flight item — shipped-but-unfinished (the ledger) plus anything
still in the parent inbox — to the ``on_failure`` callback, which the
owning :class:`~repro_torch.core.worker.ReplicaSet` uses to re-admit them to
surviving replicas.  Delivery is therefore at-least-once across a
replica failure: a request whose chunks were partially emitted may
re-emit them after re-admission, but no submitted request is lost.  A
child-side *engine* crash (build or ``step`` raising) instead surfaces
through ``.error`` like a thread worker's fatal engine failure.

This module is import-light (no torch): the parent pays nothing extra
and a child serving a stub engine never imports torch at all.  A child's
status reports its engine's device, the launch counts of the kernels
its process has loaded (``kernel_launches``), read without importing
them, the engine's own count of the steps that did work
(``engine_steps``, beside its ``busy_time``), and for a PD decode engine
the prompt KV it injected and the seconds that took (``kv_injects``,
``kv_inject_time``).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import sys
import threading
import time
import traceback
from collections import OrderedDict
from dataclasses import asdict, is_dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.connector import shm_transport
from repro_torch.core.config import EngineSpec
from repro_torch.core.request import StageEvent
from repro_torch.core.worker import StageInput, WorkerMetrics

_JOIN_GRACE = 5.0
# the kernel wrappers whose launch counters a child reports, by the name
# of each counter's module
_KERNEL_MODULES = {"paged_attention": "repro_torch.kernels.paged_attention",
                   "flash_attention": "repro_torch.kernels.flash_attention",
                   "mamba1_scan": "repro_torch.kernels.mamba_scan"}


def available() -> bool:
    """True when spawn + named shared memory work on this platform."""
    if not shm_transport.available():
        return False
    try:
        mp.get_context("spawn")
    except ValueError:               # pragma: no cover — exotic platform
        return False
    return True


# ---------------------------------------------------------------------------
# sampling across the boundary
# ---------------------------------------------------------------------------

def _pack_sampling(s: Any) -> Tuple[str, Any]:
    """SamplingParams lives in a torch-importing module; shipping the
    instance would drag torch into every child.  A SimpleNamespace with
    the same fields duck-types it (engines only read attributes), so stub
    children stay torch-free."""
    if is_dataclass(s) and not isinstance(s, type):
        return ("ns", asdict(s))
    return ("raw", s)


def _unpack_sampling(spec: Tuple[str, Any]) -> Any:
    tag, val = spec
    if tag == "ns":
        return SimpleNamespace(**val)
    return val


# ---------------------------------------------------------------------------
# child process
# ---------------------------------------------------------------------------

def _kernel_launches() -> Dict[str, int]:
    """Launch counts of the kernel wrappers this process has imported
    (a wrapper is imported at its first launch; none is imported here)."""
    out = {}
    for name, module in _KERNEL_MODULES.items():
        mod = sys.modules.get(module)
        if mod is not None:
            out[name] = int(mod.launches.value)
    return out


def _child_status(engine: Any, consumed: int, steps: int) -> Dict[str, Any]:
    ps = getattr(engine, "prefix_stats", None)
    dev = getattr(engine, "device", None)
    return {
        "device": None if dev is None else str(dev),
        "kernel_launches": _kernel_launches(),
        "consumed": consumed,
        "has_work": bool(getattr(engine, "has_work", False)),
        "queue_depth": int(getattr(engine, "queue_depth", 0)),
        "busy_time": float(getattr(engine, "busy_time", 0.0)),
        "steps": steps,
        "engine_steps": getattr(engine, "steps", None),
        "kv_injects": getattr(engine, "kv_injects", None),
        "kv_inject_time": getattr(engine, "kv_inject_time", None),
        "cached_prefix_pages": int(
            getattr(engine, "cached_prefix_pages", 0) or 0),
        "prefix_stats": dict(ps) if isinstance(ps, dict) else None,
    }


def _child_admit(engine: Any, stage: str, evt_q: Any, msg: tuple) -> None:
    _, item_id, req_id, origin, sp_spec, t_submit, manifest = msg
    try:
        payload = shm_transport.read_and_release(manifest)
        evt_q.put(("admit", item_id, req_id,
                   time.perf_counter() - t_submit))
        engine.enqueue(req_id, payload["inputs"],
                       _unpack_sampling(sp_spec), payload["data"])
    except Exception as e:           # noqa: BLE001 — fault isolation
        evt_q.put(("aerr", StageEvent(
            req_id, "error",
            {"error": f"{origin}: {type(e).__name__}: {e}"}, stage=stage)))


def _child_seed(engine: Any, manifest: Any, release: bool) -> Optional[int]:
    """Seed the child engine's prefix index from a shipped snapshot.
    ``release=False`` when a connector on the parent side still owns the
    segment's lifetime (manifest-routed warm seed)."""
    try:
        payload = (shm_transport.read_and_release(manifest) if release
                   else shm_transport.read_manifest(manifest))
        if not hasattr(engine, "seed_prefixes"):
            return None
        return int(engine.seed_prefixes(payload["paths"]))
    except Exception:                # noqa: BLE001 — advisory
        return None


def _child_snapshot(engine: Any, max_pages: int) -> Optional[Any]:
    try:
        if not hasattr(engine, "prefix_snapshot"):
            return None
        try:
            paths = engine.prefix_snapshot(max_pages=max_pages)
        except TypeError:            # builder without the kwarg
            paths = engine.prefix_snapshot()
        seg, manifest = shm_transport.write_segment({"paths": paths})
        if seg is not None:
            seg.close()              # receiver unlinks
        return manifest
    except Exception:                # noqa: BLE001 — advisory
        return None


def _child_main(spec: EngineSpec, stage: str, cmd_q: Any, evt_q: Any,
                hb_interval: float) -> None:
    """Spawn entry point: rebuild the engine, then run the admit/step
    loop, mirroring ``StageWorker._loop`` on the far side of the pipe."""
    try:
        engine = spec.build()
    except BaseException:            # noqa: BLE001 — report, don't hang
        evt_q.put(("err", f"engine build failed:\n"
                          f"{traceback.format_exc()}"))
        return
    consumed = steps = 0
    stopping, drain = False, True
    last_hb = 0.0
    evt_q.put(("ready", _child_status(engine, consumed, steps)))
    while True:
        activity = False
        while True:                  # drain the command queue
            try:
                if not getattr(engine, "has_work", False) and not stopping:
                    msg = cmd_q.get(timeout=hb_interval)
                else:
                    msg = cmd_q.get_nowait()
            except queue.Empty:
                break
            kind = msg[0]
            if kind == "item":
                activity = True
                consumed += 1
                if stopping and not drain:
                    shm_transport.release_manifest(msg[6])
                else:
                    _child_admit(engine, stage, evt_q, msg)
            elif kind == "seed":
                activity = True
                n = _child_seed(engine, msg[1], msg[2])
                # fresh status BEFORE the reply (same FIFO queue): when
                # the parent's RPC returns, cached_prefix_pages already
                # reflects the seed — an immediate scale_up sees a warm
                # donor instead of racing the next heartbeat
                evt_q.put(("hb", _child_status(engine, consumed, steps)))
                evt_q.put(("seeded", n))
            elif kind == "snapshot":
                activity = True
                evt_q.put(("snap", _child_snapshot(engine, msg[1])))
            elif kind == "stop":
                stopping, drain = True, bool(msg[1])
        if stopping and (not drain
                         or not getattr(engine, "has_work", False)):
            break
        if getattr(engine, "has_work", False):
            try:
                events = engine.step()
            except BaseException:    # noqa: BLE001 — engine died
                evt_q.put(("err", f"engine.step failed:\n"
                                  f"{traceback.format_exc()}"))
                return
            steps += 1
            activity = True
            for ev in events:
                ev.stage = ev.stage or stage
                evt_q.put(("ev", ev))
        now = time.perf_counter()
        if activity or now - last_hb >= hb_interval:
            # every state change rides a fresh status (consumed count and
            # has_work travel atomically, so the parent's quiescence view
            # never shows "acked but idle" for work the engine still holds)
            evt_q.put(("hb", _child_status(engine, consumed, steps)))
            last_hb = now
    evt_q.put(("bye", _child_status(engine, consumed, steps)))


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class RemoteEngineProxy:
    """Engine-shaped view of a process replica for the parent-side code
    that introspects engines (routing policies, metrics aggregation,
    warm seeding).  Backed by the child's last heartbeat status; the
    ``prefix_snapshot`` / ``seed_prefixes`` pair round-trips through the
    control queue + a shared-memory segment.  ``prefix_hint`` returns 0
    (the affinity probe is not proxied across the boundary — affinity
    routing degrades to least-loaded for process stages)."""

    def __init__(self, worker: "ProcessStageWorker") -> None:
        self._w = worker

    @property
    def has_work(self) -> bool:
        w = self._w
        return w.pending > 0 or bool(w.status["has_work"])

    @property
    def queue_depth(self) -> int:
        w = self._w
        return w.pending + int(w.status["queue_depth"])

    @property
    def busy_time(self) -> float:
        return float(self._w.status["busy_time"])

    @property
    def cached_prefix_pages(self) -> int:
        return int(self._w.status["cached_prefix_pages"])

    @property
    def prefix_stats(self) -> Optional[dict]:
        return self._w.status.get("prefix_stats")

    def prefix_hint(self, hashes: Any) -> int:
        return 0

    def prefix_snapshot(self, max_pages: int = 64) -> list:
        return self._w.prefix_snapshot(max_pages=max_pages) or []

    def seed_prefixes(self, snapshot: Any) -> int:
        return int(self._w.seed_snapshot(snapshot) or 0)

    def enqueue(self, *a: Any, **k: Any) -> None:
        raise RuntimeError(
            "process-isolated stage: admit through worker.submit(), the "
            "engine lives in a child process")


class ProcessStageWorker:
    """Runs one stage engine in a spawned child process; same contract
    as :class:`~repro_torch.core.worker.StageWorker` from the router's side."""

    isolation = "process"
    _IDLE_WAIT = 0.02

    def __init__(self, name: str, spec: EngineSpec,
                 emit: Callable[[str, StageEvent], None], *,
                 capacity: int = 64,
                 metrics: Optional[WorkerMetrics] = None,
                 label: Optional[str] = None,
                 on_failure: Optional[Callable[..., None]] = None,
                 heartbeat_timeout: float = 60.0,
                 ready_timeout: float = 180.0,
                 heartbeat_interval: float = 0.2) -> None:
        if not available():
            raise RuntimeError(
                "process isolation needs spawn + "
                "multiprocessing.shared_memory")
        self.name = name
        self.label = label or name
        self.spec = spec
        self.emit = emit
        self.capacity = capacity
        self.inbox: "queue.Queue[Optional[StageInput]]" = queue.Queue(
            maxsize=capacity)
        self.metrics = metrics or WorkerMetrics()
        self.on_failure = on_failure
        self.heartbeat_timeout = heartbeat_timeout
        self.ready_timeout = ready_timeout
        self.error: Optional[str] = None     # fatal child ENGINE failure
        self.failed = False                  # replica death (kill/wedge)
        self.failure_reason: Optional[str] = None
        self.engine = RemoteEngineProxy(self)
        #: child's last reported status (atomically replaced by the pump)
        self.status: Dict[str, Any] = {
            "device": None, "kernel_launches": {}, "consumed": 0,
            "has_work": False, "queue_depth": 0, "busy_time": 0.0,
            "steps": 0, "engine_steps": None, "kv_injects": None,
            "kv_inject_time": None, "cached_prefix_pages": 0,
            "prefix_stats": None}
        self._last_seq: Dict[int, int] = {}
        self._stop = threading.Event()
        self._drain_on_stop = True
        self._started = False
        self._finalized = False
        self._feeding = False
        self._ready = threading.Event()
        self._gone = threading.Event()
        # item_id -> (re-admittable StageInput, shipped manifest); holds
        # resolved inputs until the request reaches a terminal event at
        # this stage, which is exactly what failure re-admission replays
        # guarded-by: _ledger_lock
        self._ledger: "OrderedDict[int, Tuple[StageInput, Any]]" = \
            OrderedDict()
        self._ledger_lock = threading.Lock()
        self._next_item = 0
        self._shipped = 0
        self._rpc_lock = threading.Lock()
        self._rpc_replies: "queue.Queue[tuple]" = queue.Queue()
        ctx = mp.get_context("spawn")
        self._cmd = ctx.Queue()
        self._evt = ctx.Queue()
        self._proc = ctx.Process(
            target=_child_main,
            args=(spec, name, self._cmd, self._evt, heartbeat_interval),
            name=f"stage-{self.label}", daemon=True)
        self._feeder = threading.Thread(
            target=self._feed, name=f"stage-{self.label}-feed", daemon=True)
        self._pump = threading.Thread(
            target=self._pump_loop, name=f"stage-{self.label}-pump",
            daemon=True)
        self._t_start = 0.0
        self._last_msg = 0.0
        #: seconds from start() to the child's "ready" (engine built)
        self.ready_s: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._t_start = self._last_msg = time.perf_counter()
        self._proc.start()
        self._feeder.start()
        self._pump.start()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the child built its engine (warm-seed RPCs and
        latency-sensitive tests want a live child)."""
        return self._ready.wait(timeout)

    def stop(self, drain: bool = True) -> None:
        self._drain_on_stop = drain
        self._stop.set()
        try:                                 # wake an idle-blocked feeder
            self.inbox.put_nowait(None)
        except queue.Full:
            pass

    def join(self, timeout: Optional[float] = None) -> None:
        if not self._started:
            return
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)

        def left() -> Optional[float]:
            return (None if deadline is None
                    else max(0.0, deadline - time.perf_counter()))
        self._feeder.join(left())
        self._pump.join(left())
        if self._proc.is_alive():
            self._proc.join(left() if deadline is not None else _JOIN_GRACE)

    @property
    def alive(self) -> bool:
        return self._started and self._pump.is_alive()

    @property
    def pending(self) -> int:
        """Items shipped to the child and not yet consumed there."""
        return max(0, self._shipped - int(self.status["consumed"]))

    @property
    def active(self) -> bool:
        return (self._feeding or self.pending > 0
                or bool(self.status["has_work"]))

    def load(self) -> int:
        return (self.inbox.qsize() + self.pending
                + int(self.status["queue_depth"])
                + (1 if self.status["has_work"] else 0))

    # -- producer side -----------------------------------------------------
    def submit(self, item: StageInput,
               timeout: Optional[float] = None) -> bool:
        """Bounded put, same semantics as ``StageWorker.submit``; a
        failed or finalized replica reports unavailable immediately."""
        if self.failed or self.error is not None or self._finalized:
            return False
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            try:
                self.inbox.put(item, timeout=0.05)
                self.metrics.note_depth(self.inbox.qsize())
                return True
            except queue.Full:
                if (self._stop.is_set() or self.failed
                        or self.error is not None
                        or (self._started and not self._pump.is_alive())):
                    return False
                if deadline is not None and time.perf_counter() > deadline:
                    return False

    # -- feeder thread (parent-side admission + shipping) ------------------
    def _feed(self) -> None:
        while True:
            if self._gone.is_set():
                break
            try:
                item = self.inbox.get(timeout=self._IDLE_WAIT)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            if item is None:
                continue
            if self.failed or self._gone.is_set():
                self._strand([item])
                continue
            if self._stop.is_set() and not self._drain_on_stop:
                if item.cleanup is not None:
                    try:
                        item.cleanup()
                    except Exception:        # noqa: BLE001 — best effort
                        pass
                continue
            self._feeding = True
            try:
                self._ship(item)
            finally:
                self._feeding = False
        if not self.failed and self.error is None:
            try:
                self._cmd.put(("stop", self._drain_on_stop))
            except Exception:                # noqa: BLE001 — child gone
                pass

    def _ship(self, item: StageInput) -> None:
        """Parent half of ``StageWorker._admit``: FIFO assertion, lazy
        resolve (connector recv + edge transfer stay in the parent, where
        the connectors live), then segment + manifest to the child."""
        req = item.request
        if item.seq is not None:
            last = self._last_seq.get(req.req_id)
            if last is not None and item.seq <= last:
                delay = time.perf_counter() - item.t_submit
                self.metrics.note_admit(delay)
                req.note_queue_delay(self.name, delay)
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
        self.metrics.note_active()
        try:
            inputs = item.inputs
            if item.resolve is not None:
                inputs = item.resolve()
        except Exception as e:               # noqa: BLE001 — fault isolation
            delay = time.perf_counter() - item.t_submit
            self.metrics.note_admit(delay)
            req.note_queue_delay(self.name, delay)
            self.metrics.note_error()
            self.emit(self.name, StageEvent(
                req.req_id, "error",
                {"error": f"{item.origin}: {type(e).__name__}: {e}"},
                stage=self.name))
            return
        if inputs is None:                   # transfer fn filtered this event
            delay = time.perf_counter() - item.t_submit
            self.metrics.note_admit(delay)
            req.note_queue_delay(self.name, delay)
            self.metrics.note_filtered()
            return
        req.mark_stage_start(self.name)
        # the child-side queue is the bounded half of the inbox: wait for
        # ship credit so backpressure still propagates through submit()
        while self.pending >= self.capacity:
            if self.failed or self._gone.is_set():
                self._strand([self._readmit_item(item, inputs)])
                return
            if self._stop.is_set() and not self._drain_on_stop:
                return
            time.sleep(0.001)
        item_id = self._next_item
        self._next_item += 1
        seg, manifest = shm_transport.write_segment(
            {"inputs": inputs, "data": req.data})
        if seg is not None:
            seg.close()                      # child unlinks after reading
        entry = self._readmit_item(item, inputs)
        with self._ledger_lock:
            self._ledger[item_id] = (entry, manifest)
        self._shipped += 1
        try:
            self._cmd.put(("item", item_id, req.req_id, item.origin,
                           _pack_sampling(item.sampling), item.t_submit,
                           manifest))
        except Exception:                    # noqa: BLE001 — child gone
            self._shipped -= 1
            with self._ledger_lock:
                self._ledger.pop(item_id, None)
            shm_transport.release_manifest(manifest)
            self._strand([entry])

    @staticmethod
    def _readmit_item(item: StageInput, inputs: Dict[str, Any]) -> StageInput:
        """Re-admittable copy: resolved inputs, no consumed-once
        resolve/cleanup closures, original timing and ordering marks."""
        return StageInput(
            request=item.request, sampling=item.sampling, inputs=inputs,
            origin=item.origin, affinity_hints=item.affinity_hints,
            seq=item.seq, seq_last=item.seq_last, t_submit=item.t_submit)

    # -- pump thread (child messages, death detection) ---------------------
    def _pump_loop(self) -> None:
        while True:
            try:
                msg = self._evt.get(timeout=0.05)
            except queue.Empty:
                msg = None
            except Exception:                # noqa: BLE001 — pipe torn down
                self._on_death("control channel broke")
                return
            now = time.perf_counter()
            if msg is not None:
                self._last_msg = now
                if self._dispatch(msg):      # "bye": clean child exit
                    break
                continue
            if not self._proc.is_alive():
                if self._drain_residue():
                    break
                self._on_death("process exited"
                               if self.error is None else "engine error")
                return
            limit = (self.heartbeat_timeout if self._ready.is_set()
                     else self.ready_timeout)
            if now - self._last_msg > limit:
                try:
                    self._proc.kill()
                except Exception:            # noqa: BLE001 — already gone
                    pass
                self._on_death(f"unresponsive (no heartbeat in {limit}s)")
                return
        self._finalize()

    def _drain_residue(self) -> bool:
        """Child exited: flush whatever it managed to enqueue.  Returns
        True if a clean ``bye`` was among the residue."""
        saw_bye = False
        empties = 0
        while empties < 3:
            try:
                msg = self._evt.get(timeout=0.05)
            except queue.Empty:
                empties += 1
                continue
            except Exception:                # noqa: BLE001 — pipe torn down
                break
            empties = 0
            saw_bye = self._dispatch(msg) or saw_bye
        return saw_bye

    def _dispatch(self, msg: tuple) -> bool:
        kind = msg[0]
        if kind in ("ready", "hb", "bye"):
            st = msg[1]
            d = st.get("steps", 0) - self.status.get("steps", 0)
            self.metrics.note_steps(d if d > 0 else 0)
            self.status = st
            if kind == "ready":
                self.ready_s = time.perf_counter() - self._t_start
                self._ready.set()
            return kind == "bye"
        if kind == "admit":
            _, item_id, req_id, delay = msg
            self.metrics.note_admit(delay)
            self.metrics.note_active()
            with self._ledger_lock:
                entry = self._ledger.get(item_id)
            if entry is not None:
                entry[0].request.note_queue_delay(self.name, delay)
            return False
        if kind == "ev":
            ev = msg[1]
            ev.stage = ev.stage or self.name
            self.metrics.note_active()
            self.metrics.note_event(ev)
            if ev.kind in ("finished", "error") or (
                    ev.kind == "chunk" and ev.is_last):
                self._drop_ledger(ev.req_id)
            self.emit(self.name, ev)
            return False
        if kind == "aerr":                   # child-side admission failure
            ev = msg[1]
            self.metrics.note_error()
            self._drop_ledger(ev.req_id)
            self.emit(self.name, ev)
            return False
        if kind in ("seeded", "snap"):
            self._rpc_replies.put(msg)
            return False
        if kind == "err":
            self.error = msg[1]
            return False
        return False

    def _drop_ledger(self, req_id: int) -> None:
        with self._ledger_lock:
            done = [i for i, (it, _) in self._ledger.items()
                    if it.request.req_id == req_id]
            entries = [self._ledger.pop(i) for i in done]
        for _, manifest in entries:
            # consumed items already unlinked their segment; idempotent
            shm_transport.release_manifest(manifest)

    def _on_death(self, reason: str) -> None:
        """Replica died or wedged: reclaim every in-flight item and hand
        the set to ``on_failure`` for re-admission elsewhere."""
        if self._finalized:
            return
        self._finalized = True
        self.failed = True
        self.failure_reason = reason
        self._gone.set()
        self._stop.set()
        try:
            self.inbox.put_nowait(None)
        except queue.Full:
            pass
        with self._ledger_lock:
            entries = list(self._ledger.values())
            self._ledger.clear()
        for _, manifest in entries:
            shm_transport.release_manifest(manifest)
        items = [it for it, _ in entries]
        while True:                          # plus the un-shipped backlog
            try:
                it = self.inbox.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                items.append(it)
        if self.error is not None:
            # engine crash: thread parity — surface via .error, fail the
            # stranded requests cleanly instead of re-running them on a
            # sibling (the same inputs would likely kill it too)
            for it in items:
                self.metrics.note_error()
                self.emit(self.name, StageEvent(
                    it.request.req_id, "error",
                    {"error": f"{self.label}: {reason}"}, stage=self.name))
        else:
            self.metrics.note_replica_failure()
            self._strand(items)

    def _strand(self, items: List[StageInput]) -> None:
        if not items:
            return
        cb = self.on_failure
        if cb is not None:
            try:
                cb(self, list(items))
                return
            except Exception:                # noqa: BLE001 — last resort
                pass
        for it in items:
            self.metrics.note_error()
            self.emit(self.name, StageEvent(
                it.request.req_id, "error",
                {"error": f"{self.label}: replica died "
                          f"({self.failure_reason or 'gone'})"},
                stage=self.name))

    def _finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        self._gone.set()
        with self._ledger_lock:
            entries = list(self._ledger.values())
            self._ledger.clear()
        for _, manifest in entries:
            shm_transport.release_manifest(manifest)
        self._proc.join(timeout=_JOIN_GRACE)
        if self._proc.is_alive():            # pragma: no cover — stuck exit
            self._proc.kill()

    # -- RPCs (seed / snapshot over the control queues) --------------------
    def _rpc(self, msg: tuple, expect: str,
             timeout: float = 60.0) -> Optional[Any]:
        if not self._ready.wait(timeout=timeout):
            return None
        with self._rpc_lock:
            if self._gone.is_set() or self.failed or self.error is not None:
                return None
            while True:                      # drop stale replies
                try:
                    self._rpc_replies.get_nowait()
                except queue.Empty:
                    break
            # _rpc_lock serializes whole RPC round trips; the child's pump
            # never waits on it
            try:
                self._cmd.put(msg)  # noqa: CCY003 — the RPC's critical section
            except Exception:                # noqa: BLE001 — child gone
                return None
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                if self._gone.is_set():
                    return None
                try:   # the 0.05 s poll bounds the hold
                    kind, val = self._rpc_replies.get(timeout=0.05)  # noqa: CCY003
                except queue.Empty:
                    continue
                if kind == expect:
                    return val
            return None

    def prefix_snapshot(self, max_pages: int = 64,
                        timeout: float = 60.0) -> Optional[list]:
        """Donor side of warm seeding: child snapshot, shipped back
        through its own segment."""
        manifest = self._rpc(("snapshot", max_pages), "snap",
                             timeout=timeout)
        if manifest is None:
            return None
        try:
            return shm_transport.read_and_release(manifest).get("paths")
        except Exception:                    # noqa: BLE001 — advisory
            return None

    def seed_snapshot(self, snapshot: Any,
                      timeout: float = 60.0) -> Optional[int]:
        """Receiver side: ship a parent-held snapshot into the child's
        prefix index (ownership of the segment passes to the child)."""
        try:
            seg, manifest = shm_transport.write_segment({"paths": snapshot})
        except Exception:                    # noqa: BLE001 — advisory
            return None
        if seg is not None:
            seg.close()
        n = self._rpc(("seed", manifest, True), "seeded", timeout=timeout)
        if n is None:
            shm_transport.release_manifest(manifest)
        return n

    def seed_manifest(self, manifest: Any,
                      timeout: float = 60.0) -> Optional[int]:
        """Seed from a connector-exported manifest; the connector keeps
        segment ownership (caller releases the key afterwards)."""
        return self._rpc(("seed", manifest, False), "seeded",
                         timeout=timeout)
