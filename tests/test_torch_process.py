"""Process-isolated stage replicas and the scaling controller of the port,
mirroring tests/test_process_worker.py, the autoscale tests of
tests/test_replicas.py and the process-isolated PD test of
tests/test_pd_disagg.py.

Stub children rebuild ``repro_torch.engine.stub_engine`` engines from
picklable EngineSpecs and never import torch.  The PD test's decode child
rebuilds the whole tiny PD pipeline from its spec with ``device="cpu"``
carried through it, and its greedy tokens must equal the threaded run's
and a unified engine's (tests/test_torch_pipelines.py holds the unified
engine against the JAX package's PD pipeline).  Every wait has its own
timeout, so a hung child fails its test instead of the run.
"""
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.pipelines import _kv, build_pd_disaggregated
from repro_torch.connector import shm_transport
from repro_torch.connector.shm import SharedMemoryConnector
from repro_torch.core import proc_worker
from repro_torch.core.config import EngineSpec, ServeConfig, StageConfig
from repro_torch.core.graph import StageGraph
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request, StageEvent
from repro_torch.core.scaling import ScalingConfig, ScalingController
from repro_torch.core.stage import StageSpec
from repro_torch.core.worker import ReplicaSet, StageInput
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.sampling import SamplingParams
from repro_torch.engine.stub_engine import StubEngine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = EngineSpec("repro_torch.engine.stub_engine:make_stub",
                  {"name": "s", "dwell_ms": 1.0})


def _graph():
    g = StageGraph()
    g.add_stage(StageSpec("s", "custom", is_output=True))
    return g


def test_spawn_and_named_shared_memory_are_available():
    assert proc_worker.available()


def test_worker_side_modules_do_not_import_torch():
    """A stub child pays for no torch: the modules it loads import none."""
    code = ("import sys\n"
            "import repro_torch.core.proc_worker, repro_torch.engine.stub_engine\n"
            "import repro_torch.core.scaling\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# cross-process shared-memory round trip
# ---------------------------------------------------------------------------

def _shm_echo_child(manifest, q):
    """Spawn target: rebuild the payload in another process, unlink the
    segment (ownership passed with the manifest), echo scalars back."""
    payload = shm_transport.read_and_release(manifest)
    q.put({"sum": float(payload["x"].sum()),
           "shape": tuple(payload["x"].shape),
           "tag": payload["meta"]["tag"]})


def test_shm_roundtrip_crosses_processes():
    ctx = mp.get_context("spawn")
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    seg, manifest = shm_transport.write_segment(
        {"x": x, "meta": {"tag": "hello"}})
    assert seg is not None and manifest.nbytes == x.nbytes
    seg.close()                          # child unlinks via the manifest
    q = ctx.Queue()
    p = ctx.Process(target=_shm_echo_child, args=(manifest, q))
    p.start()
    out = q.get(timeout=30)
    p.join(10)
    assert out == {"sum": float(x.sum()), "shape": (4, 6), "tag": "hello"}
    with pytest.raises(FileNotFoundError):   # the receiver released it
        shm_transport.read_manifest(manifest)


def test_release_manifest_is_idempotent():
    seg, manifest = shm_transport.write_segment(
        {"x": np.ones(8, np.float32)})
    seg.close()
    shm_transport.release_manifest(manifest)
    shm_transport.release_manifest(manifest)     # second release: no-op


# ---------------------------------------------------------------------------
# orchestrator end to end: a process stage serves as a thread stage does
# ---------------------------------------------------------------------------

def _run_pipeline(isolation):
    stages = {"s": StageConfig(replicas=2, isolation=isolation,
                               engine_spec=STUB,
                               engine_factory=lambda: STUB.build())}
    orch = Orchestrator(_graph(), {"s": StubEngine("s")},
                        config=ServeConfig(stages=stages))
    reqs = [Request(inputs={"x": i}) for i in range(8)]
    for r in reqs:
        orch.submit(r)
    done = orch.run(timeout=60.0)
    assert len(done) == 8 and not any(r.failed for r in done)
    return sorted(r.outputs["s"][0]["x"] for r in done), orch


def test_process_stage_matches_thread_outputs():
    out_thread, _ = _run_pipeline("thread")
    out_proc, orch = _run_pipeline("process")
    assert out_proc == out_thread == list(range(8))
    m = orch.stage_metrics()["s"]
    assert m["admitted"] == m["finished"] == 8
    assert m["errors"] == 0 and m["replica_failures"] == 0
    assert m["n_replicas"] == 2


def test_pre_start_admission_is_deferred_then_served():
    stages = {"s": StageConfig(isolation="process", engine_spec=STUB)}
    orch = Orchestrator(_graph(), {"s": StubEngine("s")},
                        config=ServeConfig(stages=stages))
    # submitted before start(): a process stage has no parent-side engine
    # to step, so admission defers and flushes through the worker
    orch.submit(Request(inputs={"x": 41}))
    done = orch.run(timeout=60.0)
    assert len(done) == 1 and done[0].outputs["s"][0]["x"] == 41


def test_child_status_reports_device_and_kernel_launches():
    class Engine:
        device = torch.device("cpu")
        has_work, queue_depth, busy_time, steps = False, 0, 0.0, 1

    st = proc_worker._child_status(Engine(), consumed=3, steps=2)
    assert st["device"] == "cpu" and st["consumed"] == 3 and st["steps"] == 2
    assert st["engine_steps"] == 1            # the engine's steps that did work
    from repro_torch.kernels import paged_attention as pa
    pa.launches.reset()
    assert proc_worker._child_status(Engine(), 0, 0)["kernel_launches"][
        "paged_attention"] == 0
    stub = proc_worker._child_status(StubEngine("s"), 0, 0)
    assert stub["device"] is None and stub["engine_steps"] is None


# ---------------------------------------------------------------------------
# lifecycle: drain loses nothing; a killed replica's work is re-admitted
# ---------------------------------------------------------------------------

def test_drain_stops_losing_nothing():
    spec = EngineSpec("repro_torch.engine.stub_engine:make_stub",
                      {"name": "s", "dwell_ms": 20.0})
    events = []
    rs = ReplicaSet("s", [None], lambda st, ev: events.append(ev),
                    isolation="process", engine_spec=spec)
    rs.start()
    w = rs.workers()[0][1]
    assert w.wait_ready(30.0)
    assert w.ready_s is not None and w.ready_s > 0
    for i in range(10):
        assert rs.submit(StageInput(Request(inputs={"x": i}), None,
                                    inputs={"x": i}), timeout=10.0)
    rs.stop(drain=True)
    rs.join(60.0)
    finished = [e for e in events if e.kind == "finished"]
    assert len(finished) == 10
    assert not [e for e in events if e.kind == "error"]


def test_killed_replica_readmits_to_survivor():
    spec = EngineSpec("repro_torch.engine.stub_engine:make_stub",
                      {"name": "s", "dwell_ms": 30.0})
    events = []
    rs = ReplicaSet("s", [None, None], lambda st, ev: events.append(ev),
                    isolation="process", engine_spec=spec,
                    process_opts={"heartbeat_timeout": 5.0})
    rs.start()
    for _, w in rs.workers():
        assert w.wait_ready(30.0)
    reqs = [Request(inputs={"x": i}) for i in range(12)]
    for r in reqs:
        assert rs.submit(StageInput(r, None, inputs=r.inputs), timeout=10.0)
    time.sleep(0.05)                     # let work start flowing
    victim = rs.workers()[0][1]
    os.kill(victim._proc.pid, signal.SIGKILL)
    deadline = time.time() + 30.0
    while time.time() < deadline:
        if len({e.req_id for e in events if e.kind == "finished"}) == 12:
            break
        time.sleep(0.05)
    rs.stop(drain=True)
    rs.join(30.0)
    finished = {e.req_id for e in events if e.kind == "finished"}
    assert finished == {r.req_id for r in reqs}          # zero lost
    assert not [e for e in events if e.kind == "error"]
    assert rs.n_replicas == 1                            # survivor only
    assert len(rs.failure_events) == 1
    fe = rs.failure_events[0]
    assert fe["reason"] == "process exited" and fe["readmitted"] >= 1
    assert sum(m.snapshot()["replica_failures"]
               for m in rs.metrics_bank.values()) == 1


# ---------------------------------------------------------------------------
# warm seeding routed through the connector channel API
# ---------------------------------------------------------------------------

def _seed_pages(n):
    return [{"hash": i, "k": np.full((4, 8), i, np.float32),
             "v": np.full((4, 8), -i, np.float32)} for i in range(n)]


def test_scale_up_warm_seeds_over_connector():
    spec = EngineSpec("repro_torch.engine.stub_engine:make_seedable",
                      {"name": "s", "pages": 0})
    conn = SharedMemoryConnector(cross_process=True)
    rs = ReplicaSet("s", [None], lambda st, ev: None,
                    isolation="process", engine_spec=spec,
                    seed_connector=conn)
    rs.start()
    w0 = rs.workers()[0][1]
    assert w0.wait_ready(30.0)
    assert w0.seed_snapshot(_seed_pages(6)) == 6         # warm the donor
    rid = rs.scale_up()
    try:
        assert rs.seed_events == [{"rid": rid, "donor_pages": 6,
                                   "pages": 6, "via": "manifest"}]
        snap = rs._replicas[rid].prefix_snapshot()
        assert len(snap) == 6
        for p in snap:                   # byte-equal to the donor's
            assert np.array_equal(
                p["k"], np.full((4, 8), p["hash"], np.float32))
            assert np.array_equal(
                p["v"], np.full((4, 8), -p["hash"], np.float32))
    finally:
        rs.stop()
        rs.join(30.0)
    assert conn.resident_bytes == 0      # seed payload fully released


def test_warm_seed_failure_degrades_to_cold_start():
    class RefusingConnector(SharedMemoryConnector):
        def send(self, key, payload, **kw):
            raise RuntimeError("transport down")

    spec = EngineSpec("repro_torch.engine.stub_engine:make_seedable",
                      {"name": "s", "pages": 0})
    rs = ReplicaSet("s", [None], lambda st, ev: None,
                    isolation="process", engine_spec=spec,
                    seed_connector=RefusingConnector(cross_process=True))
    rs.start()
    w0 = rs.workers()[0][1]
    assert w0.wait_ready(30.0)
    assert w0.seed_snapshot(_seed_pages(3)) == 3
    rid = rs.scale_up()                  # advisory: must not raise
    try:
        assert rs.n_replicas == 2
        assert rs._replicas[rid].prefix_snapshot() == []     # cold start
    finally:
        rs.stop()
        rs.join(30.0)


# ---------------------------------------------------------------------------
# metrics-driven scaling controller (thread replicas of in-process stubs)
# ---------------------------------------------------------------------------

class _Stub:
    """One finished event per queued item, optional per-step dwell."""

    def __init__(self, name, delay=0.0):
        self.name = name
        self.delay = delay
        self.q = []
        self.busy_time = 0.0

    def enqueue(self, req_id, inputs, sampling, data):
        self.q.append((req_id, dict(inputs)))

    @property
    def has_work(self):
        return bool(self.q)

    @property
    def queue_depth(self):
        return len(self.q)

    def step(self):
        if not self.q:
            return []
        if self.delay:
            time.sleep(self.delay)
        self.busy_time += self.delay
        rid, inp = self.q.pop(0)
        return [StageEvent(rid, "finished", {"x": inp.get("x", 0) + 1},
                           stage=self.name)]


def _single_stage(n_replicas, delay=0.0, factory=False):
    graph = StageGraph()
    graph.add_stage(StageSpec("s", "custom", is_output=True))
    engines = {"s": [_Stub("s", delay) for _ in range(n_replicas)]}
    stages = ({"s": StageConfig(engine_factory=lambda: _Stub("s", delay))}
              if factory else {})
    return Orchestrator(graph, engines, config=ServeConfig(
        routing="least_loaded", stages=stages))


def _submit(orch, n):
    reqs = [Request(inputs={"x": 0}) for _ in range(n)]
    for r in reqs:
        orch.submit(r)
    return reqs


def _tick_until_action(ctl, windows=30):
    ctl.tick()                               # baseline measurement window
    for _ in range(windows):
        time.sleep(0.1)
        action = ctl.tick()
        if action:
            return action
    return None


def test_autoscale_moves_replica_to_bottleneck():
    graph = StageGraph()
    graph.add_stage(StageSpec("pre", "custom"))
    graph.add_stage(StageSpec("gen", "custom", is_output=True))
    graph.add_edge("pre", "gen", lambda d, p: {"x": p["x"]})
    engines = {"pre": [_Stub("pre", 0.001) for _ in range(2)],
               "gen": [_Stub("gen", 0.02) for _ in range(2)]}
    orch = Orchestrator(graph, engines, config=ServeConfig(
        routing="least_loaded",
        stages={"pre": StageConfig(engine_factory=lambda: _Stub("pre", 0.001)),
                "gen": StageConfig(engine_factory=lambda: _Stub("gen", 0.02))}))
    ctl = ScalingController(orch, ScalingConfig(interval=0.1, cooldown=0,
                                                replica_budget=4))
    orch.start()
    reqs = _submit(orch, 30)
    action = _tick_until_action(ctl)
    assert action is not None, "controller never acted on the bottleneck"
    assert action["kind"] == "move" and action["stage"] == "gen"
    assert action["donor"] == "pre"
    assert orch.replica_counts() == {"pre": 1, "gen": 3}
    assert ctl.actions and ctl.actions[-1]["replicas"]["gen"] == 3
    assert orch.drain(timeout=60.0)
    orch.shutdown()
    assert all(r.completion_time is not None and not r.failed for r in reqs)
    assert orch.stage_metrics()["gen"]["finished"] == 30


def test_autoscale_add_uses_budget_headroom():
    orch = _single_stage(1, delay=0.02, factory=True)
    ctl = ScalingController(orch, ScalingConfig(interval=0.1, cooldown=0,
                                                replica_budget=2))
    orch.start()
    reqs = _submit(orch, 20)
    action = _tick_until_action(ctl)
    assert action is not None and action["kind"] == "add"
    assert orch.replica_counts() == {"s": 2}
    assert orch.drain(timeout=60.0)
    orch.shutdown()
    assert all(not r.failed for r in reqs)


def test_autoscale_respects_budget_and_factory_gate():
    # no factory: the controller must never act, however hot the stage is
    orch = _single_stage(1, delay=0.02, factory=False)
    ctl = ScalingController(orch, ScalingConfig(interval=0.1, cooldown=0,
                                                replica_budget=4))
    orch.start()
    reqs = _submit(orch, 10)
    ctl.tick()
    time.sleep(0.15)
    assert ctl.tick() is None
    assert orch.replica_counts() == {"s": 1}
    assert orch.drain(timeout=60.0)
    orch.shutdown()
    assert all(not r.failed for r in reqs)
    # a full budget: no headroom to add into, and no other stage to donate
    orch = _single_stage(1, delay=0.02, factory=True)
    ctl = ScalingController(orch, ScalingConfig(interval=0.1, cooldown=0,
                                                replica_budget=1))
    orch.start()
    reqs = _submit(orch, 10)
    assert _tick_until_action(ctl, windows=3) is None
    assert orch.replica_counts() == {"s": 1}
    assert orch.drain(timeout=60.0)
    orch.shutdown()
    assert all(not r.failed for r in reqs)


def test_scaling_action_log_is_a_safe_copy():
    orch = _single_stage(1)
    ctl = ScalingController(orch)
    assert orch._scaler is ctl               # orch.shutdown() stops it first
    assert ctl.action_log() == []
    assert ctl.action_log() is not ctl.actions
    with ctl._lock:
        pass                                 # the lock exists and is free


# ---------------------------------------------------------------------------
# PD with the decode stage in a spawned process (device "cpu" in the spec)
# ---------------------------------------------------------------------------

PD_LENS = (5, 19, 33, 12)


def _pd_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 500, size=n).astype(np.int32) for n in PD_LENS]


def _unified_tokens(cfg, params, prompts, max_new):
    eng = AREngine("u", cfg, params, kv=_kv(4), max_batch=4,
                   default_sampling=SamplingParams(max_new_tokens=max_new,
                                                   temperature=0.0))
    for i, p in enumerate(prompts):
        eng.enqueue(i, {"tokens": p}, SamplingParams(), {})
    out = {}
    for _ in range(500):
        for ev in eng.step():
            if ev.kind == "finished":
                out[ev.req_id] = list(ev.payload["tokens"])
        if not eng.has_work:
            break
    return [out[i] for i in range(len(prompts))]


def _serve_pd(config=None):
    graph, engines, bundle = build_pd_disaggregated(max_batch=4, max_new=8, device="cpu")
    orch = Orchestrator(graph, engines, config=config)
    reqs = [Request(inputs={"tokens": p}) for p in _pd_prompts()]
    for r in reqs:
        orch.submit(r)
    done = orch.run(timeout=120.0)
    assert len(done) == 4 and not any(r.failed for r in done)
    return [list(r.outputs["decode"][0]["tokens"]) for r in reqs], orch, bundle


def test_pd_process_isolated_decode_matches_threads_and_unified():
    spec = build_pd_disaggregated(max_batch=4, max_new=8,
                                  device="cpu")[2]["engine_specs"]["decode"]
    assert spec.kwargs["device"] == "cpu" and spec.kwargs["temperature"] == 0.0
    config = ServeConfig(stages={"decode": StageConfig(isolation="process",
                                                       engine_spec=spec)})
    proc_tokens, orch, bundle = _serve_pd(config)
    assert orch._proc_replicas == {"decode": 1}
    m = orch.stage_metrics()["decode"]
    assert m["finished"] == 4 and m["replica_failures"] == 0
    thread_tokens, _, _ = _serve_pd()
    want = _unified_tokens(bundle["cfg"], bundle["params"], _pd_prompts(), 8)
    assert proc_tokens == thread_tokens == want
    assert all(len(t) == 8 for t in want)
