"""The tracer of the port's AR engine step (``repro_torch.core.metrics``),
on the CPU at a tiny MoE size through the threaded ``Orchestrator``: the
phases nest under their step, every device->host read is counted, each
streamed token carries its delivery stamps, the profiler sees the step's
ranges, the span store keeps its bound, and tracing leaves the tokens
as they are."""
import json
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.configs.pipelines import build_pd_disaggregated, tiny_lm
from repro_torch.core import metrics
from repro_torch.core.graph import StageGraph
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.request import Request
from repro_torch.core.stage import StageSpec
from repro_torch.engine.ar_engine import AREngine
from repro_torch.engine.kv_cache import PagedKVConfig
from repro_torch.models import transformer as T

torch.set_num_threads(1)

PHASES = {"engine.schedule", "engine.admit", "engine.prefill", "engine.decode_inputs",
          "model.decode", "engine.sample", "engine.emit"}
N_NEW = 6


@pytest.fixture(autouse=True)
def _fresh_spans(monkeypatch):
    """Each test reads only the spans of its own engines."""
    monkeypatch.setattr(metrics, "spans", deque(maxlen=metrics.MAX_SPANS))


def _serve(name, n_req=5, sampling=None, seed=0):
    """Serve ``n_req`` prompts through a one-stage MoE graph; returns
    (requests, engine, orchestrator, the spans this engine recorded)."""
    cfg = tiny_lm("moe", vocab=256).replace(arch_type="moe", num_experts=4,
                                            experts_per_token=2, d_ff=64)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    eng = AREngine(name, cfg, params, max_batch=4, stream_chunk=1,
                   kv=PagedKVConfig(num_pages=64, page_size=8, max_pages_per_seq=16))
    graph = StageGraph()
    graph.add_stage(StageSpec(name, "ar", is_output=True))
    orch = Orchestrator(graph, {name: eng})
    rng = np.random.default_rng(seed)
    sampling = sampling or (lambda i: {"temperature": 0.0})
    reqs = [Request(inputs={"tokens": rng.integers(0, 256, 9 + 3 * i).astype(np.int32)},
                    sampling={"max_new_tokens": N_NEW, **sampling(i)}) for i in range(n_req)]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=60.0)
    assert all(r.completion_time is not None and not r.failed for r in reqs)
    return reqs, eng, orch, [s for s in metrics.spans if s.engine == name]


def _tokens(reqs, stage):
    return [[int(t) for c in r.outputs[stage] for t in np.asarray(c["tokens"]).ravel()]
            for r in reqs]


def test_phases_nest_under_their_step_and_sum_to_no_more():
    reqs, eng, orch, spans = _serve("nest")
    steps = {s.id: s for s in spans if s.name == "engine.step"}
    assert len(steps) == eng.steps
    children = [s for s in spans if s.name != "engine.step"]
    assert {s.name for s in children} <= PHASES
    assert {"engine.schedule", "engine.prefill", "engine.decode_inputs", "model.decode",
            "engine.sample", "engine.emit"} <= {s.name for s in children}
    for step in steps.values():
        mine = sorted((s for s in children if s.parent == step.id), key=lambda s: s.t0)
        assert mine and mine[0].name == "engine.schedule"
        for s in mine:
            assert step.t0 <= s.t0 <= s.t1 <= step.t1
        for a, b in zip(mine, mine[1:]):
            assert a.t1 <= b.t0                 # one after another
        assert sum(s.seconds for s in mine) <= step.seconds
    assert all(s.parent in steps for s in children)
    # busy_time is the sum of the step spans; the operator's view sums the phases
    assert eng.busy_time == pytest.approx(sum(s.seconds for s in steps.values()))
    phases = orch.stage_metrics()["nest"]["step_phases"]
    for name in {s.name for s in children}:
        assert phases[name] == pytest.approx(sum(s.seconds for s in children
                                                 if s.name == name))


@pytest.mark.parametrize("groups", [1, 2])
def test_decode_step_syncs_are_its_rows_plus_its_sampling_groups(groups):
    sampling = (lambda i: {"temperature": 0.0}) if groups == 1 else (
        lambda i: {"temperature": 0.0} if i % 2 else {"temperature": 0.8, "top_k": 5})
    reqs, eng, orch, spans = _serve(f"syncs{groups}", sampling=sampling)
    steps = [s for s in spans if s.name == "engine.step"]
    decode_only = [s for s in steps if "rows" in s.counts and "prefill_tokens" not in s.counts]
    assert decode_only
    for s in decode_only:
        assert s.counts["sample_groups"] <= groups
        # a row reads nothing back: its embedding is gathered on the device
        assert s.counts["syncs"] == s.counts["sample_groups"]
        assert 0 <= s.counts["wait_s"] <= s.seconds
    if groups == 2:
        assert max(s.counts["sample_groups"] for s in decode_only) == 2
    # a prefill step reads each finished prompt's first token once more
    for s in steps:
        assert s.counts["syncs"] >= s.counts.get("sample_groups", 0)
    # the reads of enqueue (one embedding read per prompt) are counted apart
    phases = orch.stage_metrics()[f"syncs{groups}"]["step_phases"]
    assert phases["enqueue_syncs"] == len(reqs)
    assert phases["step_syncs"] == sum(s.counts["syncs"] for s in steps)


def test_one_chunk_time_per_streamed_token_emitted_before_delivery_in_order():
    reqs, eng, orch, spans = _serve("chunks")
    for r in reqs:
        times = r.chunk_times
        assert len(times) == N_NEW == sum(n for _, _, n in times)
        assert all(e is not None and e <= t for t, e, _ in times)
        assert [t for t, _, _ in times] == sorted(t for t, _, _ in times)
        assert [e for _, e, _ in times] == sorted(e for _, e, _ in times)
        assert r.first_output_time == times[0][0]


def test_profiler_sees_the_step_ranges_and_none_open_without_it(tmp_path, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    _serve("quiet", n_req=2)
    assert opened == []
    # the engine steps on the orchestrator's worker thread, whose operators
    # and ranges the profiler records only when told to watch every thread
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=every_thread) as prof:
        _serve("profiled", n_req=2)
    assert {"engine.step", "engine.schedule", "model.decode"} <= set(opened)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert PHASES - {"engine.admit"} <= annotated and "engine.step" in annotated
    # a phase's range lies inside its step's
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "engine.step"]
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == "model.decode":
            assert any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                       for s in steps)


def test_the_span_store_stays_at_its_bound(monkeypatch):
    monkeypatch.setattr(metrics, "spans", deque(maxlen=7))
    _serve("bounded", n_req=3)
    assert len(metrics.spans) == 7
    ids = [s.id for s in metrics.spans]
    assert ids == sorted(ids)                   # the newest kept


def test_greedy_tokens_are_the_same_with_tracing_off(monkeypatch):
    on, eng_on, _, spans_on = _serve("traced", seed=3)
    monkeypatch.setattr(metrics, "enabled", False)
    off, eng_off, orch_off, spans_off = _serve("untraced", seed=3)
    assert _tokens(on, "traced") == _tokens(off, "untraced")
    assert spans_on and spans_off == []
    # the engine's counters stay without the span records
    assert eng_off.busy_time > 0
    assert orch_off.stage_metrics()["untraced"]["step_phases"]["model.decode"] > 0


def test_pd_admission_times_the_injection_without_a_sync():
    cfg = tiny_lm("pd_trace", vocab=256)
    graph, engines, _ = build_pd_disaggregated(cfg, max_batch=2, max_new=4,
                                               device="cpu", seed=2)
    orch = Orchestrator(graph, engines)
    rng = np.random.default_rng(2)
    reqs = [Request(inputs={"tokens": rng.integers(0, 256, n).astype(np.int32)})
            for n in (7, 15, 22)]
    for r in reqs:
        orch.submit(r)
    orch.run(timeout=60.0)
    dec = engines["decode"]
    admit = [s for s in metrics.spans if s.engine == dec.name and s.name == "engine.admit"]
    assert dec.kv_injects == 3 and dec.kv_inject_time > 0
    assert dec.kv_inject_time == pytest.approx(sum(s.seconds for s in admit))
