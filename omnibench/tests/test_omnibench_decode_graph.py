"""The readers of the decode graph's metrics on planted spans:
``model.decode_graph_share`` with every decode replayed, some, none, and
a program that notes no graph; ``mfu.decode_step_program`` with the
experts the program kept on each decode, without them, and in an eager
run on the CPU against the experts a tap on the router saw."""
import threading
import time
from collections import deque
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import cpu_cell
from omnibench import counts, harness, probes, spec
from repro_torch.core import metrics as program_metrics
from repro_torch.engine.runner import PagedRunner
from repro_torch.models import moe

STAGE = "thinker"


def _measured():
    return SimpleNamespace(records=[SimpleNamespace(stage=STAGE)], profile=None,
                           in_window=lambda t: 10.0 <= t < 20.0)


def _decode(t0, engine=STAGE, **counts):
    return program_metrics.Span("model.decode", engine, t0, t0 + 0.1, 0,
                                counts={"attn_host_s": 0.01, "ffn_host_s": 0.02, **counts})


def _read(spans, monkeypatch):
    monkeypatch.setattr(program_metrics, "spans", deque(spans))
    return spec.load_module("metrics", "model.decode_graph_share").read(_measured())


@pytest.mark.parametrize("replayed,want", [(10, 100.0), (4, 40.0), (0, 0.0)],
                         ids=["all", "mix", "none"])
def test_the_share_of_the_windows_decodes_that_replayed(replayed, want, monkeypatch):
    # the warm-up captured before the window; another engine's spans and
    # those outside the window count for nothing
    spans = [_decode(1.0, graph_captures=1), _decode(2.0, graph_replays=1),
             _decode(12.0, engine="other", graph_replays=1), _decode(25.0, graph_replays=1)]
    spans += [_decode(11.0 + i / 2, **({"graph_replays": 1} if i < replayed else {}))
              for i in range(10)]
    assert _read(spans, monkeypatch) == pytest.approx(want)


def test_a_program_that_notes_no_graph_reads_nothing(monkeypatch):
    assert _read([_decode(11.0 + i) for i in range(5)], monkeypatch) is None
    monkeypatch.delattr(program_metrics, "spans")
    assert spec.load_module("metrics", "model.decode_graph_share").read(_measured()) is None


# ---- mfu.decode_step_program ------------------------------------------------

MOE_MODEL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                 d_ff=32, vocab_size=512, num_experts=4, experts_per_token=2)
CELL = SimpleNamespace(family="transformer")


def _bench_decode(t0, contexts, engine=STAGE, seconds=0.05):
    return probes.Span("decode", engine, t0, t0 + 0.06, meta={"contexts": contexts},
                       device_s=seconds)


def _kept_decode(t0, routed, engine=STAGE):
    return program_metrics.Span("model.decode", engine, t0, t0 + 0.1, 0,
                                kept={"routed_experts": torch.tensor(routed)})


def _mfu(program_spans, bench_spans, monkeypatch, model=MOE_MODEL):
    monkeypatch.setattr(program_metrics, "spans", deque(program_spans))
    measured = SimpleNamespace(records=[SimpleNamespace(stage=STAGE)], profile=None,
                               in_window=lambda t: 10.0 <= t < 20.0, model=model,
                               spans=bench_spans, cell=CELL)
    return spec.load_module("metrics", "mfu.decode_step_program").read(measured)


def test_each_decode_takes_the_experts_its_program_span_kept(monkeypatch):
    # three steps in the window, each inside the program span of its own
    # engine (another engine's span at the same time keeps other experts);
    # a step outside the window and one that no kept span holds count for
    # nothing
    program = [_kept_decode(11.0, [3, 4]), _kept_decode(12.0, [1, 2]),
               _kept_decode(12.0, [4, 4], engine="other"), _kept_decode(25.0, [4, 4])]
    bench = [_bench_decode(11.01, [5, 9], seconds=0.04), _bench_decode(12.02, [17]),
             _bench_decode(12.02, [3], engine="other"), _bench_decode(25.01, [4]),
             _bench_decode(13.0, [8])]
    bound = (counts.bound_s(*counts.decode_step(MOE_MODEL, [5, 9], [3, 4]))
             + counts.bound_s(*counts.decode_step(MOE_MODEL, [17], [1, 2]))
             + counts.bound_s(*counts.decode_step(MOE_MODEL, [3], [4, 4])))
    assert _mfu(program, bench, monkeypatch) == pytest.approx(100.0 * bound / 0.14)
    # the experts' weights are most of what a step reads
    none = (counts.bound_s(*counts.decode_step(MOE_MODEL, [5, 9], [0, 0]))
            + counts.bound_s(*counts.decode_step(MOE_MODEL, [17], [0, 0]))
            + counts.bound_s(*counts.decode_step(MOE_MODEL, [3], [0, 0])))
    assert bound > 1.5 * none


def test_no_kept_experts_or_no_experts_reads_nothing(monkeypatch):
    bench = [_bench_decode(11.01, [5, 9])]
    assert _mfu([_decode(11.0)], bench, monkeypatch) is None
    assert _mfu([_kept_decode(11.0, [3, 4])], bench, monkeypatch,
                model=dict(MOE_MODEL, num_experts=0)) is None
    monkeypatch.delattr(program_metrics, "spans")
    measured = SimpleNamespace(records=[SimpleNamespace(stage=STAGE)], profile=None,
                               in_window=lambda t: 10.0 <= t < 20.0, model=MOE_MODEL,
                               spans=bench, cell=CELL)
    assert spec.load_module("metrics", "mfu.decode_step_program").read(measured) is None


def test_an_eager_cpu_run_reads_the_experts_the_router_chose(monkeypatch):
    """On the CPU every decode runs eagerly, so a tap on ``moe.route``
    sees each step's experts: the share that the reader takes from the
    program's count must equal the share worked out from the tap's."""
    local = threading.local()
    taps = []                                  # (call time, distinct experts per layer)
    route, decode = moe.route, PagedRunner.decode

    def tapped_route(router, xf, k):
        out = route(router, xf, k)
        if getattr(local, "ids", None) is not None:
            local.ids.append(out[2])
        return out

    def tapped_decode(self, embeds, tables, positions, active):
        t, local.ids = time.perf_counter(), []
        try:
            return decode(self, embeds, tables, positions, active)
        finally:
            rows = torch.as_tensor(np.nonzero(np.asarray(active, bool))[0])
            ids = torch.stack(local.ids)[:, rows].reshape(len(local.ids), -1)
            hit = torch.zeros(ids.shape[0], self.cfg.num_experts, dtype=torch.bool)
            taps.append((t, hit.scatter_(1, ids, True).sum(1).tolist()))
            local.ids = None

    monkeypatch.setattr(moe, "route", tapped_route)
    monkeypatch.setattr(PagedRunner, "decode", tapped_decode)
    seen = {}
    real = harness.report

    def keep(measured):
        seen["measured"] = measured
        real(measured)

    with mock.patch.object(harness, "report", keep):
        res = cpu_cell.run("moe_qwen3.decode_closed", seed=3000000021, seconds=2.0, trace=1)
    assert res["correct"], res["compared"]
    measured = seen["measured"]
    bound = secs = 0.0
    for step in [s for s in measured.spans if s.kind == "decode" and measured.in_window(s.t0)]:
        routed = next(r for t, r in taps if step.t0 <= t <= step.t1)
        bound += counts.bound_s(*counts.decode_step(measured.model, step.meta["contexts"], routed))
        secs += step.seconds
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["mfu.decode_step_program"] == pytest.approx(100.0 * bound / secs, rel=1e-9)
    assert m["mfu.decode_step_program"] > 0
