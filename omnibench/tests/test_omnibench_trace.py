"""The readers of the program's own spans and stamps: a traced run of the
MoE cell on the CPU prints each of them (the kernel launches need the
card), the program's delivery stamps agree with the benchmark's, and a
program without the tracer gives every reader nothing to read."""
from types import SimpleNamespace
from unittest import mock

import pytest

import cpu_cell
from omnibench import harness, spec
from repro_torch.core import metrics as program_metrics

NEW = ["engine.step_ms", "engine.host_self_ms", "engine.syncs_per_step",
       "engine.decode_inputs_ms", "model.decode_host_ms", "device.launches_per_step",
       "router.deliver_lag_p90_ms"]
CARD_ONLY = {"device.launches_per_step"}


@pytest.fixture(scope="module")
def traced():
    """One traced CPU run of the MoE cell: (result line, what it measured)."""
    seen = {}
    real = harness.report

    def keep(measured):
        seen["measured"] = measured
        real(measured)

    with mock.patch.object(harness, "report", keep):
        res = cpu_cell.run("moe_qwen3.decode_closed", seed=3000000019, seconds=3.0, trace=1)
    return res, seen["measured"]


def test_a_traced_run_prints_every_new_metric(traced):
    res, _ = traced
    assert res["correct"], res["compared"]
    names = {m["name"] for m in spec.cell(spec.load_benchmark(),
                                          "moe_qwen3.decode_closed").per_layer}
    assert set(NEW) <= names
    printed = res["metrics"]
    for name in NEW:
        assert (name in printed) == (name not in CARD_ONLY), name
    m = {k: v["value"] for k, v in printed.items()}
    assert 0 < m["engine.host_self_ms"] <= m["engine.step_ms"]
    assert 0 < m["engine.decode_inputs_ms"] < m["engine.step_ms"]
    assert 0 < m["model.decode_host_ms"] < m["engine.step_ms"]
    # one read per active row and one for the batch's one sampling group at
    # least; a step that finishes a prompt reads its first token too
    assert m["engine.syncs_per_step"] >= m["engine.decode_rows_per_step"] + 1
    assert m["router.deliver_lag_p90_ms"] >= 0


def test_program_delivery_stamps_agree_with_the_benchmarks(traced):
    _, measured = traced
    gaps = []
    for r in measured.records:
        times = r.req.chunk_times
        assert [n for _, _, n in times] == [n for _, n in r.stamps]
        for (t_prog, t_emit, _), (t_bench, _) in zip(times, r.stamps):
            assert t_emit <= t_prog <= t_bench     # the benchmark stamps after the router
            gaps.append(t_bench - t_prog)
    assert gaps and sum(gaps) / len(gaps) <= 1e-3


def test_readers_give_nothing_for_a_program_without_the_tracer(traced, monkeypatch):
    _, measured = traced
    monkeypatch.delattr(program_metrics, "spans")
    bare = [SimpleNamespace(**{**vars(r), "req": SimpleNamespace()}) for r in measured.records]
    monkeypatch.setattr(measured, "records", bare)
    for name in NEW:
        assert spec.load_module("metrics", name).read(measured) is None, name


@pytest.mark.parametrize("kernels", [0, 3000])
def test_launches_read_whether_or_not_the_slice_kept_its_kernel_records(traced, kernels,
                                                                        monkeypatch):
    """CUPTI can drop a slice's kernel records and keep the host's launch
    calls: the launch count still reads, where the device-time readers
    fall silent."""
    from omnibench import probes
    _, measured = traced
    steps = [s for s in program_metrics.spans
             if s.name == "engine.step" and measured.in_window(s.t0)]
    t0, t1 = steps[0].t0, steps[len(steps) // 2].t0
    began = sum(t0 <= s.t0 <= t1 for s in steps)
    p = probes.Profile(1.0, t0, t1, 0.5, {}, {}, kernels, 6000, [])
    assert p.complete is bool(kernels)
    monkeypatch.setattr(measured.window, "profile", p)
    read = spec.load_module("metrics", "device.launches_per_step").read(measured)
    assert read == pytest.approx(6000 / began)
    idle = spec.load_module("metrics", "device_idle_pct.decode").read(measured)
    assert (idle is None) == (not kernels)
