"""Percentiles over every request, and the window's arithmetic."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from omnibench import readers, spec, stats
from omnibench.harness import Measured, Record, Window


def test_pct_is_numpy_linear_over_every_value():
    xs = list(np.random.default_rng(0).random(37))
    for p in (50, 90, 95):
        assert stats.pct(xs, p) == pytest.approx(float(np.percentile(xs, p)))


def test_failed_requests_count_in_the_tail():
    xs = [1.0] * 19 + [math.inf]
    assert stats.pct(xs, 90) == pytest.approx(1.0)
    assert stats.pct(xs, 95) == math.inf
    assert stats.pct([1.0] * 9 + [math.inf], 90) == math.inf


def test_spread():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)


def _req(done=True, failed=None):
    return SimpleNamespace(completion_time=1.0 if done else None, failed=failed,
                           queue_delays={}, outputs={})


def _measured(records, loop, t_open=10.0, seconds=5.0):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, "moe_qwen3.decode_closed")
    return Measured(cell=cell, model=cell.config["model"], serve=cell.config["serve"],
                    seconds=seconds, window=Window(t_open, t_open + seconds, loop, [0.0]),
                    setup_s=1.0, records=records, spans=[], stage_metrics={},
                    connector_stats={}, moe_drops=None)


def test_window_counts_tokens_received_inside_it():
    reader = spec.load_module("metrics", "output_tok_per_s")
    a = Record(_req(), 9.0, 9.0, 5, True, "decode",
               stamps=[(9.5, 1), (10.0, 1), (12.0, 1), (14.99, 1), (15.0, 1)])
    b = Record(_req(done=False), 11.0, 11.0, 50, True, "decode",
               stamps=[(11.5, 1), (13.0, 1)])
    m = _measured([a, b], "closed")
    assert reader.read(m) == pytest.approx(5 / 5.0)


def test_ttft_and_tpot_from_due_instants():
    a = Record(_req(), 10.0, 10.2, 3, True, "decode", stamps=[(11.0, 1), (11.5, 1), (12.0, 1)])
    b = Record(_req(failed="boom"), 11.0, 11.0, 3, True, "decode", stamps=[])
    m = _measured([a, b], "open")
    assert m.latency(a, "first") == pytest.approx(1.0)
    assert m.latency(b, "first") == math.inf
    assert readers.per_request_tpot_s(m, a) == pytest.approx(0.5)
    assert spec.load_module("metrics", "ttft_p90_s").read(m) == math.inf
    assert m.failed == 1


def test_profile_busy_time_ops_and_idle_gaps():
    from omnibench import probes
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 25},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 31, "dur": 15},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 35, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 70, "dur": 5}]}
    p = probes.summarize(trace, 1.0, 0.0, 1.0)
    assert p.busy_s == pytest.approx(45e-6)
    assert p.op_counts == {"k1": 2, "k2": 1, "copy": 1}
    assert p.op_seconds["k1"] == pytest.approx(15e-6)
    assert p.idle_gaps == [("cudaLaunchKernel", pytest.approx(20e-6)),
                           ("python", pytest.approx(10e-6))]
    assert p.kernels == 3 and p.launches == 1 and p.complete


@pytest.mark.parametrize("recorded,complete", [(0, False), (3, False), (5, True), (8, True)])
def test_a_slice_missing_most_launched_kernels_is_incomplete(recorded, complete):
    from omnibench import probes
    launches = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10 * i,
                 "dur": 2} for i in range(6)]
    launches += [{"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 10 * i + 3,
                  "dur": 2} for i in range(2)]
    kernels = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10 * i + 5, "dur": 4}
               for i in range(recorded)]
    p = probes.summarize({"traceEvents": launches + kernels}, 1.0, 0.0, 1.0)
    assert p.launches == 8 and p.kernels == recorded and p.complete is complete
