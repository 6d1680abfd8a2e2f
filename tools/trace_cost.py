"""Host cost of the AR engine step's tracer (``repro_torch.core.metrics``),
per step, on the machine it runs on: the step's ``StepTrace`` with its
phases, and the timing of each device->host read, each timed over many
synthetic steps and compared with the same work untraced.

    PYTHONPATH=src python tools/trace_cost.py [--steps 20000] [--reads 1]

Prints one JSON object: microseconds per step of each part with
``enabled`` on and off, and ``perf_counter``'s own cost.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import deque

import torch

from repro_torch.core import metrics

PHASES = ("engine.decode_inputs", "model.decode", "engine.sample", "engine.emit")


def _per_step_us(fn, steps: int) -> float:
    fn(steps // 10)                                    # warm up
    t = time.perf_counter()
    fn(steps)
    return 1e6 * (time.perf_counter() - t) / steps


def scaffold(steps: int) -> None:
    """A step's trace: open, its phases, finish."""
    totals = metrics.StepTotals()
    for _ in range(steps):
        tr = metrics.StepTrace("cost", totals, "engine.schedule")
        tr.worked = True
        tr.counts["rows"] = 16
        for name in PHASES:
            tr.phase(name)
        tr.finish()


def reads(steps: int, n: int, x: torch.Tensor, traced: bool) -> None:
    """``n`` host reads a step (of a host tensor: the copy itself is nil)."""
    for _ in range(steps):
        with metrics.reads_into(metrics.Reads()):
            for _ in range(n):
                metrics.to_cpu(x) if traced else x.to("cpu")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--reads", type=int, default=1,
                    help="device->host reads a step (one a sampling group)")
    args = ap.parse_args()
    metrics.spans = deque(maxlen=metrics.MAX_SPANS)
    x = torch.zeros(1, dtype=torch.long)
    n, out = args.steps, {}
    out["perf_counter_us"] = _per_step_us(
        lambda k: [time.perf_counter() for _ in range(k)], n * 10)
    for enabled in (True, False):
        metrics.enabled = enabled
        key = "on" if enabled else "off"
        out[f"scaffold_us_{key}"] = _per_step_us(scaffold, n)
    metrics.enabled = True
    out["reads_us_traced"] = _per_step_us(lambda k: reads(k, args.reads, x, True), n)
    out["reads_us_plain"] = _per_step_us(lambda k: reads(k, args.reads, x, False), n)
    out["tracer_us_per_step"] = (out["scaffold_us_on"]
                                 + out["reads_us_traced"] - out["reads_us_plain"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
