"""Tests that need the card (``-m card``; they skip without one).

The control: each cell served at its own size and window, its
sample judged by the f32 reference, and the same sample read through
the reference in fp8, the precision below the configuration's bf16.
The program's reading has to stay within the cell's limit and the
control's has to exceed it."""
import time

import pytest
import torch

from omnibench import harness, judge, spec, weights

pytestmark = pytest.mark.card
CONTROL_SECONDS = 51.0


def test_layers_are_drawn_again_the_same_on_the_card(card):
    m = spec.read_json(spec.ROOT / "omnibench/configs/qwen3_moe_30b_a3b.json")["model"]
    m = dict(m, num_layers=2)
    p = weights.program_params(m, 2**31 + 3, card)
    again = weights.layer(m, 2**31 + 3, 1, card)
    for group, leaves in again.items():
        for leaf, t in leaves.items():
            assert torch.equal(p["blocks"][group][leaf][1], t), (group, leaf)


@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_the_control_fails_where_the_program_passes(card, workload):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, workload)
    seed = 2**31 + 1234
    model, serve = dict(cell.config["model"]), dict(cell.config["serve"])
    sys_, measured = harness.serve_cell(cell, seed, CONTROL_SECONDS, False, card,
                                        time.perf_counter(), model, serve)
    harness.free(sys_)
    g = judge.gaps(cell.family, model, seed, judge.sample(measured.records, seed), card,
                   control=True)
    program, control = judge.statistics(g["program"]), judge.statistics(g["control"])
    named = [k for k in program if k in cell.limits]
    assert named
    assert all(program[k] <= cell.limits[k] for k in named), (program, cell.limits)
    assert any(control[k] > cell.limits[k] for k in named), (control, cell.limits)
