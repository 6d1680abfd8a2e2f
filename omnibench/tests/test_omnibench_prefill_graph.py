"""The reader of the prefill graph's share on planted spans, beside
``test_omnibench_decode_graph.py``'s of the decode graph's:
``model.prefill_graph_share`` with every chunk replayed, some, none, and
a program that notes none of the three."""
from collections import deque
from types import SimpleNamespace

import pytest

from omnibench import spec
from repro_torch.core import metrics as program_metrics

STAGE = "thinker"


def _measured():
    return SimpleNamespace(records=[SimpleNamespace(stage=STAGE)], profile=None,
                           in_window=lambda t: 10.0 <= t < 20.0)


def _prefill(t0, engine=STAGE, **counts):
    return program_metrics.Span("engine.prefill", engine, t0, t0 + 0.05, 0,
                                counts={"mixed_weight_bytes": 1e9, **counts})


def _read(spans, monkeypatch):
    monkeypatch.setattr(program_metrics, "spans", deque(spans))
    return spec.load_module("metrics", "model.prefill_graph_share").read(_measured())


@pytest.mark.parametrize("replays,captures,eager,want", [
    (8, 0, 0, 100.0), (5, 1, 2, 62.5), (0, 0, 4, 0.0)], ids=["all", "mix", "none"])
def test_the_share_of_the_windows_prefill_chunks_that_replayed(replays, captures, eager, want,
                                                               monkeypatch):
    # the warm-up's capture falls before the window, another engine's
    # chunks and those after it count for nothing; a step of two chunks
    # notes both on its one phase
    spans = [_prefill(1.0, prefill_graph_captures=1), _prefill(2.0, prefill_graph_replays=1),
             _prefill(12.0, engine="other", prefill_eager=1), _prefill(25.0, prefill_eager=1)]
    kinds = (["prefill_graph_replays"] * replays + ["prefill_graph_captures"] * captures
             + ["prefill_eager"] * eager)
    spans += [_prefill(11.0 + i, **{k: 1}) for i, k in enumerate(kinds[2:])]
    spans.append(_prefill(19.5, **{k: kinds[:2].count(k) for k in set(kinds[:2])}))
    assert _read(spans, monkeypatch) == pytest.approx(want)


def test_a_program_that_notes_no_prefill_chunk_reads_nothing(monkeypatch):
    assert _read([_prefill(11.0 + i, mamba_resets=1) for i in range(5)], monkeypatch) is None
    monkeypatch.delattr(program_metrics, "spans")
    assert spec.load_module("metrics", "model.prefill_graph_share").read(_measured()) is None
