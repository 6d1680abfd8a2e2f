"""Share of the prefill chunks of the output stage, over the window's
``engine.prefill`` phases (the profiled slice's included), that replayed
the runner's captured CUDA graph: each ``PagedRunner.prefill_chunk``
call notes on its phase ``prefill_graph_replays``,
``prefill_graph_captures`` or ``prefill_eager``, so 100 x replays /
(replays + captures + eager).  Nothing for a program that notes none of
the three (one without the graph)."""
from omnibench.metrics import _program

NOTES = ("prefill_graph_replays", "prefill_graph_captures", "prefill_eager")


def read(measured):
    spans = _program.spans(measured, "engine.prefill", slice_too=True)
    chunks = {k: sum(s.counts.get(k, 0) for s in spans) for k in NOTES}
    total = sum(chunks.values())
    return 100.0 * chunks["prefill_graph_replays"] / total if total else None
