"""Share of the window's ``model.decode`` spans of the output stage whose
``PagedRunner.decode`` call replayed a captured CUDA graph (the
``graph_replays`` the runner notes on the span), in percent, the
profiled slice's spans included.  Nothing for a program that notes no
graph on any span it holds, capture or replay (one without the graph,
or one that ran every decode eagerly)."""
from omnibench.metrics import _program


def read(measured):
    if not any("graph_replays" in s.counts or "graph_captures" in s.counts
               for s in _program.recorded() if s.name == "model.decode"):
        return None
    spans = _program.spans(measured, "model.decode", slice_too=True)
    if not spans:
        return None
    return 100.0 * sum(1 for s in spans if s.counts.get("graph_replays")) / len(spans)
