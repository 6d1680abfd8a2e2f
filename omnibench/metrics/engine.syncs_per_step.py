"""Mean device->host reads of an engine step (its ``syncs``: the decode
rows' embedding reads, one per sampling group, one per prompt's first
token), over the steps in the window outside the profiled slice."""
from omnibench.metrics import _program


def read(measured):
    steps = _program.spans(measured, "engine.step")
    return sum(s.counts["syncs"] for s in steps) / len(steps) if steps else None
