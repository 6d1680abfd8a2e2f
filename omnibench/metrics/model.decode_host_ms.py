"""Mean host time of the engine's ``PagedRunner.decode`` call (the
program's ``model.decode`` spans: enqueueing every layer's kernels; the
card runs them meanwhile), outside the profiled slice."""
from omnibench.metrics import _program


def read(measured):
    return _program.mean_ms([s.seconds for s in _program.spans(measured, "model.decode")])
