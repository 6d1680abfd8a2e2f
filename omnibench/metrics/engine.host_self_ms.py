"""Mean host time of an engine step that the host spent on its own work:
the ``engine.step`` span less the time it waited in device->host reads
(its ``wait_s``), outside the profiled slice."""
from omnibench.metrics import _program


def read(measured):
    return _program.mean_ms([s.seconds - s.counts["wait_s"]
                             for s in _program.spans(measured, "engine.step")])
