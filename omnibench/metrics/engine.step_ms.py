"""Mean host time of the AR engine's steps in the window, outside the
profiled slice (the program's ``engine.step`` spans: ``AREngine.step``
from its call to its return, on ``time.perf_counter()``)."""
from omnibench.metrics import _program


def read(measured):
    return _program.mean_ms([s.seconds for s in _program.spans(measured, "engine.step")])
