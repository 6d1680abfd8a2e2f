"""Kernel launches the host made in the profiled slice (the profiler's
``cudaLaunchKernel``/``cuLaunchKernel`` calls, every thread) over the
engine steps that began inside it.

It counts the host's launch calls, which the profiler keeps when CUPTI
drops the device's kernel records, so it does not wait for the slice to
read complete (``Profile.complete``), as the readers of device time do."""
from omnibench.metrics import _program


def read(measured):
    p = measured.profile
    if p is None or not p.launches:
        return None
    steps = [s for s in _program.spans(measured, "engine.step", slice_too=True)
             if p.t0 <= s.t0 <= p.t1]
    return p.launches / len(steps) if steps else None
