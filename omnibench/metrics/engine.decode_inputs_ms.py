"""Mean host time of building a decode step's inputs (the program's
``engine.decode_inputs`` spans: each active row's embedding read back one
at a time, the positions and tables, the copy to the device), outside
the profiled slice."""
from omnibench.metrics import _program


def read(measured):
    return _program.mean_ms([s.seconds
                             for s in _program.spans(measured, "engine.decode_inputs")])
