"""Share of the profiled slice of the window in which no kernel, copy or
memset ran on the card."""
from omnibench import readers


def read(measured):
    return readers.idle_pct(measured)
