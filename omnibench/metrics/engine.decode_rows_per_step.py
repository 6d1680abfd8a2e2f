"""Mean active rows of the ``PagedRunner.decode`` calls in the window."""
from omnibench import readers


def read(measured):
    steps = readers.spans(measured, "decode")
    return sum(len(s.meta["contexts"]) for s in steps) / len(steps) if steps else None
