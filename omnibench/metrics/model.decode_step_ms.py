"""Mean time of a ``PagedRunner.decode`` call in the window, from the call
to its logits being ready (its stream's span on the card)."""
from omnibench import readers


def read(measured):
    steps = readers.spans(measured, "decode")
    return 1e3 * sum(s.seconds for s in steps) / len(steps) if steps else None
