"""The decode steps' share of the card's peak: the least time their inputs
need (the larger of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s; weights
read once, for a MoE only the experts the step routed to, and each
active row's KV context) over the steps' time, summed over the window."""
from omnibench import readers


def read(measured):
    steps = readers.spans(measured, "decode")
    secs = sum(s.seconds for s in steps)
    if not steps or secs <= 0:
        return None
    return 100.0 * sum(readers.decode_bound_s(measured.model, s) for s in steps) / secs
