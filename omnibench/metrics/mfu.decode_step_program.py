"""The decode steps' share of the card's peak: the least time their inputs
need (the larger of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s, by the
cell's family's counts: weights read once, for a MoE only the experts the
step routed to, and each active row's KV context) over the steps' time,
summed over the window.  The experts each step routed to are the
program's: the ``routed_experts`` that ``PagedRunner.decode`` keeps on
the step's ``model.decode`` span (the distinct experts the active rows
routed to in each MoE layer, counted on the device, by a replayed CUDA
graph as by an eager step).  Each of the benchmark's decode spans takes
the program span of its engine that it lies in.  Nothing for a model
without experts, or for a program that keeps no such count."""
import bisect

from omnibench import readers
from omnibench.metrics import _program


def read(measured):
    if not measured.model.get("num_experts", 0):
        return None
    kept: dict = {}
    for s in _program.recorded():
        if s.name == "model.decode" and "routed_experts" in getattr(s, "kept", {}):
            kept.setdefault(s.engine, []).append(s)
    starts = {}
    for engine, spans in kept.items():
        spans.sort(key=lambda s: s.t0)
        starts[engine] = [s.t0 for s in spans]
    bound = secs = 0.0
    for step in readers.spans(measured, "decode"):
        i = bisect.bisect_right(starts.get(step.engine, []), step.t0) - 1
        if i < 0 or kept[step.engine][i].t1 < step.t1:
            continue
        routed = kept[step.engine][i].kept["routed_experts"].tolist()
        bound += readers.decode_bound_s(measured, step.meta["contexts"], routed)
        secs += step.seconds
    return 100.0 * bound / secs if secs > 0 else None
