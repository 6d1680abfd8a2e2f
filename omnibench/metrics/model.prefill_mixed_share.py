"""Share of the bf16 weight bytes that the prefill's f32 products took in
place, over the window's ``engine.prefill`` phases of the output stage
(the profiled slice's included): each f32 x bf16 product of the program
notes its weight bytes as ``mixed_weight_bytes`` when its kernel reads
them as bf16, or ``widened_weight_bytes`` when it widens them to an f32
copy first, so 100 x mixed / (mixed + widened).  Nothing for a program
that notes neither."""
from omnibench.metrics import _program


def read(measured):
    spans = _program.spans(measured, "engine.prefill", slice_too=True)
    mixed = sum(s.counts.get("mixed_weight_bytes", 0) for s in spans)
    widened = sum(s.counts.get("widened_weight_bytes", 0) for s in spans)
    return 100.0 * mixed / (mixed + widened) if mixed + widened else None
