"""Prefill chunks a prompt took, over the window's ``engine.prefill``
phases of the output stage (the profiled slice's included): every chunk
of a model with Mamba layers notes ``mamba_resets`` (it began a prompt
from a zero state) or ``mamba_carries`` (it began from the state the
chunk before left), so (carries + resets) / resets.  Each chunk of the
port's prefill widens every weight to f32, so this count sets the
prefill's cost.  Nothing for a program that notes neither."""
from omnibench.metrics import _program


def read(measured):
    spans = _program.spans(measured, "engine.prefill", slice_too=True)
    resets = sum(s.counts.get("mamba_resets", 0) for s in spans)
    carries = sum(s.counts.get("mamba_carries", 0) for s in spans)
    return (resets + carries) / resets if resets else None
