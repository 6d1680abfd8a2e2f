"""Where the port runs: on the card unless the caller asks for the CPU,
and on which CUDA stream an engine issues its work."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, defaulting to ``cuda``.  A CUDA
    device that is not there raises: nothing moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def engine_stream(device: torch.device):
    """A CUDA stream of an engine's own on a CUDA ``device`` (None on the
    CPU).  It first waits for the work queued so far on the calling
    thread's stream (the engine's weights and pools are made there)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def on_stream(stream):
    """A context that makes ``stream`` the calling thread's current stream
    (nothing on the CPU, where ``stream`` is None)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)
