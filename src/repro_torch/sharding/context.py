"""Distribution context: lets model code (the MoE layer) pick a
distribution-aware implementation when it runs on a mesh, without
threading mesh handles through every forward signature.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``.  ``moe_impl``
is ``"gspmd"`` (the dense dispatch of ``models/moe.py``, its DTensors'
placements propagated by DTensor as GSPMD propagates shardings) or
``"ep"`` (``models/moe_ep.py``: each rank of the ``model`` axis runs its
own slice of the experts, one all-reduce combines them).

The dry-run and the expert-parallel runs set it; the serving engines
leave it unset.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DistContext:
    mesh: object
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    moe_impl: str = "gspmd"          # "gspmd" | "ep" (expert-parallel)


_CTX: Optional[DistContext] = None


def set_context(ctx: Optional[DistContext]) -> None:
    global _CTX
    _CTX = ctx


def get_context() -> Optional[DistContext]:
    return _CTX


@contextmanager
def distribution(ctx: DistContext):
    prev = get_context()
    set_context(ctx)
    try:
        yield
    finally:
        set_context(prev)
