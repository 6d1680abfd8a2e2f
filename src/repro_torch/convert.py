"""Carry a parameter tree of the JAX package into the port.

The JAX package keeps parameters as nested dicts whose leaves are arrays,
with the layers of a model stacked along a leading axis; the port keeps
the same layout, so converting is one tensor per leaf (a MoE block's
``moe.router`` stays f32, its ``wg``/``wu``/``wd`` expert stacks keep
the model dtype, as in the JAX tree).  The caller hands
over numpy arrays (``jax.tree.map(np.asarray, params)``), so nothing here
imports JAX.  bf16 leaves arrive as ``ml_dtypes`` bfloat16 arrays, which
``torch.from_numpy`` rejects: they are detected by dtype name and carried
bit for bit through a 16-bit integer view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(arr: Any, device="cpu") -> torch.Tensor:
    # a copy: arrays that come from JAX are read-only, and the port owns its weights
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """The same tree with every numpy leaf a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
