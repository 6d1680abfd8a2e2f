"""Checkpointing: flat-key npz snapshots of params + optimizer state, in
the JAX package's format (``train/checkpoint.py``), so that a checkpoint
written by either package loads in the other.

Keys: ``params/<path>``, ``opt/mu/<path>``, ``opt/nu/<path>``,
``opt/step`` and ``meta/step``, a path being the dict keys joined by
``/``.  bf16 is stored as a 2-byte void view of its bits, which is what
numpy writes for the JAX package's ``ml_dtypes`` bfloat16 arrays and
what its ``load`` views back (the port has no ``ml_dtypes``).  Tensors on
the card are copied to the host to be saved, and restored onto their
template's device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_VOID2 = np.dtype("V2")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_VOID2)
    return t.numpy()


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def save(path: str, params, opt_state=None, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        flat.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    flat["meta/step"] = np.asarray(step)
    np.savez(path, **flat)


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype, shape and device
    (cast, as the JAX package's ``jnp.asarray(arr, dtype=...)`` does)."""
    if arr.dtype.kind == "V":                       # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(like.dtype).reshape(like.shape).to(like.device)


def load(path: str, params_template, opt_template=None):
    """Restore into the structure, dtypes and devices of the templates.
    Returns (params, opt_state or None, step)."""
    data = np.load(path)

    def restore(template, prefix):
        if isinstance(template, dict):
            return {k: restore(v, f"{prefix}{k}/") for k, v in template.items()}
        return _from_numpy(data[prefix[:-1]], template)

    params = restore(params_template, "params/")
    opt = restore(opt_template, "opt/") if opt_template is not None else None
    return params, opt, int(data["meta/step"])
