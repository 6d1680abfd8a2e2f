"""AdamW with a cosine learning-rate schedule, over the parameter trees
of the port (nested dicts of tensors).

The arithmetic of the JAX package's ``train/optimizer.py``: f32 moments,
a 0-d int32 step counter, the schedule and the bias corrections computed
in f32 tensors, clipping by the global norm, decoupled weight decay, and
each update cast back to its leaf's type.  Leaves are walked in sorted
key order, as JAX flattens dicts, so params, grads and moments line up
leaf for leaf.  ``adamw_update`` writes the new parameters and moments
into the given tensors (the JAX package returns new trees): a
full-width model is not held twice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

import torch

from repro_torch.models.layers import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine to 0, as a 0-d f32."""
    step = step.float()
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = next(leaves(params)).device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}); the
    parameters and moments are updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                            leaves(state["nu"])):
        g = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
