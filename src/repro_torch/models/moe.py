"""Mixture-of-Experts layer: top-k routing with per-expert capacity,
sort-based dispatch (no (T, E, C) one-hot blowup), and the Switch-style
load-balance aux loss.

The formulation of the JAX package: gathers and scatters into a static
(E, C, d) buffer and three batched expert products over it.  Which
(token, expert) pairs overflow an expert's C slots and are dropped
depends on order, so the port keeps the JAX order exactly: a stable
argsort of the flat expert ids (``jnp.argsort`` is stable), and top-k
ties to the lower expert index (as ``jax.lax.top_k``).  The router and
its softmax run in f32.

The JAX package's expert-parallel path (``moe_ep.py``, an all-to-all
under a sharding mesh) waits for the sharding slice of the port: with no
mesh there, ``moe_forward`` is always this dense-dispatch formulation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, matmul, torch_dtype

#: when a 0-d int64 tensor, every ``moe_forward`` adds the (token, expert)
#: pairs it dropped into it, on the device and without a sync (a
#: measurement hook; None, the default, counts nothing)
drop_counter: torch.Tensor | None = None


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> dict:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dtype = torch_dtype(cfg.dtype)
    return {
        "router": _dense_init(gen, (d, E), d, torch.float32),
        "wg": _dense_init(gen, (E, d, f), d, dtype),
        "wu": _dense_init(gen, (E, d, f), d, dtype),
        "wd": _dense_init(gen, (E, f, d), f, dtype),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, min(c, tokens))


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates per row, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar f32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = capacity(T, cfg)
    xf = x.reshape(T, d)

    logits = matmul(xf.float(), p["router"])               # (T, E), f32
    gates = torch.softmax(logits, dim=-1)
    topw, topi = top_k(gates, k)                           # (T, k)
    topw = topw / topw.sum(dim=-1, keepdim=True)           # renormalize

    # ---- sort-based dispatch -------------------------------------------
    e_flat = topi.reshape(T * k)
    sort_idx = torch.argsort(e_flat, stable=True)          # (T*k,)
    e_sorted = e_flat[sort_idx]
    counts = torch.bincount(e_flat, minlength=E)           # (E,)
    offsets = torch.cumsum(counts, 0) - counts             # exclusive
    pos_in_e = torch.arange(T * k, device=x.device) - offsets[e_sorted]
    tok = sort_idx // k                                    # source token id
    keep = pos_in_e < C
    if drop_counter is not None:
        drop_counter.add_((~keep).sum())

    # scatter into the (E, C, d) compute buffer: a dropped pair's row goes
    # to one spare row past the buffer, which nothing reads (the JAX
    # package writes it out of bounds with mode="drop")
    row = torch.where(keep, e_sorted * C + pos_in_e, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[row] = xf[tok]
    buf = buf[:E * C].view(E, C, d)

    # ---- expert compute (batched products over the expert axis) --------
    h = F.silu(matmul(buf, p["wg"])) * matmul(buf, p["wu"])
    y_buf = matmul(h, p["wd"]).reshape(E * C, d)           # (E*C, d)

    # ---- gather back + combine ----------------------------------------
    y_sorted = y_buf[e_sorted * C + torch.clamp(pos_in_e, max=C - 1)]
    y_sorted = torch.where(keep[:, None], y_sorted, y_sorted.new_zeros(()))
    y_flat = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    y_flat[sort_idx] = y_sorted.to(x.dtype)                # sort_idx is a permutation
    y = (y_flat.reshape(T, k, d) * topw[..., None].to(x.dtype)).sum(dim=1)

    # ---- load-balance aux loss (Switch-style) --------------------------
    frac = counts.float() / (T * k)                        # dispatch fraction
    prob = gates.mean(dim=0)                               # mean router prob
    aux = cfg.router_aux_coef * E * torch.sum(frac * prob)
    return y.reshape(B, S, d), aux
