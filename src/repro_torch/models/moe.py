"""Mixture-of-Experts layer: top-k routing with per-expert capacity,
sort-based dispatch (no (T, E, C) one-hot blowup), and the Switch-style
load-balance aux loss.

The formulation of the JAX package: gathers and scatters into a static
(E, C, d) buffer and three batched expert products over it.  On the
card, for f32 activations against bf16 experts (the prefill), the kept
pairs go instead through the grouped product of ``kernels/mixed_gemm.py``,
each expert over its own pairs only; which pairs are kept is the same.  Which
(token, expert) pairs overflow an expert's C slots and are dropped
depends on order, so the port keeps the JAX order exactly: a stable
argsort of the flat expert ids (``jnp.argsort`` is stable), and top-k
ties to the lower expert index (as ``jax.lax.top_k``).  The router and
its softmax run in f32.

Under a ``DistContext`` with ``moe_impl="ep"`` (``sharding/context.py``)
``moe_forward`` hands over to ``moe_ep.py``: each rank of the model axis
runs ``experts`` on its own slice of the experts, and one all-reduce
combines them.  Otherwise it is this dense-dispatch formulation, on
plain tensors or on DTensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import mixed_gemm
from repro_torch.models.layers import _dense_init, matmul, note_weight_bytes, torch_dtype

#: when a 0-d int64 tensor, every ``moe_forward`` adds the (token, expert)
#: pairs it dropped into it, on the device and without a sync (a
#: measurement hook; None, the default, counts nothing)
drop_counter: torch.Tensor | None = None


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The router over all ``router_width`` experts; the weights of the
    ``num_experts`` held here."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dtype = torch_dtype(cfg.dtype)
    return {
        "router": _dense_init(gen, (d, cfg.router_width), d, torch.float32),
        "wg": _dense_init(gen, (E, d, f), d, dtype),
        "wu": _dense_init(gen, (E, d, f), d, dtype),
        "wd": _dense_init(gen, (E, f, d), f, dtype),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.router_width
                  * cfg.capacity_factor)
    return max(8, min(c, tokens))


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates per row, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in [0, n), as a
    scatter-add of ones: the same integers, with a fixed output size, so
    that it also runs on meta tensors (the dry-run)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids))


def route(router: torch.Tensor, xf: torch.Tensor, k: int, renormalize: bool = True):
    """The router in f32: (gates (T, E), top-k weights (T, k), top-k expert
    ids (T, k)); the weights renormalised to sum to one, or as the softmax
    over all E gives them."""
    logits = matmul(xf.float(), router)                    # (T, E), f32
    gates = torch.softmax(logits, dim=-1)
    topw, topi = top_k(gates, k)                           # (T, k)
    if not renormalize:
        return gates, topw, topi
    return gates, topw / topw.sum(dim=-1, keepdim=True), topi


def experts(xf: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor, wg: torch.Tensor,
            wu: torch.Tensor, wd: torch.Tensor, e_lo: int, C: int, partial: bool = False):
    """The (token, expert) pairs of the experts [e_lo, e_lo + E_loc) held in
    ``wg``/``wu``/``wd`` (E_loc = wg.shape[0]; all of them in the dense
    path), each expert over C slots: (y (T, d), the pairs routed to each
    of those experts (E_loc,)).  Pairs of other experts sort last (id
    E_loc) and give nothing to y.  ``partial``: y is one rank's share of
    the combine, summed in f32 and not rounded to the activations' type
    (another rank's share is added to it first)."""
    T, d = xf.shape
    k = topi.shape[-1]
    E_loc = wg.shape[0]

    # ---- sort-based dispatch -------------------------------------------
    local = (topi >= e_lo) & (topi < e_lo + E_loc)
    e_flat = torch.where(local, topi - e_lo, E_loc).reshape(T * k)
    sort_idx = torch.argsort(e_flat, stable=True)          # (T*k,)
    e_sorted = e_flat[sort_idx]
    counts = bincount(e_flat, E_loc + 1)                   # (E_loc + 1,)
    offsets = torch.cumsum(counts, 0) - counts             # exclusive
    pos_in_e = torch.arange(T * k, device=xf.device) - offsets[e_sorted]
    tok = sort_idx // k                                    # source token id
    mine = e_sorted < E_loc
    keep = mine & (pos_in_e < C)
    if drop_counter is not None:
        drop_counter.add_((mine & ~keep).sum())

    # ---- expert compute: each kept pair's output, in sort order ---------
    if all(mixed_gemm.takes(xf, w) for w in (wg, wu, wd)):
        note_weight_bytes(True, 2 * (wg.numel() + wu.numel() + wd.numel()))
        y_sorted = _grouped_pairs(xf, tok, offsets, counts, wg, wu, wd, C)
    else:                                                  # its products note what they widen
        y_sorted = _buffer_pairs(xf, tok, e_sorted, pos_in_e, keep, wg, wu, wd, C)

    # ---- combine -------------------------------------------------------
    y_sorted = torch.where(keep[:, None], y_sorted, y_sorted.new_zeros(()))
    y_flat = xf.new_zeros((T * k, d)).index_put((sort_idx,), y_sorted.to(xf.dtype))
    y = y_flat.reshape(T, k, d) * topw[..., None].to(xf.dtype)
    y = y.float().sum(dim=1) if partial else y.sum(dim=1)
    return y, counts[:E_loc]


def _buffer_pairs(xf, tok, e_sorted, pos_in_e, keep, wg, wu, wd, C: int) -> torch.Tensor:
    """The pairs' outputs (T*k, d) in sort order through the (E_loc, C, d)
    capacity buffer and three batched products over the expert axis (the
    JAX package's formulation): every expert computes all C rows."""
    E_loc, d = wg.shape[0], xf.shape[1]
    # a dropped pair's row goes to one spare row past the buffer, which
    # nothing reads (the JAX package writes it out of bounds with mode="drop")
    row = torch.where(keep, e_sorted * C + pos_in_e, E_loc * C)
    buf = xf.new_zeros((E_loc * C + 1, d))
    buf[row] = xf[tok]
    buf = buf[:E_loc * C].view(E_loc, C, d)
    h = F.silu(matmul(buf, wg)) * matmul(buf, wu)
    y_buf = matmul(h, wd).reshape(E_loc * C, d)            # (E_loc*C, d)
    return y_buf[torch.clamp(e_sorted, max=E_loc - 1) * C
                 + torch.clamp(pos_in_e, max=C - 1)]


def _grouped_pairs(xf, tok, offsets, counts, wg, wu, wd, C: int) -> torch.Tensor:
    """The pairs' outputs (T*k, d) in sort order through the grouped
    f32 x bf16 product (``kernels/mixed_gemm.py``): each held expert
    computes its first min(count, C) pairs, the kept ones, and an expert
    without pairs reads none of its weights.  Rows of pairs not kept hold
    anything: the caller masks them."""
    g, u = mixed_gemm.grouped(xf, (wg, wu), tok, offsets, counts, C)
    return mixed_gemm.grouped(F.silu(g) * u, (wd,), None, offsets, counts, C)[0]


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, routes: list | None = None):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar f32).  ``routes``: a
    list that the dense dispatch appends its top-k expert ids (B*S, k) to
    (expert parallelism appends nothing).  With a share of the experts
    held (``cfg.router_experts``), the router scores all of them and y is
    the held experts' part, as one card of expert parallelism computes it
    before the exchange; the aux loss is that share's part too."""
    from repro_torch.models import moe_ep
    if moe_ep.ep_applicable(cfg):
        return moe_ep.moe_forward_ep(cfg, p, x)
    B, S, d = x.shape
    E, k, lo = cfg.num_experts, cfg.experts_per_token, cfg.expert_offset
    T = B * S
    xf = x.reshape(T, d)
    if cfg.renormalize_topk:                               # route's call as taps wrap it
        gates, topw, topi = route(p["router"], xf, k)
    else:
        gates, topw, topi = route(p["router"], xf, k, renormalize=False)
    if routes is not None:
        routes.append(topi)
    y, counts = experts(xf, topw, topi, p["wg"], p["wu"], p["wd"], lo, capacity(T, cfg))

    # ---- load-balance aux loss (Switch-style) --------------------------
    frac = counts.float() / (T * k)                        # dispatch fraction
    prob = gates.mean(dim=0)[lo:lo + E]                    # mean router prob
    aux = cfg.router_aux_coef * cfg.router_width * torch.sum(frac * prob)
    return y.reshape(B, S, d), aux
