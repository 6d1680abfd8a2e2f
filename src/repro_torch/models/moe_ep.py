"""Expert-parallel MoE: each rank of the model axis runs its own slice of
the experts (the JAX package's ``moe_ep.py``, a ``shard_map``).

Why: the dense formulation in moe.py sorts the GLOBAL token stream; with
tokens sharded over "data" a partitioner gathers the full activation set.

This variant keeps everything local:
  - tokens stay on their data shard (activations are replicated across the
    "model" axis, as in standard TP);
  - expert weights are sharded over the "model" axis (E_loc = E / tp);
  - each model rank dispatches ITS OWN slice of experts for the local
    tokens (local sort, local capacity) and computes partial outputs;
  - one all-reduce (JAX's ``psum``) over "model" combines the partial
    expert outputs: the same collective volume as a dense TP MLP, and no
    all-to-all.

Capacity semantics become per-(data-shard, expert): C comes from the
local token count T_loc = B_loc * S.

One difference from the JAX package, which psums y in the activations'
type: each rank's partial y stays in f32 and the all-reduce sums f32,
so y is rounded once, as the dense path rounds its combine once.  With
bf16 partial sums (two roundings) Qwen3-30B-A3B's layer 0 output
differed from the dense path's in 31.7% of its elements (one ulp) and
an exact tie of the first token flipped; with f32 partials its logits
were the dense path's bit for bit (on an H100; chip_smoke.py phase
ep_full_width).  The all-reduce then moves twice the bytes of bf16.

Two call forms compute the same thing: plain tensors, taken as this
rank's local tokens and local expert slices (ranks joined in
``torch.distributed``), and DTensors, through ``local_map`` with the
placements of the JAX ``shard_map`` (the dry-run).  The all-reduces are
differentiable: the gradient is all-reduced too, as JAX transposes
``psum``.
"""
from __future__ import annotations

import functools
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_base
from repro_torch.sharding import specs as S
from repro_torch.sharding.context import get_context

#: when a list, every all-reduce of ``moe_forward_ep`` runs between two
#: device syncs and appends its host seconds to it (a measurement hook;
#: None, the default, adds no sync)
allreduce_log: list | None = None


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``, out of place; the backward sums the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if allreduce_log is None:
        return _AllReduce.apply(t, group)
    _sync(t)
    t0 = time.perf_counter()
    out = _AllReduce.apply(t, group)
    _sync(out)
    allreduce_log.append(time.perf_counter() - t0)
    return out


def _local_moe(cfg: ModelConfig, x, router, wg, wu, wd, *, e_lo: int, model_group,
               dp_groups):
    """The per-rank body.  x: (B_loc, S, d) local tokens (replicated over
    the model axis); router: (d, E) replicated; wg/wu/wd: (E_loc, d, f)
    local experts.  ``dp_groups``: [(group, size)] of the data axes the
    batch is sharded over.  Returns (y (B_loc, S, d), aux)."""
    B, S_, d = x.shape
    T = B * S_
    E, k = cfg.num_experts, cfg.experts_per_token
    E_loc = wg.shape[0]
    xf = x.reshape(T, d)
    gates, topw, topi = moe_base.route(router, xf, k)
    y, counts = moe_base.experts(xf, topw, topi, wg, wu, wd, e_lo, moe_base.capacity(T, cfg),
                                 partial=True)
    # combine partial expert outputs across the model axis, in f32
    y = all_reduce(y, model_group).to(x.dtype)

    # load-balance aux (global fractions via the all-reduce): each model
    # rank fills only its expert slice, so the counts over all experts sum
    # to the local T*k dispatched pairs, with no double count
    full = torch.zeros((E,), dtype=torch.float32, device=x.device)
    full[e_lo:e_lo + E_loc] = counts.float()
    full = all_reduce(full, model_group)
    frac = full / (T * k)
    prob = gates.mean(dim=0)                     # local mean
    aux = cfg.router_aux_coef * E * torch.sum(frac * prob)
    n = 1
    for group, size in dp_groups:                # mean across the data shards
        aux = all_reduce(aux, group)
        n *= size
    return y.reshape(B, S_, d), aux / n if n > 1 else aux


def _groups(mesh, axes):
    """(group, size) of each of ``axes`` that has more than one rank."""
    return [(mesh.get_group(a), S.axis_size(mesh, a)) for a in axes or ()
            if S.axis_size(mesh, a) > 1]


def moe_forward_ep(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Drop-in replacement for moe.moe_forward when a DistContext asks for
    ``"ep"``.  DTensor inputs go through ``local_map`` (x sharded over the
    batch's data axes, the expert stacks over the model axis, the router
    and aux replicated); plain tensors are this rank's local tokens and
    experts, the batch taken as sharded over the context's data axes."""
    from torch.distributed.tensor import DTensor
    ctx = get_context()
    assert ctx is not None
    mesh = ctx.mesh
    model_group = mesh.get_group(ctx.model_axis)
    rank = mesh.get_local_rank(ctx.model_axis)
    E_loc = cfg.num_experts // S.axis_size(mesh, ctx.model_axis)
    if not isinstance(x, DTensor):
        dp = [a for a in ctx.data_axes if a in S.axis_names(mesh)]
        return _local_moe(cfg, x, p["router"], p["wg"], p["wu"], p["wd"], e_lo=rank * E_loc,
                          model_group=model_group, dp_groups=_groups(mesh, dp))
    from torch.distributed.tensor.experimental import local_map
    dp = S.batch_spec(mesh, x.shape[0])          # None if B doesn't divide
    xs = S.placements(mesh, S.P(dp, None, None))
    ws = S.placements(mesh, S.P(ctx.model_axis, None, None))
    rep = S.placements(mesh, S.P())
    fn = functools.partial(_local_moe, cfg, e_lo=rank * E_loc, model_group=model_group,
                           dp_groups=_groups(mesh, dp))
    mapped = local_map(fn, out_placements=(xs, rep), in_placements=(xs, rep, ws, ws, ws),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(x, p["router"], p["wg"], p["wu"], p["wd"])


def ep_applicable(cfg: ModelConfig) -> bool:
    ctx = get_context()
    return (ctx is not None and ctx.moe_impl == "ep"
            and cfg.num_experts % S.axis_size(ctx.mesh, ctx.model_axis) == 0)
