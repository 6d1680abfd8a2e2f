"""Multi-pod dry-run: every (arch x shape x mesh) stepped on meta DTensors.

Usage (no card, nothing allocated):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_14b \
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The counterpart of the JAX package's dry-run, which lowers and compiles
each step for the production mesh on forced host devices.  Here a fake
process group (``FakeStore``, backend "fake") of the mesh's world size
stands in for the cluster, this process is one rank of it (rank 0 unless
``--rank``), and the step runs eagerly on DTensors whose local tensors
live on the meta device: every shape and placement is real, no byte is
allocated and no collective moves data.  The meta device is the design,
not a fallback: the dry-run touches no card, as the JAX one runs on host
devices.  On meta tensors the kernel wrappers take their plain versions
(``ops._use_cuda`` is false), as the JAX dry-run's ``ops.get_backend``
picks ``ref`` off the TPU.

Arguments take their placements from the fitted specs of
``sharding/specs.py``: parameters (``param_specs``), optimizer moments
(``opt_specs``, ZeRO along "data" unless ``--no-zero``), inputs
(``input_specs``) and decode caches (``kv_cache_specs``).  The step is
the port's own: ``train/step.py: make_train_step``, ``forward_prefill``
(called without ``remat``: the port's prefill has none, and under
``no_grad`` it would change nothing) or ``forward_decode`` at position
``seq_len - 1``, under ``distribution(DistContext(...))``.  The plain
Mamba1 scan runs as ``ref.mamba1_scan_chunked`` on sequences longer than
64 (``chunked_mamba1_scan``): the step-by-step scan of a 4096-token train
shape is 64 times as many Python steps.  The Mamba2 scan takes its
chunked form there without help (``ops.mamba2_scan``).

``DryRunMode`` watches the step and places every op that can move bytes
or change a placement by its own rules, as GSPMD places it, so that no
byte it counts depends on DTensor's strategies (which move with the
torch version):
  - a product (``mm``, ``bmm``) shards a batch dim in both operands, or
    its output takes the right operand's sharded columns or the left's
    sharded rows (the other operand gathered); a contraction sharded in
    both (or in one, unless the output outgrows the operands) is summed
    right away, in f32 (``_product``);
  - a pointwise op (any op tagged so) merges its operands' shardings:
    the largest keeps its own and takes another's where it is
    replicated, the others move to it (``_pointwise``);
  - a view keeps a dim's shard through a merge (a minor dim's marked
    strided) or a split, and gathers it otherwise (``_view``); a view
    that moves, adds or drops dims carries each shard along (``_dims``,
    ``_unselect``, ``_unbind``); a new tensor made from one lies as it
    does, or replicated where its shape differs (``_fresh``);
  - a sum or mean over a sharded dim all-reduces its partial sums
    (``_reduce``); a softmax along a sharded dim all-reduces its maxima
    and sums (``_softmax``);
  - a slice, pad or flip along a sharded dim is counted as XLA's
    collective-permutes, a cumulative sum, sort or index_select as a
    gather of the dim, a concatenation along it as an all-to-all
    (``_along``, ``_cat``);
  - a gather along a sharded dim, and a lookup in rows that a mesh dim
    shards, take each rank's own range and sum the result (``_take``,
    ``_lookup``); a scatter-add sums each rank's updates (``_take``,
    ``_accumulate``); a scatter into unsharded rows keeps the values'
    other shards (``_scatter``, ``_put``); an in-place write into a
    sharded tensor (a decode step's cache column) stays on each rank's
    shard, its values replicated over the indexed dims (``_write_into``,
    ``_copy``).
Casts, clones and detaches stay with DTensor (a local op).  A collective that DTensor's own strategy
issues for an op is still counted, and its op in ``dtensor_ops``; an op
no rule places runs with its operands replicated over one mesh dim
(``resharded_ops``) or, failing that, the whole mesh
(``replicated_ops``).  All three are empty on every arch x shape.  The
math never changes: the placements decide only where each part is
computed and what crosses between ranks.

Each record keeps the JAX record's keys that have a counterpart:
``arch``, ``shape``, ``mesh``, ``moe_impl``, ``status``, ``reason``,
``attn_variant``, ``kv_cache_dtype``, ``remat``, ``padded_heads``,
``error``, ``traceback``; ``argument_size_in_bytes`` and
``output_size_in_bytes`` per device (the local shards' bytes);
``collective_bytes`` by kind (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``) and
``total``: the result bytes of each collective GSPMD would issue, the
JAX parser's convention.  It adds ``run_s`` (building the meta
arguments and running the step), ``collective_calls``, ``matmul_flops``
(per device, the products that ``torch.utils.flop_counter`` knows: not
XLA's ``flops``, which counts every op), ``dtensor_ops``,
``resharded_ops`` and ``replicated_ops``.

Left out, as XLA's alone: ``lower_s``, ``compile_s``,
``temp_size_in_bytes``, ``generated_code_size_in_bytes``, ``bytes``,
``uncorrected_total``, and the HLO parser ``collective_bytes`` with its
while-loop trip counts: the port's layer loop is Python, so every
collective is counted once per call and nothing needs correcting.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, shape_skips, variant_for_shape)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as S
from repro_torch.sharding.context import DistContext, distribution
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step

P = S.P

# collectives by the name of their op: the functional collectives that
# DTensor issues, and the c10d ops of torch.distributed's own calls
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _global_meta(a):
    """DTensors as plain meta tensors of their global shapes."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    if isinstance(a, (list, tuple)):
        return type(a)(_global_meta(x) for x in a)
    return a


def _dtensors(a):
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        return [a]
    if isinstance(a, (list, tuple)):
        return [t for x in a for t in _dtensors(x)]
    return []


def _shard_dim(p):
    """The tensor dim a placement shards, else None."""
    from torch.distributed.tensor import Shard
    return p.dim if isinstance(p, Shard) else None


def _replicated(t, mesh_dims=None):
    """``t``'s placements replicated over ``mesh_dims`` (every mesh dim if
    None)."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if mesh_dims is None or i in mesh_dims else p
            for i, p in enumerate(t.placements)]


def _summed(t):
    """``t``'s placements with its partial sums summed (replicated)."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial() else p for p in t.placements]


def _contiguous(shape, like=None) -> tuple:
    """The strides of a dense tensor of ``shape``: contiguous, or with its
    dims in the memory order of ``like`` (a local shard), so that a
    DTensor's global strides follow its local tensor's on every torch
    version."""
    order = (sorted(range(len(shape)), key=lambda d: -like.stride(d)) if like is not None
             else range(len(shape)))
    out, n = [0] * len(shape), 1
    for d in reversed(list(order)):
        out[d] = n
        n *= max(shape[d], 1)
    return tuple(out)


def _local_shape(t, placements) -> list:
    """This rank's shape of ``t`` under ``placements``: its local tensor's
    where they are ``t``'s own, else each sharded dim divided by its mesh
    dims' sizes, rounded up (rank 0's shard, XLA's padded one)."""
    if tuple(placements) == tuple(t.placements):
        return list(t.to_local().shape)
    shape = list(t.shape)
    for i, p in enumerate(placements):
        d = _shard_dim(p)
        if d is not None:
            shape[d] = -(-shape[d] // t.device_mesh.size(i))
    return shape


def _local_bytes(t, placements) -> int:
    return math.prod(_local_shape(t, placements)) * t.element_size()


def _moves(t, want) -> list:
    """(kind, bytes) of the collectives that take ``t`` to ``want``, one
    mesh dim after the other, each counted by its result as XLA's parser
    counts it: all-gather (a shard to replicated), all-to-all (a shard to
    another dim), all-reduce or reduce-scatter (a partial sum); a
    replicated tensor is sliced for nothing."""
    cur, out = list(t.placements), []
    for i, dst in enumerate(want):
        src = cur[i]
        if src == dst:
            continue
        local, n = _local_bytes(t, cur), t.device_mesh.size(i)
        cur[i] = dst
        if src.is_partial():
            out.append(("all-reduce", local) if dst.is_replicate()
                       else ("reduce-scatter", _local_bytes(t, cur)))
        elif _shard_dim(src) is not None:
            out.append(("all-gather", local * n) if dst.is_replicate()
                       else ("all-to-all", _local_bytes(t, cur)))
    return out


def _product(mode, func, args, kwargs):
    """``mm`` / ``bmm`` placed as GSPMD's dot handler places a product,
    mesh dim by mesh dim:
      - a batch dim sharded in either operand shards it in both;
      - else the output takes a column of the right operand, or a row of
        the left one, that the mesh dim shards, the other operand gathered
        there (the columns first: an activation sharded on its features
        is gathered for a weight sharded on its outputs);
      - else a contraction sharded in both operands, or in one whose
        output is no larger than the operands gathered (``_outgrows``), is
        sharded alike in both (a replicated operand is sliced for
        nothing), and each rank holds a partial sum: it is kept in f32
        (the product accumulates in f32), all-reduced at once in f32 and
        rounded once, the rule of the EP combine (``models/moe_ep.py``);
        XLA's partitioned HLO also all-reduces the partial sums of a bf16
        product in f32 on the CPU.  A mesh dim that replicates both
        operands then shards the summed output's columns (a slice of the
        right operand), so that the all-reduce moves a part of it.
    The local product runs on the local shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    a, b = args[:2]
    if (len(args) > 2 or kwargs or not (isinstance(a, DTensor) and isinstance(b, DTensor))
            or a.device_mesh != b.device_mesh
            or any(p.is_partial() and p != Partial() for p in (*a.placements, *b.placements))):
        return NotImplemented
    nd, rep = a.ndim, Replicate()
    dtype = torch.promote_types(a.dtype, b.dtype)
    pa, pb, out_p = list(a.placements), list(b.placements), []
    for i, (qa, qb) in enumerate(zip(a.placements, b.placements)):
        da, db = _shard_dim(qa), _shard_dim(qb)
        if da is not None and da < nd - 2 or db is not None and db < nd - 2:
            pa[i] = pb[i] = o = qa if da is not None and da < nd - 2 else qb
        elif db == nd - 1:
            pa[i], o = rep, qb
        elif da == nd - 2:
            pb[i], o = rep, qa
        elif da == nd - 1 or db == nd - 2:
            if (da == nd - 1) != (db == nd - 2) and _outgrows(a, b, i):
                pa[i] = pb[i] = o = rep
            else:
                pa[i], pb[i], o = Shard(nd - 1), Shard(nd - 2), Partial()
        elif qa.is_partial() or qb.is_partial():
            pb[i] = rep if qa.is_partial() else qb
            o = Partial()
        else:
            o = rep
        out_p.append(o)
    if any(p.is_partial() for p in out_p) and Shard(nd - 1) not in out_p:
        # a mesh dim that replicates both operands shards the summed
        # output's columns: GSPMD's all-reduce over "model" of an expert
        # product's partial sums, on a buffer that "data" replicates
        for i, o in enumerate(out_p):
            if o.is_replicate() and b.shape[-1] % b.device_mesh.size(i) == 0:
                pb[i] = out_p[i] = Shard(nd - 1)
                break
    # a strided shard (a merged batch and heads) of a batch dim, a's rows or
    # b's columns stays so in the output
    merged = {i: sf for t, dims in ((a, range(nd - 1)), (b, (*range(nd - 2), nd - 1)))
              for i, sf in _strided(t).items()
              if _shard_dim(t.placements[i]) == _shard_dim(out_p[i]) in dims}
    a, b = mode.move(a, lambda t: pa), mode.move(b, lambda t: pb)
    partial = any(p.is_partial() for p in out_p)
    la, lb = a.to_local(), b.to_local()
    local = func(la.float(), lb.float()) if partial else func(la, lb)
    shape = (*a.shape[:-1], b.shape[-1])
    out = DTensor.from_local(local, a.device_mesh, out_p, run_check=False, shape=shape,
                             stride=_contiguous(shape))
    return mode.move(out, _summed).to(dtype) if partial else _merge_marked(out, merged)


def _outgrows(a, b, i: int) -> bool:
    """Whether ``a @ b``'s local output is larger than both operands with
    their contraction dim gathered over mesh dim ``i`` (the scores of
    attention against a query or key that only one side shards there)."""
    nd, n = a.ndim, a.device_mesh.size(i)
    out = math.prod(_local_shape(a, a.placements)[:-1]) * b.shape[-1] * max(
        a.element_size(), b.element_size())
    out //= math.prod(b.device_mesh.size(j) for j, p in enumerate(b.placements)
                      if _shard_dim(p) == nd - 1)
    gathered = [_local_bytes(t, t.placements) * (n if _shard_dim(p) == d else 1)
                for t, p, d in ((a, a.placements[i], nd - 1), (b, b.placements[i], nd - 2))]
    return out > sum(gathered)


def _pointwise(mode, func, args, kwargs):
    """A pointwise op (any op tagged so), placed as GSPMD merges its
    operands' shardings: the largest operand (the first of equals: the
    residual stream in ``x + y``; the destination of an in-place op)
    keeps its shards and, where it is replicated over a mesh dim that
    shards another operand on a dim of its own, takes that shard (a
    slice, for nothing: a bias sharded on head_dim shards the activation
    it is added to); the other operands (a plain tensor as replicated)
    move to that layout, and the op runs on the local shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dts = [a for a in args if isinstance(a, DTensor)]
    if (not dts or any(d.device_mesh != dts[0].device_mesh for d in dts)
            or any(p.is_partial() for d in dts for p in d.placements)
            or any(isinstance(v, torch.Tensor) for v in kwargs.values())):
        return NotImplemented
    mesh = dts[0].device_mesh
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) and a.ndim else a
            for a in args]
    dts = [a for a in args if isinstance(a, DTensor)]
    inplace = func._schema.is_mutable
    lead = args[0] if inplace else max(dts, key=lambda d: d.numel())
    if not isinstance(lead, DTensor):
        return NotImplemented
    target = list(lead.placements)
    taken = {_shard_dim(p) for p in target} - {None}
    for i, p in enumerate(target):
        if inplace or not p.is_replicate():
            continue
        for d in sorted(dts, key=lambda d: -d.numel()):
            k = _shard_dim(d.placements[i])
            if k is None:
                continue
            kl = k + lead.ndim - d.ndim
            if kl >= 0 and kl not in taken and lead.shape[kl] == d.shape[k] > 1:
                target[i] = Shard(kl)
                taken.add(kl)
                break

    def place(t, shape=None):            # ``target`` on a tensor of this shape
        shape = t.shape if shape is None else shape
        out = []
        for p in target:
            d = _shard_dim(p)
            d = None if d is None else d - (lead.ndim - len(shape))
            out.append(Shard(d) if d is not None and d >= 0 and shape[d] > 1
                       else Replicate())
        return out

    args = [mode.move(a, place) if isinstance(a, DTensor) else a for a in args]
    got = func(*[a.to_local() if isinstance(a, DTensor) else a for a in args], **kwargs)
    if inplace or not isinstance(got, torch.Tensor):
        return args[0] if inplace else NotImplemented
    shape = torch.broadcast_shapes(*(a.shape for a in args if isinstance(a, torch.Tensor)))
    return DTensor.from_local(got, mesh, place(None, shape), run_check=False, shape=shape,
                              stride=_contiguous(shape, got))


def _groups(ins, outs) -> list:
    """A reshape from ``ins`` to ``outs`` as groups of dims of equal
    products: [(input dims, output dims)]."""
    groups, i, j = [], 0, 0
    while i < len(ins) or j < len(outs):
        gi, go, pi, po = [], [], 1, 1
        if i < len(ins):
            gi, pi, i = [i], ins[i], i + 1
        if j < len(outs):
            go, po, j = [j], outs[j], j + 1
        while pi != po:
            if pi < po:
                gi, pi, i = gi + [i], pi * ins[i], i + 1
            else:
                go, po, j = go + [j], po * outs[j], j + 1
        groups.append((gi, go))
    return groups


def _view(mode, func, args, kwargs):
    """``view`` / ``_unsafe_view`` placed by GSPMD's reshape rule, group by
    group of dims (``_groups``): a dim that keeps its size keeps its shard;
    a merge keeps the shard of its major dim, and a minor dim's too (a
    batch dim over "data" merged with heads over "model", as ``einsum``
    does before a batched product), as a shard of the merged dim whose
    rows are strided (``_strided``: the local size of the dims above it,
    kept on the DTensor as ``_merged``); a split puts a shard on the first
    output dim that takes it evenly, a strided one back on the dim it was
    merged from; any other shard is gathered first.  The placements are
    plain shards either way, so that no torch version reads them another
    way, and the local shard is viewed as it lies."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, size = args[0], args[1]
    if kwargs or not isinstance(x, DTensor) or x.numel() == 0:
        return NotImplemented
    shape = list(torch.empty(x.shape, device="meta").view(size).shape)
    mesh, ins, strided = x.device_mesh, list(x.shape), _strided(x)
    groups = _groups(ins, shape)
    group_of = {d: g for g, (gi, _) in enumerate(groups) for d in gi}
    local_in = list(x.to_local().shape)
    want, out_p, merged = list(x.placements), [], {}
    split = [1] * len(shape)                  # mesh sizes already on each output dim
    for i, p in enumerate(x.placements):
        d, n = _shard_dim(p), mesh.size(i)
        if d is None:
            out_p.append(p)
            continue
        gi, go = groups[group_of[d]]
        nin = [k for k in gi if ins[k] > 1]
        nout = [k for k in go if shape[k] > 1]
        got = None
        if d not in nin:
            pass
        elif len(nin) == 1 and len(nout) == 1:
            got = Shard(nout[0])
            if i in strided:
                merged[i] = strided[i]
        elif len(nout) == 1 and i not in strided and ins[d] % n == 0:
            got = Shard(nout[0])
            if d != nin[0]:
                merged[i] = math.prod(local_in[k] for k in gi[:gi.index(d)])
        elif len(nin) == 1:
            for k in nout:
                if i in strided:
                    ok = (math.prod(shape[m] // split[m] for m in go[:go.index(k)])
                          == strided[i] and shape[k] % n == 0)
                else:
                    ok = shape[k] % (split[k] * n) == 0
                if ok:
                    got, split[k] = Shard(k), split[k] * n
                    break
                if i not in strided:
                    break
        if got is None:
            want[i] = Replicate()
        out_p.append(got if got is not None else Replicate())
    x = mode.move(x, lambda t: want)
    local_in = list(x.to_local().shape)
    local = list(shape)
    for gi, go in groups:
        sharded = [k for k in go if any(_shard_dim(p) == k for p in out_p)]
        if len(sharded) == 1:
            local[sharded[0]] = (math.prod(local_in[k] for k in gi)
                                 // math.prod(shape[k] for k in go if k != sharded[0]))
        else:
            for k in sharded:
                local[k] = -(-shape[k] // math.prod(mesh.size(i) for i, p in enumerate(out_p)
                                                    if _shard_dim(p) == k))
    try:
        got = func(x.to_local(), local)
    except RuntimeError:        # a local shard that cannot be viewed so: a copy
        got = x.to_local().reshape(local)
    return _merge_marked(DTensor.from_local(got, mesh, out_p, run_check=False,
                                            shape=tuple(shape),
                                            stride=_contiguous(shape, got)), merged)


def _strided(t) -> dict:
    """{mesh dim: split factor} of ``t``'s shards that a merge left strided
    (``_view``): the mesh dim shards the merged dim's rows in every run of
    ``split factor`` blocks, not in one block."""
    return getattr(t, "_merged", {})


def _merge_marked(t, merged: dict):
    if merged:
        t._merged = merged
    return t


def _along(mode, tensors, dims, kind, compute, times: int = 1):
    """``compute`` (on local tensors) of ``tensors``, which lie alike, as an
    op along their ``dims``: where mesh dims shard any of them, as GSPMD
    partitions an op along a partitioned dim: those mesh dims gathered,
    the op run on the local shards, and its result(s) sharded again as the
    inputs were; counted as the collectives XLA issues for it, ``times``
    of ``kind`` ("all-gather": the gathered operand's bytes;
    "collective-permute" (a flip: each shard to its mirror; a slice: an
    output shard's left and right halo, two) and "all-to-all" (a
    concatenation): the result's local bytes).  Along unsharded dims the
    op runs on the local shards and moves nothing.  ``compute`` also runs
    on meta tensors of the global shapes, for the result's."""
    from torch.distributed.tensor import DTensor
    x = tensors[0]
    over = {i for i, p in enumerate(x.placements) if _shard_dim(p) in dims}
    full = [mode.move(t, lambda t: _replicated(t, over), count=False) for t in tensors]
    got, glob = compute([t.to_local() for t in full]), compute(_global_meta(full))
    outs = [DTensor.from_local(g, x.device_mesh, full[0].placements, run_check=False,
                               shape=m.shape, stride=_contiguous(m.shape, g))
            for g, m in zip(*((got, glob) if isinstance(got, tuple) else ((got,), (glob,))))]
    outs = [mode.move(t, lambda t: x.placements, count=False) for t in outs]
    for _ in range(times if over else 0):
        mode.count(kind, _local_bytes(full[0], full[0].placements) if kind == "all-gather"
                   else sum(_local_bytes(t, t.placements) for t in outs))
    return tuple(outs) if isinstance(got, tuple) else outs[0]


def _dim_op(kind, dims_of, times: int = 1):
    """A rule for an op along the dims ``dims_of(args, kwargs)`` of its
    first argument (``_along``)."""
    def rule(mode, func, args, kwargs):
        from torch.distributed.tensor import DTensor
        x = args[0]
        if not isinstance(x, DTensor) or x.ndim == 0:
            return NotImplemented
        dims = {d % x.ndim for d in dims_of(args, kwargs)}
        if func is _aten.slice_backward.default:      # the sizes: the local shard's
            return _along(mode, [x], dims, kind, lambda t: func(
                t[0], [n if k == args[2] % x.ndim else m
                       for k, (n, m) in enumerate(zip(args[1], t[0].shape))], *args[2:]), times)
        return _along(mode, [x], dims, kind, lambda t: func(t[0], *args[1:], **kwargs), times)
    return rule


def _slice_dims(args, kwargs):
    """The dim a slice cuts, unless it keeps the whole of it."""
    x, dim = args[0], args[1] if len(args) > 1 else 0
    start, end = (args[2] if len(args) > 2 else None), (args[3] if len(args) > 3 else None)
    step = args[4] if len(args) > 4 else 1
    whole = (start in (None, 0) and (end is None or end >= x.shape[dim]) and step == 1)
    return () if whole else (dim,)


def _cat(mode, func, args, kwargs):
    """``cat`` / ``stack``: every operand moves to the layout of the one
    whose layout moves the fewest bytes; a concatenation along a sharded
    dim is sharded again on it,
    counted as XLA's all-to-all of the result's local bytes (``_along``);
    otherwise the local shards are joined as they lie."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tensors, dim = args[0], args[1] if len(args) > 1 else 0
    dts = [t for t in tensors if isinstance(t, DTensor)]
    if kwargs or not dts:
        return NotImplemented
    mesh = dts[0].device_mesh                   # a plain tensor as replicated
    tensors = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in tensors]
    if any(t.ndim != tensors[0].ndim or t.device_mesh != mesh for t in tensors):
        return NotImplemented
    # the operands' layout that moves the fewest bytes (the first of equals)
    lead = min(tensors, key=lambda c: sum(sum(nb for _, nb in _moves(t, c.placements))
                                          for t in tensors))
    tensors = [mode.move(t, lambda t: lead.placements) for t in tensors]
    if func._overloadpacket.__name__ == "cat":
        return _along(mode, tensors, {dim % lead.ndim}, "all-to-all", lambda t: func(t, dim))
    dim %= lead.ndim + 1
    out_p = [Shard(_shard_dim(p) + (_shard_dim(p) >= dim))
             if _shard_dim(p) is not None else p for p in lead.placements]
    local = func([t.to_local() for t in tensors], dim)
    shape = func([_global_meta(t) for t in tensors], dim).shape
    return DTensor.from_local(local, lead.device_mesh, out_p, run_check=False, shape=shape,
                              stride=_contiguous(shape, local))


def _dims_map(func, args, ndim: int):
    """For a view that moves dims without touching their elements: for each
    output dim, the input dim it is (None for a new one), and the input
    dims it drops (a select's, a squeeze's)."""
    name = func._overloadpacket.__name__
    if name == "permute":
        return [d % ndim for d in args[1]], ()
    if name in ("transpose", "t"):
        a, b = (args[1] % ndim, args[2] % ndim) if name == "transpose" else (0, 1)
        out = list(range(ndim))
        out[a], out[b] = b, a
        return out[:ndim], ()
    if name == "unsqueeze":
        d = args[1] % (ndim + 1)
        return [*range(d), None, *range(d, ndim)], ()
    if name == "select":
        d = args[1] % ndim
        return [k for k in range(ndim) if k != d], (d,)
    if name == "squeeze":
        shape = args[0].shape
        dims = (range(ndim) if len(args) < 2 else
                [args[1]] if isinstance(args[1], int) else args[1])
        gone = {d % ndim for d in dims if shape[d % ndim] == 1}
        return [k for k in range(ndim) if k not in gone], tuple(gone)
    if name == "expand":
        new = len(args[1]) - ndim
        return [None] * new + list(range(ndim)), ()
    return [*range(ndim)], ()                       # alias


def _dims(mode, func, args, kwargs):
    """A view that only moves, adds or drops dims (``permute``,
    ``transpose``, ``t``, ``unsqueeze``, ``squeeze``, ``select``,
    ``expand``, ``alias``): each shard follows its dim; a select along a
    sharded dim gathers it first.  The view runs on the local shard (an
    expand keeps a sharded dim's local size)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = args[0]
    if kwargs and func._overloadpacket.__name__ != "expand" or not isinstance(x, DTensor):
        return NotImplemented
    src, gone = _dims_map(func, args, x.ndim)
    x = mode.move(x, lambda t: [Replicate() if _shard_dim(p) in gone else p
                                for p in t.placements])
    out_p = [Shard(src.index(_shard_dim(p))) if _shard_dim(p) is not None else p
             for p in x.placements]
    rest = list(args[1:])
    if func._overloadpacket.__name__ == "expand":
        rest[0] = [-1 if any(_shard_dim(p) == k for p in out_p) else n
                   for k, n in enumerate(args[1])]
    got = func(x.to_local(), *rest, **kwargs)
    glob = func(_global_meta(x), *args[1:], **kwargs)
    return _merge_marked(
        DTensor.from_local(got, x.device_mesh, out_p, run_check=False, shape=glob.shape,
                           stride=tuple(glob.stride()) if func._overloadpacket.__name__ == "expand"
                           else _contiguous(glob.shape, got)),
        {i: sf for i, sf in _strided(x).items()})


def _unselect(mode, func, args, kwargs):
    """``select_backward``: the gradient put back at its index, in zeros of
    the input's shape; each rank on its own shard (the dim it adds is a
    whole one)."""
    from torch.distributed.tensor import DTensor, Shard
    g, sizes, dim, index = args
    if kwargs or not isinstance(g, DTensor):
        return NotImplemented
    dim %= len(sizes)
    out_p = [Shard(_shard_dim(p) + (_shard_dim(p) >= dim))
             if _shard_dim(p) is not None else p for p in g.placements]
    local = list(g.to_local().shape)
    local.insert(dim, sizes[dim])
    got = func(g.to_local(), local, dim, index)
    return DTensor.from_local(got, g.device_mesh, out_p, run_check=False,
                              shape=torch.Size(sizes), stride=_contiguous(sizes, got))


def _unbind(mode, func, args, kwargs):
    """``unbind`` along a dim: gathered first where it is sharded; each
    piece keeps the other dims' shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, dim = args[0], (args[1] if len(args) > 1 else 0) % args[0].ndim
    if kwargs or not isinstance(x, DTensor):
        return NotImplemented
    x = mode.move(x, lambda t: [Replicate() if _shard_dim(p) == dim else p
                                for p in t.placements])
    out_p = [Shard(_shard_dim(p) - (_shard_dim(p) > dim))
             if _shard_dim(p) is not None else p for p in x.placements]
    shape = torch.Size([n for k, n in enumerate(x.shape) if k != dim])
    return tuple(DTensor.from_local(t, x.device_mesh, out_p, run_check=False, shape=shape,
                                    stride=_contiguous(shape, t))
                 for t in func(x.to_local(), dim))


def _pad_dims(args, kwargs):
    """The dims ``constant_pad_nd`` pads (its pads count from the last)."""
    x, pad = args[0], args[1]
    return [x.ndim - 1 - k // 2 for k in range(0, len(pad), 2) if pad[k] or pad[k + 1]]


def _index_select(mode, func, args, kwargs):
    """``index_select`` along a dim, gathered first where it is sharded
    (``_along``), the index replicated."""
    from torch.distributed.tensor import DTensor
    x, dim, index = args
    if kwargs or not isinstance(x, DTensor):
        return NotImplemented
    dim %= x.ndim
    index = (mode.move(index, _replicated).to_local() if isinstance(index, DTensor)
             else index)
    return _along(mode, [x], {dim}, "all-gather",
                  lambda t: func(t[0], dim, index.to(t[0].device)))


def _fresh(mode, func, args, kwargs):
    """A new tensor made from a DTensor (``new_zeros`` and its kin,
    ``zeros_like`` and its kin): a ``*_like`` lies as its input, a
    ``new_*`` of the input's shape too, one of another shape replicated
    (its values are the same everywhere); made on the local shard."""
    from torch.distributed.tensor import DTensor, Replicate
    x = args[0]
    if not isinstance(x, DTensor):
        return NotImplemented
    rest = list(args[1:])
    shape = x.shape
    out_p = list(x.placements)
    if func._overloadpacket.__name__.startswith("new_"):
        shape = torch.Size(rest[0])
        if shape != x.shape:
            out_p = [Replicate()] * x.device_mesh.ndim
        else:
            rest[0] = x.to_local().shape
    got = func(x.to_local(), *rest, **kwargs)
    return DTensor.from_local(got, x.device_mesh, out_p, run_check=False, shape=shape,
                              stride=_contiguous(shape, got))


def _reduce(mode, func, args, kwargs):
    """``sum`` / ``mean`` / ``amax`` over dims of which mesh dims shard
    some: each rank reduces its shard (a mean divides by the global count)
    and the partial results are all-reduced at once, as GSPMD sums them."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    x = args[0]
    if (not isinstance(x, DTensor) or x.ndim == 0
            or any(p.is_partial() for p in x.placements)):
        return NotImplemented
    dims = args[1] if len(args) > 1 and args[1] else range(x.ndim)
    dims = sorted({d % x.ndim for d in dims})
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    name = func._overloadpacket.__name__
    out_p = []
    for p in x.placements:
        d = _shard_dim(p)
        out_p.append(p if d is None else Partial("max" if name == "amax" else "sum")
                     if d in dims else Shard(d if keep else d - sum(k < d for k in dims)))
    dtype = kwargs.get("dtype")
    shape = _global_meta(x).sum(dims, keepdim=keep).shape
    local = x.to_local()
    if name == "amax":
        got = local.amax(dims, keepdim=keep)
    elif name == "mean":
        count = math.prod(x.shape[d] for d in dims)
        got = (local.sum(dims, keepdim=keep, dtype=torch.float32) / count).to(dtype or x.dtype)
    else:
        got = local.sum(dims, keepdim=keep, dtype=dtype)
    out = DTensor.from_local(got, x.device_mesh, out_p, run_check=False, shape=shape,
                             stride=_contiguous(shape))
    return mode.move(out, _summed)


def _softmax(mode, func, args, kwargs):
    """A softmax (or log-softmax, or either's backward) along a sharded
    dim, as GSPMD computes it: local maxima and sums, each all-reduced
    over the rows (a (rows, 1) tensor), instead of gathering the dim."""
    from torch.distributed.tensor import DTensor
    name = func._overloadpacket.__name__
    backward = name.endswith("_backward_data")
    x, dim = args[0], args[2 if backward else 1] % args[0].ndim
    ins = args[:2 if backward else 1]
    if kwargs or not all(isinstance(t, DTensor) for t in ins):
        return NotImplemented
    lead = next((t for t in ins[::-1] if any(_shard_dim(p) == dim for p in t.placements)),
                ins[-1])
    if backward:            # the gradient and the output alike (a slice, for nothing)
        args = (*mode.move(ins, lambda t: lead.placements), *args[2:])
    if not any(_shard_dim(p) == dim for p in lead.placements):      # on the local rows
        local = [t.to_local() for t in args[:len(ins)]]
        if not backward and args[2] and x.dtype != torch.float32:   # half_to_float
            local, args = [local[0].float()], (args[0], dim, False)
        got = func(*local, *args[len(ins):])
        return DTensor.from_local(got, lead.device_mesh, lead.placements, run_check=False,
                                  shape=lead.shape, stride=_contiguous(lead.shape, got))

    def total(t):
        return t.sum(dim, keepdim=True)

    if not backward:
        if args[2] and x.dtype != torch.float32:          # half_to_float
            x = x.float()
        z = x - x.amax(dim, keepdim=True)
        return z - total(z.exp()).log() if name == "_log_softmax" else z.exp() / total(z.exp())
    g, y = args[0], args[1]
    if name == "_softmax_backward_data":
        return y * (g - total(g * y))
    return g - y.exp() * total(g)                          # _log_softmax_backward_data


def _offset(x, d: int) -> int:
    """Where this rank's shard of ``x`` starts along dim ``d``: DTensor's
    shards are ``torch.chunk``'s, mesh dim within mesh dim."""
    start, size = 0, x.shape[d]
    for i, p in enumerate(x.placements):
        if _shard_dim(p) == d:
            chunk = -(-size // x.device_mesh.size(i))
            r = x.device_mesh.get_local_rank(i)
            start, size = start + r * chunk, max(0, min(chunk, size - r * chunk))
    return start


def _take(mode, func, args, kwargs):
    """``gather`` and ``scatter_add`` (a gather's backward, a count) as
    GSPMD partitions them.  Along a dim sharded over one mesh dim: each
    rank takes (or adds into) the entries of its own range, an index
    elsewhere giving zero; the gathered values are summed over that mesh
    dim (an all-reduce of the index's shape) and a scatter needs nothing.
    A scatter-add along an unsharded dim of updates that mesh dims shard:
    each rank adds its updates into zeros, the sums are all-reduced and
    added to the destination."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x, dim, index = args[:3]
    src = args[3] if len(args) > 3 else None
    if (kwargs or not isinstance(index, DTensor)
            or (src is not None and not isinstance(src, DTensor))):
        return NotImplemented
    mesh = index.device_mesh
    dim %= index.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if src is not None and not any(_shard_dim(p) == dim for p in x.placements):
        # a scatter-add along an unsharded dim: where the updates are
        # sharded along it, each rank adds its own into zeros and the sums
        # are all-reduced; along another dim, the destination is sliced
        # alike and each rank adds into its own slice
        want_x, want_i, summed = [], [], set()
        for i, (p, q) in enumerate(zip(x.placements, index.placements)):
            d = _shard_dim(q)
            if p.is_partial() or q.is_partial():
                return NotImplemented
            if d == dim and p.is_replicate():
                want_x.append(p)
                want_i.append(q)
                summed.add(i)
            elif d is not None and p.is_replicate() and x.shape[d] == index.shape[d]:
                want_x.append(Shard(d))
                want_i.append(q)
            else:
                want_x.append(p)
                want_i.append(p)
        x = mode.move(x, lambda t: want_x)
        index, src = mode.move((index, src), lambda t: want_i)
        local = x.to_local()
        got = torch.scatter_add(torch.zeros_like(local) if summed else local, dim,
                                index.to_local(), src.to_local())
        out = DTensor.from_local(got, mesh, [Partial() if i in summed else p
                                             for i, p in enumerate(want_x)],
                                 run_check=False, shape=x.shape, stride=x.stride())
        return mode.move(out, _summed) + x if summed else out
    if not isinstance(x, DTensor):
        return NotImplemented
    sharded = [i for i, p in enumerate(x.placements) if _shard_dim(p) == dim]
    if len(sharded) != 1 or type(x.placements[sharded[0]]) is not Shard:
        return NotImplemented
    i = sharded[0]
    rest = _replicated(x, {i})
    index = mode.move(index, lambda t: rest)
    local = index.to_local() - _offset(x, dim)
    inside = (local >= 0) & (local < x.to_local().shape[dim])
    local = local.clamp(0, max(x.to_local().shape[dim] - 1, 0))
    if src is None:                                        # gather
        got = torch.gather(x.to_local(), dim, local)
        got = torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))
        out = DTensor.from_local(got, mesh, [Partial() if j == i else p
                                             for j, p in enumerate(rest)],
                                 run_check=False, shape=index.shape, stride=index.stride())
        return mode.move(out, _summed)
    src = mode.move(src, lambda t: rest).to_local()        # scatter_add
    src = torch.where(inside, src, torch.zeros((), dtype=src.dtype, device=src.device))
    got = torch.scatter_add(x.to_local(), dim, local, src)
    return DTensor.from_local(got, mesh, x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _put(mode, func, args, kwargs):
    """``scatter`` of values (a sort's or top-k's backward, into zeros): as
    GSPMD propagates a scatter's updates into its operand, the result lies
    as the values do, gathered where they shard the scattered dim; the
    destination and the index move to that layout and each rank writes its
    own shard.  The destination's own layout (a ``new_zeros`` or a plain
    ``zeros``, by torch version) does not enter."""
    from torch.distributed.tensor import DTensor, Replicate
    x, dim, index, src = args[:4]
    if (kwargs or len(args) > 4 or not isinstance(src, DTensor)
            or index.shape != src.shape or index.ndim != x.ndim):
        return NotImplemented
    mesh = src.device_mesh
    x, index = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (x, index)]
    dim %= x.ndim
    if any(index.shape[d] != x.shape[d] for d in range(x.ndim) if d != dim):
        return NotImplemented
    want = [p if _shard_dim(p) != dim else Replicate() for p in src.placements]
    x, index, src = mode.move((x, index, src), lambda t: want)
    got = func(x.to_local(), dim, index.to_local(), src.to_local())
    return DTensor.from_local(got, mesh, want, run_check=False, shape=x.shape,
                              stride=_contiguous(x.shape, got))


def _lookup(mode, func, args, kwargs):
    """``x[ids, ...]`` (``index.Tensor`` on leading dims: an embedding
    lookup, a decode step's rows) as GSPMD partitions a gather: where one
    mesh dim shards an indexed dim, each rank looks up the ids of its own
    range, zero for the others, and the rows are summed over that mesh dim
    (an all-reduce of the output: one rank's row is not zero, so the sum
    is exact in the table's type); the output lies as the ids do, and as
    ``x`` on its other dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x, indices = args[0], list(args[1])
    if (kwargs or not isinstance(x, DTensor) or None in indices
            or any(t.dtype == torch.bool for t in indices)):
        return NotImplemented
    k, mesh = len(indices), x.device_mesh
    shape_ids = torch.broadcast_shapes(*(t.shape for t in indices))
    nb = len(shape_ids)
    lead = next((t for t in indices if isinstance(t, DTensor) and t.shape == shape_ids), None)
    ranged, id_p, out_p = set(), [], []
    for i, p in enumerate(x.placements):
        d, q = _shard_dim(p), lead.placements[i] if lead is not None else Replicate()
        if p.is_partial():
            return NotImplemented
        if d is not None and d < k:                    # an indexed dim: masked, then summed
            if type(p) is not Shard:
                return NotImplemented
            ranged.add(d)
            id_p.append(Replicate())
            out_p.append(Partial())
        elif d is not None:                            # a looked-up dim keeps its shard
            id_p.append(Replicate())
            out_p.append(Shard(d - k + nb))
        else:
            id_p.append(q if _shard_dim(q) is not None else Replicate())
            out_p.append(id_p[-1])

    def placed(t):                                     # an index's own layout
        return [Shard(_shard_dim(p) - (nb - t.ndim))
                if _shard_dim(p) is not None and _shard_dim(p) >= nb - t.ndim
                and t.shape[_shard_dim(p) - (nb - t.ndim)] > 1 else Replicate() for p in id_p]

    local_ids, inside = [], None
    for d, t in enumerate(indices):
        li = mode.move(t, placed).to_local() if isinstance(t, DTensor) else t
        if d in ranged:
            held = x.to_local().shape[d]
            li = li - _offset(x, d)
            ok = (li >= 0) & (li < held)
            inside = ok if inside is None else inside & ok
            li = li.clamp(0, max(held - 1, 0))
        local_ids.append(li)
    got = x.to_local()[tuple(local_ids)]
    if inside is not None:
        inside = inside.reshape(*inside.shape, *[1] * (got.ndim - inside.ndim))
        got = torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))
    shape = (*shape_ids, *x.shape[k:])
    out = DTensor.from_local(got, mesh, out_p, run_check=False, shape=shape,
                             stride=_contiguous(shape))
    return mode.move(out, _summed)


def _scatter(mode, func, args, kwargs):
    """``index_put(dst, ids, values)`` out of place (JAX's
    ``zeros.at[ids].set(values)``), as GSPMD partitions a scatter into
    unsharded rows: the ids are replicated, and a dim that ``dst`` does
    not shard where the values do is sharded in the output too (a slice of
    ``dst``, for nothing); each rank writes its shard of every row.  An
    accumulating write is ``_accumulate``'s."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dst, indices, values = args[:3]
    if len(args) > 3 and args[3]:
        return _accumulate(mode, func, args, kwargs)
    if (kwargs or not isinstance(dst, DTensor) or not isinstance(values, DTensor)
            or None in indices):
        return NotImplemented
    k = len(indices)
    nb = len(torch.broadcast_shapes(*(t.shape for t in indices)))
    if values.ndim != nb + dst.ndim - k:
        return NotImplemented
    out_p, val_p = list(dst.placements), []
    for i, (p, q) in enumerate(zip(dst.placements, values.placements)):
        d, j = _shard_dim(p), _shard_dim(q)
        if p.is_partial() or d is not None and d < k:
            return NotImplemented
        if d is not None:
            val_p.append(Shard(d - k + nb))
        elif (j is not None and j >= nb and values.shape[j] > 1
              and values.shape[j] == dst.shape[j - nb + k]):
            out_p[i] = Shard(j - nb + k)
            val_p.append(q)
        else:
            val_p.append(Replicate())
    dst, values = mode.move(dst, lambda t: out_p), mode.move(values, lambda t: val_p)
    ids = [mode.move(t, _replicated).to_local() if isinstance(t, DTensor) else t
           for t in indices]
    local = torch.index_put(dst.to_local(), ids, values.to_local())
    return DTensor.from_local(local, dst.device_mesh, out_p, run_check=False,
                              shape=dst.shape, stride=dst.stride())


def _accumulate(mode, func, args, kwargs):
    """``index_put(table, [ids], values, accumulate=True)`` (an
    embedding's gradient) into a replicated table, as GSPMD partitions a
    scatter-add: each rank adds the updates it holds into zeros, the sums
    over the mesh dims that shard the updates are all-reduced, and the
    table adds them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    table, indices, values = args[:3]
    if (kwargs or len(args) < 4 or not args[3] or len(indices) != 1
            or not all(isinstance(t, DTensor) for t in (table, indices[0], values))
            or not all(p.is_replicate() for p in table.placements)):
        return NotImplemented
    ids, mesh = indices[0], table.device_mesh
    if any(_shard_dim(p) is not None and _shard_dim(p) >= ids.ndim for p in ids.placements):
        return NotImplemented
    # the updates lie as their ids do
    values = mode.move(values, lambda t: [p if _shard_dim(p) is not None else Replicate()
                                          for p in ids.placements])
    local = table.to_local()
    delta = torch.index_put(torch.zeros_like(local), [ids.to_local()], values.to_local(), True)
    delta = DTensor.from_local(delta, mesh, [Partial() if _shard_dim(p) is not None
                                             else Replicate() for p in ids.placements],
                               run_check=False, shape=table.shape, stride=table.stride())
    return table + mode.move(delta, _summed)


def _write_into(mode, func, args, kwargs):
    """An in-place indexed write (``index_put_``: a decode step's cache
    column) into a sharded tensor, as GSPMD partitions a scatter: the
    indices are replicated, the written values lie as the destination on
    its dims that are not indexed and are replicated over the mesh dims
    that shard an indexed dim (each rank writing the entries that fall in
    its own range), all in place.  On meta tensors the write is checked on
    meta tensors of the global shapes.  An accumulating write is a
    scatter-add (``_accumulate``), made in place."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dst, indices, values = args[:3]
    if len(args) > 3 and args[3] and isinstance(dst, DTensor):
        out = _accumulate(mode, func, args, kwargs)
        if out is not NotImplemented:
            dst.to_local().copy_(out.to_local())
            return dst
    if (kwargs or not isinstance(dst, DTensor) or not dst.to_local().is_meta
            or not isinstance(values, DTensor) or None in indices):
        return NotImplemented
    k = len(indices)
    nb = len(torch.broadcast_shapes(*(t.shape for t in indices)))
    lead = values.ndim - (dst.ndim - k)             # the values' dims the ids index
    if lead < 0 or any(p.is_partial() for p in dst.placements):
        return NotImplemented
    want = []
    for p in dst.placements:
        d = _shard_dim(p)
        j = None if d is None or d < k else d - k + lead
        want.append(Shard(j) if j is not None and values.shape[j] > 1 else Replicate())
    mode.move(values, lambda t: want)
    mode.move(indices, _replicated)
    func(*_global_meta(args), **{k: _global_meta(v) for k, v in kwargs.items()})
    return dst


def _copy(mode, func, args, kwargs):
    """``dst.copy_(src)``: ``src`` moves to ``dst``'s layout (as a pointwise
    operand, ``_pointwise``) and each rank copies into its own shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dst, src = args[0], args[1]
    if (len(args) > 2 or kwargs or not isinstance(dst, DTensor) or not isinstance(src, DTensor)
            or src.ndim > dst.ndim):
        return NotImplemented
    want = []
    for p in dst.placements:
        d = _shard_dim(p)
        d = None if d is None else d - (dst.ndim - src.ndim)
        want.append(Shard(d) if d is not None and d >= 0 and src.shape[d] > 1
                    else Replicate() if not p.is_partial() else None)
    if None in want:
        return NotImplemented
    src = mode.move(src, lambda t: want)
    dst.to_local().copy_(src.to_local())
    return dst


class DryRunMode(TorchDispatchMode):
    """Counts, per device, the collectives' result bytes by kind and the
    products' operations, and places the ops that move bytes or change a
    placement (see the module docstring); the DTensor ops a rule issues
    are placed by the rules in turn.

    Every move a rule makes is counted by ``move`` as the collective GSPMD
    issues for it, and made by DTensor's redistribution uncounted
    (``_quiet``).  An op no rule places is handed to DTensor (``dtensor``:
    ``NotImplemented`` on the nested call), with this mode active again,
    so that its local ops and any collective DTensor's own strategy
    issues for it come back here on local tensors: such a collective is
    counted, and its op in ``dtensor_ops``.  A collective of the step's
    own (the EP combine's) is counted alone."""

    def __init__(self):
        super().__init__()
        self.collective_bytes: Counter = Counter()
        self.collective_calls: Counter = Counter()
        self.dtensor_ops: Counter = Counter()
        self.resharded_ops: Counter = Counter()
        self.replicated_ops: Counter = Counter()
        self.matmul_flops = 0
        self._defer = 0
        self._quiet = 0
        self._ops: list = []

    def count(self, kind: str, nbytes: int) -> None:
        if nbytes:
            self.collective_bytes[kind] += nbytes
            self.collective_bytes["total"] += nbytes
            self.collective_calls[kind] += 1

    def move(self, a, placements_of, count: bool = True):
        """Every DTensor in ``a`` redistributed to ``placements_of(dtensor)``,
        its collectives counted as ``_moves`` gives them (unless not
        ``count``)."""
        from torch.distributed.tensor import DTensor
        if isinstance(a, DTensor):
            want = tuple(placements_of(a))
            if want == tuple(a.placements):
                return a
            if count:
                for kind, nb in _moves(a, want):
                    self.count(kind, nb)
            self._quiet += 1
            try:
                return a.redistribute(a.device_mesh, want)
            finally:
                self._quiet -= 1
        if isinstance(a, (list, tuple)):
            return type(a)(self.move(x, placements_of, count) for x in a)
        return a

    def dtensor(self, func, args, kwargs):
        """``func`` on these arguments as DTensor's own strategy runs it."""
        self._defer += 1
        try:
            return func(*args, **kwargs)
        finally:
            self._defer -= 1

    def _attempt(self, func, args, kwargs):
        """``func`` on these arguments, or None if DTensor has no strategy
        for them or cannot make the redistribution its strategy asks for
        (an IndexError in some torch versions' redistribution planner):
        the collectives of a failed attempt are not counted (an error of
        the op itself comes back from the replicated run)."""
        saved = (self.collective_bytes.copy(), self.collective_calls.copy(),
                 self.dtensor_ops.copy(), self.matmul_flops)
        try:
            return self.dtensor(func, args, kwargs), True
        except (RuntimeError, NotImplementedError, IndexError):
            (self.collective_bytes, self.collective_calls, self.dtensor_ops,
             self.matmul_flops) = saved
            return None, False

    def _place(self, func, args, kwargs):
        rule = _RULES.get(func)
        if rule is None and torch.Tag.pointwise in func.tags:
            rule = _pointwise
        if rule is not None:
            out = rule(self, func, args, kwargs)
            if out is not NotImplemented:
                return out
        out, ok = self._attempt(func, args, kwargs)
        if ok:
            # a reduction over a sharded dim leaves partial sums: GSPMD sums
            # them at once, where DTensor leaves them to the next op, whose
            # strategy for them moves with the torch version
            return out if func._schema.is_mutable else self.move(out, _summed)
        # replicate over one mesh dim, the last first
        dts = _dtensors((args, tuple(kwargs.values())))
        one_mesh = all(d.device_mesh == dts[0].device_mesh
                       and len(d.placements) == dts[0].device_mesh.ndim for d in dts)
        for i in reversed(range(dts[0].device_mesh.ndim if one_mesh else 0)):
            if all(d.placements[i].is_replicate() for d in dts):
                continue
            rargs = self.move(args, lambda t: _replicated(t, {i}))
            out, ok = self._attempt(func, rargs, {k: self.move(v, lambda t: _replicated(t, {i}))
                                                  for k, v in kwargs.items()})
            if ok:
                self.resharded_ops[str(func)] += 1
                return self._write_back(func, args, rargs, out)
        self.replicated_ops[str(func)] += 1
        rargs = self.move(args, _replicated)
        out = self.dtensor(func, rargs, {k: self.move(v, _replicated)
                                         for k, v in kwargs.items()})
        return self._write_back(func, args, rargs, out)

    def _write_back(self, func, args, rargs, out):
        if func._schema.is_mutable:          # write back in the original layout
            dst = args[0]
            dst.to_local().copy_(self.move(rargs[0], lambda t: dst.placements).to_local())
            return dst
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation deriving an output's global
            # shape on fake tensors: no part of the step
            return func(*args, **kwargs)
        if func is torch.ops.aten.detach_.default and isinstance(args[0], DTensor):
            # changes no placement; DTensor has no strategy for it in some
            # torch versions (2.11), where autograd calls it on the output
            # of a redistribution
            args[0]._local_tensor.detach_()
            return args[0]
        if any(issubclass(t, DTensor) for t in types):
            if self._defer:
                return NotImplemented
            self._ops.append(func)
            try:
                # below autograd: what the op runs records no graph (the
                # op's own node is recorded above this mode)
                with self, torch.no_grad():
                    return self._place(func, args, kwargs)
            finally:
                self._ops.pop()
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = _COLLECTIVES.get(packet.__name__)
        if kind is not None:
            if not self._quiet:
                # the step's own (the EP combine's), or issued by DTensor's
                # own strategy for the op being placed; a functional
                # collective returns its result, c10d's ops (named with a
                # trailing "_") write it into their first argument
                self.count(kind, _nbytes(args[0] if packet.__name__.endswith("_") else out))
                if self._ops:
                    self.dtensor_ops[str(self._ops[-1])] += 1
        elif packet in flop_registry:
            self.matmul_flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        return out


_aten = torch.ops.aten
_RULES = {_aten.mm.default: _product, _aten.bmm.default: _product,
          _aten.view.default: _view, _aten._unsafe_view.default: _view,
          _aten._softmax.default: _softmax, _aten._log_softmax.default: _softmax,
          _aten._softmax_backward_data.default: _softmax,
          _aten._log_softmax_backward_data.default: _softmax,
          _aten.gather.default: _take, _aten.scatter_add.default: _take,
          _aten.scatter.src: _put, _aten.floor_divide.default: _pointwise,
          _aten.index.Tensor: _lookup, _aten.index_put.default: _scatter,
          _aten.index_put_.default: _write_into, _aten.copy_.default: _copy,
          _aten.cat.default: _cat, _aten.stack.default: _cat,
          **{op: _reduce for op in (_aten.sum.dim_IntList, _aten.sum.default,
                                    _aten.mean.dim, _aten.mean.default, _aten.amax.default)},
          **{op: _dims for op in (_aten.permute.default, _aten.transpose.int, _aten.t.default,
                                  _aten.unsqueeze.default, _aten.squeeze.default,
                                  _aten.squeeze.dim, _aten.squeeze.dims, _aten.select.int,
                                  _aten.expand.default, _aten.alias.default)},
          **{op: _fresh for op in (_aten.new_zeros.default, _aten.new_empty.default,
                                   _aten.new_ones.default, _aten.new_full.default,
                                   _aten.zeros_like.default, _aten.ones_like.default,
                                   _aten.empty_like.default, _aten.full_like.default)},
          _aten.select_backward.default: _unselect, _aten.unbind.int: _unbind,
          _aten.index_select.default: _index_select,
          _aten.constant_pad_nd.default: _dim_op("collective-permute", _pad_dims, 2),
          _aten.slice.Tensor: _dim_op("collective-permute", _slice_dims, 2),
          _aten.slice_backward.default: _dim_op("collective-permute",
                                                lambda a, k: (a[2],), 2),
          _aten.flip.default: _dim_op("collective-permute", lambda a, k: a[1]),
          _aten.cumsum.default: _dim_op("all-gather", lambda a, k: (a[1],)),
          _aten.sort.default: _dim_op("all-gather",
                                      lambda a, k: (a[1] if len(a) > 1 else -1,)),
          _aten.sort.stable: _dim_op("all-gather", lambda a, k: (k.get("dim", -1),))}


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process being
    ``rank``: collectives are accepted and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized in this process")
    dist.init_process_group("fake", world_size=world_size, rank=rank, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def chunked_mamba1_scan(chunk: int = 64):
    """The plain Mamba1 scan of sequences longer than ``chunk`` computed
    as ``ref.mamba1_scan_chunked`` (the same function, by chunks: about
    S / chunk + 3 chunk Python steps where ``ref.mamba1_scan`` takes S),
    which is what lets an SSM's train and prefill shapes finish on
    DTensors.  Decode steps (S = 1) keep the step-by-step scan."""
    from repro_torch.kernels import ref
    plain = ref.mamba1_scan

    def scan(x, dt, A, B, C, D, h0=None):
        if x.shape[1] > chunk:
            return ref.mamba1_scan_chunked(x, dt, A, B, C, D, h0, chunk=chunk)
        return plain(x, dt, A, B, C, D, h0)

    ref.mamba1_scan = scan
    try:
        yield
    finally:
        ref.mamba1_scan = plain


@contextlib.contextmanager
def propagation():
    """What a step on DTensors runs under: plain tensors that meet a
    DTensor count as replicated (``implicit_replication``), and
    ``DryRunMode`` counts and places the ops.  Yields the mode."""
    from torch.distributed.tensor.experimental import implicit_replication
    mode = DryRunMode()
    with implicit_replication(), mode:
        yield mode


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta, so that ``init_params`` draws
    every leaf as a meta tensor: shapes and types with no storage."""

    @property
    def device(self):
        return torch.device("meta")


def meta_params(cfg: ModelConfig) -> dict:
    return T.init_params(cfg, MetaGenerator())


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    return _nbytes(tree)


def opt_specs(params_tpl, pspecs, mesh):
    """ZeRO-ish optimizer-state sharding: additionally shard the stacked
    layer dim (or first unsharded dim divisible by the data axis) over
    "data"."""
    dsize = S.axis_size(mesh, "data")

    def f(tpl, spec):
        parts = list(spec) + [None] * (tpl.ndim - len(spec))
        for i, (dim, p) in enumerate(zip(tpl.shape, parts)):
            if p is None and dim % dsize == 0 and dim > 0:
                parts[i] = "data"
                break
        return P(*parts)

    return S.zip_map(f, params_tpl, pspecs)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """(global shape, dtype, spec) of every model input of this shape."""
    B, Ssz = shape.global_batch, shape.seq_len
    tok_spec = S.token_specs(cfg, mesh, B)
    frames = cfg.modality == "audio_frames"
    if frames:
        tok = ((B, Ssz, cfg.d_model), torch.bfloat16, tok_spec)
    else:
        tok = ((B, Ssz), torch.int32, tok_spec)
    if shape.kind == "train":
        lbl_spec = P(*tok_spec[:2]) if len(tok_spec) > 1 else tok_spec
        return {"inputs": tok, "labels": ((B, Ssz), torch.int32, lbl_spec)}
    if shape.kind == "prefill":
        return {"inputs": tok}
    # decode: one token per sequence + full cache
    if frames:
        return {"tokens": ((B, 1, cfg.d_model), torch.bfloat16, tok_spec)}
    return {"tokens": ((B, 1), torch.int32, P(tok_spec[0], None))}


def meta_inputs(mesh, ins: dict) -> dict:
    tpl = {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt, _) in ins.items()}
    return S.distribute(tpl, mesh, {k: sp for k, (_, _, sp) in ins.items()}, meta=True)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, remat="full",
               zero_opt: bool = True):
    """Returns (fn, args as meta DTensors)."""
    params_tpl = meta_params(cfg)
    pspecs = S.param_specs(cfg, params_tpl, mesh)
    params = S.distribute(params_tpl, mesh, pspecs, meta=True)
    ins = meta_inputs(mesh, input_specs(cfg, shape, mesh))

    if shape.kind == "train":
        opt_tpl = init_opt_state(params_tpl)
        osp = opt_specs(params_tpl, pspecs, mesh) if zero_opt else pspecs
        opt = S.distribute(opt_tpl, mesh, {"mu": osp, "nu": osp, "step": P()}, meta=True)
        step = make_train_step(cfg, AdamWConfig(),
                               remat="dots" if remat == "dots" else True)
        return step, (params, opt, ins["inputs"], ins["labels"])

    if shape.kind == "prefill":
        def serve_prefill(params, inputs):
            with torch.no_grad():
                logits, cache = T.forward_prefill(cfg, params, inputs, shape.seq_len)
            return logits[:, -1], cache
        return serve_prefill, (params, ins["inputs"])

    # decode
    cache_tpl = T.init_decode_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cspecs_d = S.kv_cache_specs(cfg, mesh, shape.global_batch)
    cache = S.distribute(cache_tpl, mesh, {k: cspecs_d[k] for k in cache_tpl}, meta=True)

    def serve_decode(params, cache, tokens):
        pos = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int32,
                         device="meta")
        with torch.no_grad():
            return T.forward_decode(cfg, params, cache, tokens, pos)
    return serve_decode, (params, cache, ins["tokens"])


def _mesh_for(multi_pod: bool, mesh_shape: str):
    if mesh_shape:
        # alternative factorization of the same rank count, e.g. "32,8"
        from torch.distributed.device_mesh import init_device_mesh
        dims = tuple(int(x) for x in mesh_shape.split(","))
        axes = ("pod", "data", "model")[-len(dims):]
        return init_device_mesh("cpu", dims, mesh_dim_names=axes), axes[:-1]
    mesh = make_production_mesh("cpu", multi_pod=multi_pod)
    return mesh, (("pod", "data") if multi_pod else ("data",))


def _write(rec: dict, outdir: str, tag_suffix: str) -> None:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x', '_')}" + tag_suffix
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)


def run_step(fn, args, ctx: DistContext) -> dict:
    """Run ``fn(*args)`` on its DTensors under ``ctx`` and ``propagation``:
    the record's measured keys."""
    with distribution(ctx), chunked_mamba1_scan(), propagation() as mode:
        out = fn(*args)
    return {"argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(out),
            "collective_bytes": dict(mode.collective_bytes),
            "collective_calls": dict(mode.collective_calls),
            "matmul_flops": mode.matmul_flops,
            "dtensor_ops": dict(mode.dtensor_ops),
            "resharded_ops": dict(mode.resharded_ops),
            "replicated_ops": dict(mode.replicated_ops)}


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            moe_impl: str = "gspmd", tag_suffix: str = "",
            pad_heads: int = 0, mesh_shape: str = "",
            kv_dtype: str = "", remat: str = "full",
            zero_opt: bool = True, rank: int = 0, smoke: bool = False) -> dict:
    """One combo on a fake world of the mesh's size, at ``rank``.
    ``smoke`` takes the arch's smoke config (the tests' small meshes)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch, smoke=smoke)
    skip = shape_skips(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_shape.replace(",", "x") if mesh_shape
           else ("2x16x16" if multi_pod else "16x16")}
    if moe_impl != "gspmd":
        rec["moe_impl"] = moe_impl
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        _write(rec, outdir, tag_suffix)
        return rec
    cfg = variant_for_shape(cfg, shape)
    rec["attn_variant"] = cfg.attn_variant
    if kv_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_dtype)
        rec["kv_cache_dtype"] = kv_dtype
    if remat != "full":
        rec["remat"] = remat
    if pad_heads:
        # physical head padding: round q/kv head counts up to a multiple of
        # the model-axis size so heads shard evenly (padded heads have zero
        # output rows: a layout change, not a model change)
        up = lambda n: -(-n // pad_heads) * pad_heads  # noqa: E731
        rec["padded_heads"] = [up(cfg.num_heads), up(cfg.num_kv_heads)]
        cfg = cfg.replace(num_heads=up(cfg.num_heads), num_kv_heads=up(cfg.num_kv_heads))
    t0 = time.time()
    try:
        world = (math.prod(int(x) for x in mesh_shape.split(",")) if mesh_shape
                 else 512 if multi_pod else 256)
        with fake_world(world, rank):
            mesh, dp = _mesh_for(multi_pod, mesh_shape)
            ctx = DistContext(mesh=mesh, data_axes=dp, moe_impl=moe_impl)
            fn, args = build_step(cfg, shape, mesh, remat=remat, zero_opt=zero_opt)
            rec.update(run_step(fn, args, ctx))
        rec["run_s"] = round(time.time() - t0, 2)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    _write(rec, outdir, tag_suffix)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--moe", default="gspmd", choices=["gspmd", "ep"])
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="round head counts up to this multiple")
    ap.add_argument("--mesh-shape", default="",
                    help="override mesh factorization, e.g. 32,8")
    ap.add_argument("--kv-dtype", default="", choices=["", "int8"])
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--no-zero", action="store_true",
                    help="disable ZeRO optimizer-state sharding")
    ap.add_argument("--rank", type=int, default=0, help="the fake rank this process plays")
    args = ap.parse_args(argv)
    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))
    for a, s in combos:
        rec = run_one(a, s, args.multi_pod, args.out, moe_impl=args.moe,
                      tag_suffix=args.tag, pad_heads=args.pad_heads,
                      mesh_shape=args.mesh_shape, kv_dtype=args.kv_dtype,
                      remat=args.remat, zero_opt=not args.no_zero, rank=args.rank)
        brief = {k: v for k, v in rec.items() if k != "traceback"}
        print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
