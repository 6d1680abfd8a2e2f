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

``DryRunMode`` watches the step and places its ops as GSPMD would,
where DTensor would leave the choice to its cost model (which moves
with the torch version) or has no strategy:
  - a product (``mm``, ``bmm``) moves one operand to the other's layout,
    whichever way moves fewer bytes, partial sums included; a
    contraction sharded over a mesh dim is summed right away, in f32
    (``_product``);
  - a softmax along a sharded dim all-reduces its maxima and sums
    (``_softmax``); a gather along a sharded dim, and an embedding
    lookup in a table whose rows are sharded, take each rank's own range
    and sum the result (``_take``, ``_lookup``); its gradient's
    scatter-add sums each rank's updates (``_accumulate``); a pointwise
    op moves its smaller operands to its largest one's layout
    (``_pointwise``);
  - an in-place write into a sharded tensor (a decode step's cache
    column) stays on each rank's shard, only its values and indices
    replicated, as GSPMD partitions a scatter; an op DTensor cannot
    place as it comes (a view that splits a dim sharded over "model"
    unevenly: GQA's head grouping) runs with its operands replicated
    over one mesh dim.  Both are counted in ``resharded_ops``;
  - only an op that none of these place runs with every operand
    replicated over the whole mesh, counted in ``replicated_ops``.
The math never changes: the placements decide only where each part is
computed and what crosses between ranks.

Each record keeps the JAX record's keys that have a counterpart:
``arch``, ``shape``, ``mesh``, ``moe_impl``, ``status``, ``reason``,
``attn_variant``, ``kv_cache_dtype``, ``remat``, ``padded_heads``,
``error``, ``traceback``; ``argument_size_in_bytes`` and
``output_size_in_bytes`` per device (the local shards' bytes);
``collective_bytes`` by kind (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``) and ``total``: the result tensors'
bytes of each collective as it is dispatched, the JAX parser's
convention.  It adds ``run_s`` (building the meta arguments and running
the step), ``collective_calls``, ``matmul_flops`` (per device, the
products that ``torch.utils.flop_counter`` knows: not XLA's ``flops``,
which counts every op), ``resharded_ops`` and ``replicated_ops``.

Left out, as XLA's alone: ``lower_s``, ``compile_s``,
``temp_size_in_bytes``, ``generated_code_size_in_bytes``, ``bytes``,
``uncorrected_total``, and the HLO parser ``collective_bytes`` with its
while-loop trip counts: the port's layer loop is Python, so every
collective is counted once per call and nothing needs correcting.  A
mesh on the "cpu" device type has no all-to-all in DTensor, which moves
a shard between dims with an all-gather instead (counted as such).
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


def _redistribute(a, placements_of):
    """Every DTensor in ``a`` redistributed to ``placements_of(dtensor)``."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        want = tuple(placements_of(a))
        return a if want == tuple(a.placements) else a.redistribute(a.device_mesh, want)
    if isinstance(a, (list, tuple)):
        return type(a)(_redistribute(x, placements_of) for x in a)
    return a


def _replicate(a, mesh_dims=None):
    """DTensors replicated over ``mesh_dims`` (every mesh dim if None)."""
    from torch.distributed.tensor import Replicate
    return _redistribute(a, lambda t: [
        Replicate() if mesh_dims is None or i in mesh_dims else p
        for i, p in enumerate(t.placements)])


def _summed(t):
    """``t``'s placements with its partial sums summed (replicated)."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial() else p for p in t.placements]


def _sum_partials(t):
    """A DTensor's partial placements summed (all-reduced) at once."""
    return _redistribute(t, _summed)


def _shard_dim(p):
    """The tensor dim a placement shards (``Shard`` or ``_StridedShard``),
    else None."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    return p.dim if isinstance(p, (Shard, _StridedShard)) else None


def _lhs_placements(a, b):
    """Where ``a`` must lie for ``a @ b`` (mm or bmm) to need no move of
    ``b``: per mesh dim, sharded on its contraction dim where ``b`` is,
    replicated where ``b`` shards its columns or is partial, on the same
    batch dim as ``b``, and as it is where ``b`` is replicated (unless
    its contraction dim is sharded there alone)."""
    from torch.distributed.tensor import Replicate, Shard
    nd = a.ndim
    want = []
    for pa, pb in zip(a.placements, b.placements):
        db, da = _shard_dim(pb), _shard_dim(pa)
        if db == nd - 2:
            want.append(Shard(nd - 1))
        elif db == nd - 1 or pb.is_partial():
            want.append(Replicate())
        elif db is not None:
            want.append(pb)
        elif da == nd - 1:
            want.append(Replicate())
        else:
            want.append(pa)
    return want


def _rhs_placements(a, b):
    """``_lhs_placements`` the other way round: where ``b`` must lie for
    ``a @ b`` to need no move of ``a``."""
    from torch.distributed.tensor import Replicate, Shard
    nd = b.ndim
    want = []
    for pa, pb in zip(a.placements, b.placements):
        da, db = _shard_dim(pa), _shard_dim(pb)
        if da == nd - 1:
            want.append(Shard(nd - 2))
        elif da == nd - 2 or pa.is_partial():
            want.append(Replicate())
        elif da is not None:
            want.append(pa)
        elif db == nd - 2:
            want.append(Replicate())
        else:
            want.append(pb)
    return want


def _local_bytes(t, placements) -> float:
    n = t.numel() * t.element_size()
    for i, p in enumerate(placements):
        if _shard_dim(p) is not None:
            n /= t.device_mesh.size(i)
    return n


def _move_bytes(t, want) -> float:
    """The result bytes of the collectives that take ``t`` to ``want``,
    one mesh dim after the other: all-gather (a shard to replicated),
    all-to-all (a shard to another dim), all-reduce or reduce-scatter (a
    partial sum); a replicated tensor is sliced for nothing."""
    cur, total = list(t.placements), 0.0
    for i, (src, dst) in enumerate(zip(t.placements, want)):
        if src == dst:
            continue
        local, n = _local_bytes(t, cur), t.device_mesh.size(i)
        if src.is_partial():
            total += local if dst.is_replicate() else local / n
        elif _shard_dim(src) is not None:
            total += local * n if dst.is_replicate() else local
        cur[i] = dst
    return total


def _product(mode, func, args, kwargs):
    """``mm`` / ``bmm`` placed as GSPMD places a product: one operand
    moves to the other's layout, whichever way moves fewer bytes (the
    left one on a tie, so that a weight, or in the backward the output's
    gradient, stays; a weight sharded on its rows stays, and the sum
    over them follows).
    A contraction sharded over a mesh dim leaves each rank a partial sum:
    it is kept in f32 (the product accumulates in f32), all-reduced at
    once in f32 and rounded once, the rule of the EP combine
    (``models/moe_ep.py``); XLA's partitioned HLO also all-reduces the
    partial sums of a bf16 product in f32 on the CPU.  When the output
    is larger than both operands with their contraction dim gathered
    (the scores of a backward through attention), the contraction dim is
    gathered instead."""
    from torch.distributed.tensor import DTensor, Replicate
    a, b = args[:2]
    if len(args) > 2 or kwargs or not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return NotImplemented
    nd = a.ndim
    dtype = torch.promote_types(a.dtype, b.dtype)
    ways = ((_lhs_placements(a, b), list(b.placements)),
            (list(a.placements), _rhs_placements(a, b)))
    pa, pb = min(ways, key=lambda w: _move_bytes(a, w[0]) + _move_bytes(b, w[1]))
    summed = [i for i, q in enumerate(pa) if _shard_dim(q) == nd - 1 or q.is_partial()]
    if summed:
        # the output's local bytes against both operands' with the
        # contraction dim gathered
        out = a.numel() // a.shape[-1] * b.shape[-1] * dtype.itemsize
        for i, (qa, qb) in enumerate(zip(pa, pb)):
            if _shard_dim(qa) in range(nd - 1) or _shard_dim(qb) == nd - 1:
                out /= a.device_mesh.size(i)
        gathered = math.prod(a.device_mesh.size(i) for i in summed)
        if out > gathered * (_local_bytes(a, pa) + _local_bytes(b, pb)):
            pb = [Replicate() if i in summed else q for i, q in enumerate(pb)]
            pa = [Replicate() if i in summed else q for i, q in enumerate(pa)]
    a, b = _redistribute(a, lambda t: pa), _redistribute(b, lambda t: pb)
    out_p = _product_placements(a.placements, b.placements, nd)
    if out_p is None:                 # a layout these rules do not make
        return func(a, b)
    partial = any(p.is_partial() for p in out_p)
    la, lb = a.to_local(), b.to_local()
    # the local product, placed by the rules above (DTensor's own
    # propagation of a batch dim sharded over two mesh dims is slow)
    local = func(la.float(), lb.float()) if partial else func(la, lb)
    shape = (*a.shape[:-1], b.shape[-1])
    out = DTensor.from_local(local, a.device_mesh, out_p, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return _sum_partials(out).to(dtype) if partial else out


def _product_placements(pa, pb, nd):
    """The placements of ``a @ b`` from its operands' (mm or bmm, ``nd``
    dims), or None where they do not line up."""
    from torch.distributed.tensor import Partial
    out = []
    for qa, qb in zip(pa, pb):
        da, db = _shard_dim(qa), _shard_dim(qb)
        if da == nd - 1 and db == nd - 2 or (qa.is_partial() and qb.is_replicate()) or (
                qb.is_partial() and qa.is_replicate()):
            out.append(Partial())
        elif da is not None and da < nd - 1 and (qb == qa if da < nd - 2 else
                                                 qb.is_replicate()):
            out.append(qa)
        elif qa.is_replicate() and (db == nd - 1 or qb.is_replicate()):
            out.append(qb)
        else:
            return None
    return out


def _softmax(mode, func, args, kwargs):
    """A softmax (or log-softmax, or either's backward) along a sharded
    dim, as GSPMD computes it: local maxima and sums, each all-reduced
    over the rows (a (rows, 1) tensor), instead of gathering the dim."""
    from torch.distributed.tensor import DTensor
    name = func._overloadpacket.__name__
    backward = name.endswith("_backward_data")
    x, dim = args[0], args[2 if backward else 1] % args[0].ndim
    if (kwargs or not all(isinstance(t, DTensor) for t in args[:2 if backward else 1])
            or not any(_shard_dim(p) == dim for p in x.placements)):
        return NotImplemented

    def total(t):
        return _sum_partials(t.sum(dim, keepdim=True))

    if not backward:
        if args[2] and x.dtype != torch.float32:          # half_to_float
            x = x.float()
        z = x - _sum_partials(x.amax(dim, keepdim=True))
        return z - total(z.exp()).log() if name == "_log_softmax" else z.exp() / total(z.exp())
    g, y = args[0], args[1]
    if name == "_softmax_backward_data":
        return y * (g - total(g * y))
    return g - y.exp() * total(g)                          # _log_softmax_backward_data


def _take(mode, func, args, kwargs):
    """``gather`` (and the ``scatter_add`` of its backward) along a dim
    sharded over one mesh dim, as GSPMD partitions it: each rank takes
    (or adds into) the entries of its own range, an index elsewhere
    giving zero; the gathered values are summed over that mesh dim (an
    all-reduce of the index's shape) and a scatter needs nothing."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x, dim, index = args[:3]
    dim %= x.ndim
    src = args[3] if len(args) > 3 else None
    if not isinstance(x, DTensor):
        return NotImplemented
    sharded = [i for i, p in enumerate(x.placements) if _shard_dim(p) == dim]
    if (kwargs or not all(isinstance(t, DTensor) for t in args[:4:2])
            or (src is not None and not isinstance(src, DTensor))
            or len(sharded) != 1 or not isinstance(x.placements[sharded[0]], Shard)):
        return NotImplemented
    i, mesh = sharded[0], x.device_mesh
    n, size = mesh.size(i), x.shape[dim]
    if size % n:
        return NotImplemented
    rest = [Replicate() if j == i else p for j, p in enumerate(x.placements)]
    index = index.redistribute(mesh, rest)
    width = size // n
    local = index.to_local() - mesh.get_local_rank(i) * width
    inside = (local >= 0) & (local < width)
    local = local.clamp(0, width - 1)
    if src is None:                                        # gather
        got = torch.gather(x.to_local(), dim, local)
        got = torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))
        out = DTensor.from_local(got, mesh, [Partial() if j == i else p
                                             for j, p in enumerate(rest)],
                                 run_check=False, shape=index.shape, stride=index.stride())
        return _sum_partials(out)
    src = src.redistribute(mesh, rest).to_local()          # scatter_add
    src = torch.where(inside, src, torch.zeros((), dtype=src.dtype, device=src.device))
    got = torch.scatter_add(x.to_local(), dim, local, src)
    return DTensor.from_local(got, mesh, x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _lookup(mode, func, args, kwargs):
    """``table[ids]`` with the table's rows sharded over one mesh dim, as
    GSPMD partitions an embedding: each rank looks up the ids of its own
    rows, zero for the others, and the rows are summed over that mesh dim
    (an all-reduce of the output: one rank's row is not zero, so the sum
    is exact in the table's type)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    table, indices = args[0], args[1]
    if (kwargs or not isinstance(table, DTensor) or len(indices) != 1
            or not isinstance(indices[0], DTensor)):
        return NotImplemented
    rows = [i for i, p in enumerate(table.placements) if _shard_dim(p) == 0]
    mesh, ids = table.device_mesh, indices[0]
    if (len(rows) != 1 or not isinstance(table.placements[rows[0]], Shard)
            or table.shape[0] % mesh.size(rows[0])
            or any(_shard_dim(p) not in (None, 0) and _shard_dim(q) is not None
                   for p, q in zip(table.placements, ids.placements))):
        return NotImplemented
    i = rows[0]
    ids = ids.redistribute(mesh, [Replicate() if j == i else p
                                  for j, p in enumerate(ids.placements)])
    # the output's layout: the ids', and the table's sharded feature dim
    out_p = [Partial() if j == i else Shard(ids.ndim) if _shard_dim(p) == 1 else q
             for j, (p, q) in enumerate(zip(table.placements, ids.placements))]
    width = table.shape[0] // mesh.size(i)
    local = ids.to_local() - mesh.get_local_rank(i) * width
    inside = (local >= 0) & (local < width)
    local = local.clamp(0, width - 1)
    inside = inside.reshape(*inside.shape, *[1] * (table.ndim - 1))
    got = table.to_local()[local]
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))
    shape = (*ids.shape, *table.shape[1:])
    out = DTensor.from_local(got, mesh, out_p, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return _sum_partials(out)


def _accumulate(mode, func, args, kwargs):
    """``index_put(table, [ids], values, accumulate=True)`` (an
    embedding's gradient) into a replicated table, as GSPMD partitions a
    scatter-add: each rank adds the updates it holds into zeros, the sums
    over the mesh dims that shard the updates are all-reduced, and the
    table adds them (DTensor's strategies for it differ between torch
    versions)."""
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
    values = values.redistribute(mesh, [p if _shard_dim(p) is not None else Replicate()
                                        for p in ids.placements])
    local = table.to_local()
    delta = torch.index_put(torch.zeros_like(local), [ids.to_local()], values.to_local(), True)
    delta = DTensor.from_local(delta, mesh, [Partial() if _shard_dim(p) is not None
                                             else Replicate() for p in ids.placements],
                               run_check=False, shape=table.shape, stride=table.stride())
    return table + _sum_partials(delta)


def _pointwise(mode, func, args, kwargs):
    """A pointwise op on operands that lie differently: the largest
    operand (the first of equals: the residual stream in ``x + y``)
    keeps its layout and the others move to it, as GSPMD propagates the
    activation's sharding to a bias, where DTensor's cost model may
    instead slice the activation to a sharded bias's layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dts = [a for a in args if isinstance(a, DTensor)]
    if (kwargs or len(dts) < 2 or any(d.device_mesh != dts[0].device_mesh for d in dts)
            or any(not (isinstance(p, Shard) or p.is_replicate())
                   for d in dts for p in d.placements)):
        return NotImplemented
    lead = max(dts, key=lambda d: d.numel())          # max keeps the first of equals

    def place(t):
        out = []
        for p in lead.placements:
            dim = None if p.is_replicate() else p.dim - (lead.ndim - t.ndim)
            out.append(Shard(dim) if dim is not None and dim >= 0 and t.shape[dim] > 1
                       else Replicate())
        return out

    return func(*[_redistribute(a, place) if isinstance(a, DTensor) else a for a in args])


class DryRunMode(TorchDispatchMode):
    """Counts, per device, the collectives' result bytes by kind and the
    products' operations, and places the ops whose placement DTensor
    would leave to its cost model or cannot make (see the module
    docstring).

    A DTensor op is handed to DTensor (``NotImplemented`` on the nested
    call), with this mode active again, so that the local ops and the
    collectives DTensor issues for it come back here on local tensors."""

    def __init__(self):
        super().__init__()
        self.collective_bytes: Counter = Counter()
        self.collective_calls: Counter = Counter()
        self.resharded_ops: Counter = Counter()
        self.replicated_ops: Counter = Counter()
        self.matmul_flops = 0
        self._in_dtensor = 0

    def _attempt(self, func, args, kwargs):
        """``func`` on these arguments, or None if DTensor has no strategy
        for them or cannot make the redistribution its strategy asks for
        (an IndexError in some torch versions' redistribution planner):
        the collectives of a failed attempt are not counted (an error of
        the op itself comes back from the replicated run)."""
        saved = (self.collective_bytes.copy(), self.collective_calls.copy(), self.matmul_flops)
        try:
            return func(*args, **kwargs), True
        except (RuntimeError, NotImplementedError, IndexError):
            self.collective_bytes, self.collective_calls, self.matmul_flops = saved
            return None, False

    def _place(self, func, args, kwargs):
        rule = _RULES.get(func)
        if rule is not None:
            out = rule(self, func, args, kwargs)
            if out is not NotImplemented:
                return out
        out, ok = self._attempt(func, args, kwargs)
        if ok:
            # a reduction over a sharded dim leaves partial sums: GSPMD sums
            # them at once, where DTensor leaves them to the next op, whose
            # strategy for them moves with the torch version
            return out if func._schema.is_mutable else _redistribute(out, _summed)
        if func._schema.is_mutable and args[0].to_local().is_meta:
            # an in-place write (a decode step's cache column): each rank
            # writes its own shard where it lies, as GSPMD partitions a
            # scatter; only the written values and indices are replicated.
            # The op runs on meta tensors of the global shapes, which
            # checks them
            self.resharded_ops[str(func)] += 1
            func(*_global_meta(args), **{k: _global_meta(v) for k, v in kwargs.items()})
            _replicate((args[1:], tuple(kwargs.values())))
            return args[0]
        # replicate over one mesh dim, the last first (a view that splits
        # a dim sharded over "model" unevenly: GQA's head grouping)
        dts = _dtensors((args, tuple(kwargs.values())))
        one_mesh = all(d.device_mesh == dts[0].device_mesh
                       and len(d.placements) == dts[0].device_mesh.ndim for d in dts)
        for i in reversed(range(dts[0].device_mesh.ndim if one_mesh else 0)):
            if all(d.placements[i].is_replicate() for d in dts):
                continue
            rargs = _replicate(args, {i})
            out, ok = self._attempt(func, rargs, {k: _replicate(v, {i})
                                                  for k, v in kwargs.items()})
            if ok:
                self.resharded_ops[str(func)] += 1
                return self._write_back(func, args, rargs, out)
        self.replicated_ops[str(func)] += 1
        rargs = _replicate(args)
        out = func(*rargs, **{k: _replicate(v) for k, v in kwargs.items()})
        return self._write_back(func, args, rargs, out)

    @staticmethod
    def _write_back(func, args, rargs, out):
        if func._schema.is_mutable:          # write back in the original layout
            dst = args[0]
            dst.copy_(rargs[0].redistribute(dst.device_mesh, dst.placements))
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
            if self._in_dtensor:
                return NotImplemented
            self._in_dtensor += 1
            try:
                # below autograd: what the op runs records no graph (the
                # op's own node is recorded above this mode)
                with self, torch.no_grad():
                    return self._place(func, args, kwargs)
            finally:
                self._in_dtensor -= 1
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = _COLLECTIVES.get(packet.__name__)
        if kind is not None:
            # a functional collective returns its result; c10d's ops (named
            # with a trailing "_") write it into their first argument
            nb = _nbytes(args[0] if packet.__name__.endswith("_") else out)
            self.collective_bytes[kind] += nb
            self.collective_bytes["total"] += nb
            self.collective_calls[kind] += 1
        elif packet in flop_registry:
            self.matmul_flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        return out


_aten = torch.ops.aten
_RULES = {_aten.mm.default: _product, _aten.bmm.default: _product,
          _aten._softmax.default: _softmax, _aten._log_softmax.default: _softmax,
          _aten._softmax_backward_data.default: _softmax,
          _aten._log_softmax_backward_data.default: _softmax,
          _aten.gather.default: _take, _aten.scatter_add.default: _take,
          _aten.index.Tensor: _lookup, _aten.index_put.default: _accumulate,
          **{op: _pointwise for op in (_aten.add.Tensor, _aten.sub.Tensor, _aten.mul.Tensor,
                                       _aten.div.Tensor, _aten.where.self)}}


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
