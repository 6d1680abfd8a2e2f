"""The placement rules of the port's dry-run (``repro_torch/launch/dryrun.py:
DryRunMode``), op by op on meta DTensors of a fake (2, 4) mesh, and the
whole step at smoke width.

Each case checks the output's placements and the bytes counted, by kind,
per device (rank 0's shards; float32, 4 bytes an element):
  - ``flip`` and ``cumsum`` along a dim sharded over "model" (a flip is one
    collective-permute of the result's shard; a cumulative sum gathers the
    dim), forward and backward, and along an unsharded dim (nothing);
  - a reshape that merges a batch dim sharded over "data" with heads over
    "model" (both shards on the merged dim, the heads' strided; nothing
    moved) and the split back (the heads' shard again);
  - an in-place cache write into a pool sharded over batch and heads: the
    written values gathered over "data" only (the indexed batch dim),
    kept on their heads' shards;
  - ``cat`` along a sharded dim (an all-to-all of the result's shard);
  - ``sum`` and ``mean`` over a sharded dim (the partial sums all-reduced);
  - every DTensor a rule builds from a local shard has the local shape
    DTensor computes for its placements (three smoke steps);
  - every arch x the four shapes at smoke width: no op placed by DTensor's
    own strategy (``dtensor_ops``), resharded or run replicated.
"""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch

from repro_torch.launch import dryrun as D


@pytest.fixture
def mesh():
    with D.fake_world(8):
        from torch.distributed.device_mesh import init_device_mesh
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


def _dt(mesh, shape, placements, grad=False):
    """A meta DTensor of global ``shape``: rank 0's shard of it."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(placements):
        if D._shard_dim(p) is not None:
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    t = DTensor.from_local(torch.empty(local, device="meta"), mesh, placements,
                           run_check=False, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    return t.requires_grad_() if grad else t


def _placements(*names):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if n == "R" else Shard(int(n[1:])) for n in names]


@pytest.mark.parametrize("op,sharded,forward,backward", [
    ("flip", True, {"collective-permute": 64}, {"collective-permute": 64}),
    ("flip", False, {}, {}),
    # the backward of a cumulative sum: flip, cumsum, flip
    ("cumsum", True, {"all-gather": 256}, {"all-gather": 256, "collective-permute": 128}),
    ("cumsum", False, {}, {})])
def test_flip_and_cumsum_along_a_dim(mesh, op, sharded, forward, backward):
    """(8, 16) over (data, model): dim 1 sharded over "model" (a shard of
    (4, 4): 64 bytes) or replicated there."""
    pl = _placements("S0", "S1" if sharded else "R")
    x = _dt(mesh, (8, 16), pl, grad=True)
    with D.propagation() as mode:
        y = torch.flip(x, [1]) if op == "flip" else torch.cumsum(x, 1)
        fwd = {k: v for k, v in mode.collective_bytes.items() if k != "total"}
        g, = torch.autograd.grad(y, x, _dt(mesh, (8, 16), pl))
    bwd = {k: v - fwd.get(k, 0) for k, v in mode.collective_bytes.items()
           if k != "total" and v - fwd.get(k, 0)}
    assert list(y.placements) == pl and list(g.placements) == pl
    assert fwd == forward and bwd == backward
    assert mode.dtensor_ops == {}


def test_a_reshape_merging_a_data_batch_with_model_heads_moves_nothing(mesh):
    from torch.distributed.tensor import Shard
    x = _dt(mesh, (8, 4, 6), _placements("S0", "S1"))     # batch over data, heads over model
    with D.propagation() as mode:
        merged = x.reshape(32, 6)
        split = merged.view(8, 4, 6)
    # rank 0 holds batch rows 0-3 and head 0 of each: 4 rows of the 32,
    # one of every four (the heads' shard strided, over 4 batch rows)
    assert tuple(merged.placements) == (Shard(0), Shard(0)) and D._strided(merged) == {1: 4}
    assert tuple(merged.to_local().shape) == (4, 6)
    assert tuple(split.placements) == (Shard(0), Shard(1)) and D._strided(split) == {}
    assert mode.collective_bytes == {} and mode.dtensor_ops == {}


def test_an_in_place_cache_write_into_a_sharded_pool(mesh):
    """pool (B 4, S 16, kv 8, hd 6) over batch (data) and kv heads (model);
    ``pool[rows, col] = values`` with values (4, 8, 6) lying alike: the
    values are gathered over "data" (the indexed batch dim: their (2, 2,
    6) shard, 96 bytes, twice) and stay on their heads' shard."""
    pool = _dt(mesh, (4, 16, 8, 6), _placements("S0", "S2"))
    values = _dt(mesh, (4, 8, 6), _placements("S0", "S1"))
    with D.propagation() as mode:
        rows = torch.arange(4, device="meta")
        pool[rows, torch.full((4,), 3, device="meta")] = values
    assert list(pool.placements) == _placements("S0", "S2")
    assert dict(mode.collective_bytes) == {"all-gather": 192, "total": 192}
    assert mode.dtensor_ops == {} and mode.resharded_ops == {}


def test_cat_along_a_sharded_dim(mesh):
    a, b = _dt(mesh, (8, 16), _placements("S0", "S1")), _dt(mesh, (8, 8), _placements("S0", "S1"))
    with D.propagation() as mode:
        c = torch.cat([a, b], 1)
    assert list(c.placements) == _placements("S0", "S1") and tuple(c.shape) == (8, 24)
    assert tuple(c.to_local().shape) == (4, 6)
    assert dict(mode.collective_bytes) == {"all-to-all": 96, "total": 96}     # 4 x 6 x 4 bytes
    assert mode.dtensor_ops == {}


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_a_reduction_over_a_sharded_dim_sums_its_partials(mesh, op):
    x = _dt(mesh, (8, 16), _placements("S0", "S1"))
    with D.propagation() as mode:
        y = getattr(x, op)(1)
    assert list(y.placements) == _placements("S0", "R") and tuple(y.shape) == (8,)
    assert dict(mode.collective_bytes) == {"all-reduce": 16, "total": 16}     # (4,) f32
    assert mode.dtensor_ops == {}


@pytest.mark.parametrize("combo", ["qwen2_5_14b:train_4k", "qwen3_moe_30b_a3b:train_4k",
                                   "zamba2_2_7b:prefill_32k"])
def test_every_local_shard_has_the_shape_dtensor_gives_it(combo, monkeypatch):
    """Each DTensor a rule builds from a local shard (attention's merged
    batch and heads, the MoE's dispatch, the chunked Mamba2 scan) holds
    the local shape that DTensor computes for its placements."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    built, bad = [0], []
    plain = DTensor.from_local

    def checked(local, mesh=None, placements=None, *, shape=None, **kw):
        if shape is not None:
            built[0] += 1
            want, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                            tuple(placements))
            if tuple(want) != tuple(local.shape):
                bad.append((tuple(shape), placements, tuple(local.shape)))
        return plain(local, mesh, placements, shape=shape, **kw)

    monkeypatch.setattr(DTensor, "from_local", staticmethod(checked))
    arch, shape = combo.split(":")
    rec = D.run_one(arch, shape, False, "", mesh_shape="2,4", smoke=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert built[0] > 100 and not bad, bad[:3]


def _smoke_ops(combo: str):
    from repro_torch.launch import dryrun as D
    arch, shape = combo.split(":")
    rec = D.run_one(arch, shape, False, "", mesh_shape="2,4", smoke=True)
    return combo, {k: rec.get(k) for k in ("status", "error", "dtensor_ops", "resharded_ops",
                                            "replicated_ops")}


@pytest.fixture(scope="module")
def smoke_records():
    from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
    combos = [f"{a}:{s}" for a in ARCH_IDS for s in INPUT_SHAPES]
    with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn")) as ex:
        return dict(ex.map(_smoke_ops, combos))


def test_every_smoke_combo_is_placed_by_the_ports_own_rules(smoke_records):
    bad = {c: r for c, r in smoke_records.items()
           if r["status"] == "error" or r["dtensor_ops"] or r["resharded_ops"]
           or r["replicated_ops"]}
    assert not bad, bad
    assert sum(r["status"] == "ok" for r in smoke_records.values()) == 38
