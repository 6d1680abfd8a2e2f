"""Expert-parallel MoE of the port (``repro_torch/models/moe_ep.py``) on
four ``gloo`` ranks of the CPU, f32 (and bf16, below), the smoke config of Qwen3-30B-A3B
(4 experts, top-2), on the same numpy weights and tokens as:

  - the JAX package's EP path (``shard_map``), run in a subprocess with 4
    forced host devices on the same (2, 2) mesh, at the default capacity
    factor, so that each data shard drops pairs of its own: y within
    2e-5, aux within 1e-6 (f32, the same sums in other orders);
  - the port's dense path, lossless (capacity_factor 1e9): y within 2e-4
    and aux within 2e-3, the bound and reason of tests/test_moe_ep.py
    (aux is a per-shard estimator there, equal to the global one only in
    expectation);
  - the port's dense path on a (1, 4) mesh at the default capacity: one
    data shard, so capacity and slot order are the dense path's: y within
    2e-5 and the dropped pairs, summed over the ranks, equal.

The same in bf16 (weights and tokens; the router in f32): the JAX EP
path within 2e-2 of y's scale (it psums y in bf16, rounding twice; the
port rounds once), and on the (1, 4) mesh the dense path's y bit for bit.

The DTensor call form (``local_map``) gives the plain call form's numbers
bit for bit.  ``spawn_ranks`` (used by the other sharding tests too) runs
one function on N spawned ranks joined through a ``FileStore``; a rank
that fails or outlives the timeout fails the test.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.base import get_config
from repro_torch.models import moe
from repro_torch.sharding.context import DistContext, distribution

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3_moe_30b_a3b"
B, SEQ = 4, 16
MESHES = {"ep22": ((2, 2), None), "ep22_lossless": ((2, 2), 1e9), "ep14": ((1, 4), None)}


def _rank_entry(target, rank, world, store_path, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world, tmp_path, *args, timeout=150):
    """``target(rank, world, *args)`` in ``world`` spawned processes joined
    by gloo.  Fails when a rank exits non-zero (the others are killed) or
    when any is still running after ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, store, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            assert not failed, f"a rank failed: exit codes {[p.exitcode for p in procs]}"
            assert time.monotonic() < deadline, f"ranks still running after {timeout} s"
            time.sleep(0.1)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def _cfg(capacity_factor=None, dtype="float32"):
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    return cfg if capacity_factor is None else cfg.replace(capacity_factor=capacity_factor)


def _data(seed=0) -> dict:
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    # a common direction in every token skews the routing, so that the
    # default capacity drops pairs
    x = rng.standard_normal((B, SEQ, d)) + 3.0 * rng.standard_normal(d)
    return {"router": rng.standard_normal((d, E)) / np.sqrt(d),
            "wg": rng.standard_normal((E, d, f)) / np.sqrt(d),
            "wu": rng.standard_normal((E, d, f)) / np.sqrt(d),
            "wd": rng.standard_normal((E, f, d)) / np.sqrt(f),
            "x": x}


def _tensors(data_path, dtype):
    """The weights and tokens in ``dtype``, the router in f32 (as
    ``init_moe`` keeps it)."""
    dt = getattr(torch, dtype)
    return {k: torch.from_numpy(v).float().to(torch.float32 if k == "router" else dt)
            for k, v in np.load(data_path).items()}


def _ep_rank(rank, world, data_path, out_dir, dtype="float32", meshes=tuple(MESHES)):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import specs as S
    d = _tensors(data_path, dtype)
    p = {k: d[k] for k in ("router", "wg", "wu", "wd")}
    out = {}
    for name in meshes:
        shape, cf = MESHES[name]
        cfg = _cfg(cf, dtype)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        e_loc, b_loc = cfg.num_experts // shape[1], B // shape[0]
        mr, dr = mesh.get_local_rank("model"), mesh.get_local_rank("data")
        local = {"router": p["router"]}
        for k in ("wg", "wu", "wd"):
            local[k] = p[k][mr * e_loc:(mr + 1) * e_loc]
        moe.drop_counter = torch.zeros((), dtype=torch.long)
        with distribution(DistContext(mesh=mesh, moe_impl="ep")):
            y, aux = moe.moe_forward(cfg, local, d["x"][dr * b_loc:(dr + 1) * b_loc])
        out[f"{name}_y"], out[f"{name}_aux"] = y.float().numpy(), aux.numpy()
        out[f"{name}_drops"] = moe.drop_counter.numpy()
        moe.drop_counter = None
        if name == "ep22":
            specs = {"router": S.P(), "wg": S.P("model", None, None),
                     "wu": S.P("model", None, None), "wd": S.P("model", None, None)}
            dp = S.distribute(p, mesh, specs)
            dx = distribute_tensor(d["x"], mesh, S.placements(mesh, S.P("data", None, None)))
            with distribution(DistContext(mesh=mesh, moe_impl="ep")):
                yd, auxd = moe.moe_forward(cfg, dp, dx)
            out["dtensor_y"] = yd.full_tensor().float().numpy()
            out["dtensor_aux"] = auxd.full_tensor()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


_JAX_EP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.models import moe
from repro.sharding.context import DistContext, distribution
d = np.load(sys.argv[1])
dtype = sys.argv[3]
cfg = get_config("qwen3_moe_30b_a3b", smoke=True).replace(dtype=dtype)
dt = jnp.dtype(dtype)
p = {k: jnp.asarray(d[k], jnp.float32).astype(jnp.float32 if k == "router" else dt)
     for k in ("router", "wg", "wu", "wd")}
x = jnp.asarray(d["x"], jnp.float32).astype(dt)
mesh = jax.make_mesh((2, 2), ("data", "model"))
with distribution(DistContext(mesh=mesh, moe_impl="ep")), mesh:
    y, aux = jax.jit(lambda p, x: moe.moe_forward(cfg, p, x))(p, x)
np.savez(sys.argv[2], y=np.asarray(y.astype(jnp.float32)), aux=np.asarray(aux))
"""


def _run(tmp, dtype, meshes=tuple(MESHES)):
    """The ranks and the JAX package's EP on the same data in ``dtype``."""
    data_path = str(tmp / "data.npz")
    np.savez(data_path, **_data())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_out = str(tmp / "jax.npz")
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_EP, data_path, jax_out, dtype],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True)
    try:
        spawn_ranks(_ep_rank, 4, tmp, data_path, str(tmp), dtype, meshes)
        log, _ = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, log
    ranks = [dict(np.load(str(tmp / f"rank{r}.npz"))) for r in range(4)]
    return {"ranks": ranks, "jax": dict(np.load(jax_out)), "data": _tensors(data_path, dtype)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("ep"), "float32")


@pytest.fixture(scope="module")
def runs_bf16(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("ep_bf16"), "bfloat16", ("ep22", "ep14"))


def _ep_y(ranks, name, shape):
    """The EP output over the whole batch: each data shard's rows from the
    rank of model index 0 in that shard (ranks are data-major)."""
    n_data, n_model = shape
    return np.concatenate([ranks[dr * n_model][f"{name}_y"] for dr in range(n_data)])


def _dense(data, capacity_factor=None, dtype="float32"):
    p = {k: data[k] for k in ("router", "wg", "wu", "wd")}
    moe.drop_counter = torch.zeros((), dtype=torch.long)
    try:
        y, aux = moe.moe_forward(_cfg(capacity_factor, dtype), p, data["x"])
        return y.float().numpy(), float(aux), int(moe.drop_counter)
    finally:
        moe.drop_counter = None


def test_ep_matches_the_jax_ep_path_with_per_shard_drops(runs):
    ranks = runs["ranks"]
    assert sum(int(r["ep22_drops"]) for r in ranks) > 0          # the shards drop pairs
    np.testing.assert_allclose(_ep_y(ranks, "ep22", (2, 2)), runs["jax"]["y"],
                               rtol=2e-5, atol=2e-5)
    for r in ranks:        # aux is replicated over every rank
        np.testing.assert_allclose(r["ep22_aux"], runs["jax"]["aux"], rtol=1e-6, atol=1e-6)


def test_ep_lossless_matches_the_dense_path(runs):
    y, aux, drops = _dense(runs["data"], capacity_factor=1e9)
    assert drops == 0
    np.testing.assert_allclose(_ep_y(runs["ranks"], "ep22_lossless", (2, 2)), y,
                               rtol=2e-4, atol=2e-4)
    assert abs(float(runs["ranks"][0]["ep22_lossless_aux"]) - aux) < 2e-3


def test_ep_on_one_data_shard_matches_the_dense_path_and_its_drops(runs):
    y, aux, drops = _dense(runs["data"])
    ranks = runs["ranks"]
    assert drops > 0
    assert sum(int(r["ep14_drops"]) for r in ranks) == drops
    for r in ranks:
        np.testing.assert_allclose(r["ep14_y"], y, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["ep14_aux"], aux, rtol=1e-6, atol=1e-6)


def test_bf16_ep_matches_the_jax_ep_path_within_bf16(runs_bf16):
    """bf16 weights and tokens: JAX psums y in bf16 (two roundings), the
    port sums f32 partials and rounds once, so y agrees within the bf16
    tolerance of tests/test_torch_moe.py, 2e-2 of its scale; the router
    runs in f32 in both, so aux agrees as in f32."""
    ranks, want = runs_bf16["ranks"], runs_bf16["jax"]["y"]
    assert sum(int(r["ep22_drops"]) for r in ranks) > 0
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_ep_y(ranks, "ep22", (2, 2)), want, rtol=0, atol=2e-2 * scale)
    for r in ranks:
        np.testing.assert_allclose(r["ep22_aux"], runs_bf16["jax"]["aux"], rtol=1e-6,
                                   atol=1e-6)


def test_bf16_ep_on_one_data_shard_equals_the_dense_path_bit_for_bit(runs_bf16):
    """One data shard (the dense path's capacity and slot order), bf16:
    each rank's partial y in f32, summed in f32 and rounded once, as the
    dense combine rounds once, so y is the dense path's bit for bit; the
    dropped pairs, summed over the ranks, are the dense path's."""
    y, aux, drops = _dense(runs_bf16["data"], dtype="bfloat16")
    ranks = runs_bf16["ranks"]
    assert drops > 0
    assert sum(int(r["ep14_drops"]) for r in ranks) == drops
    for r in ranks:
        np.testing.assert_array_equal(r["ep14_y"], y)
        np.testing.assert_allclose(r["ep14_aux"], aux, rtol=1e-6, atol=1e-6)


def test_ep_dtensor_form_equals_the_plain_form(runs):
    ranks = runs["ranks"]
    plain = _ep_y(ranks, "ep22", (2, 2))
    for r in ranks:
        np.testing.assert_array_equal(r["dtensor_y"], plain)
        np.testing.assert_array_equal(r["dtensor_aux"], r["ep22_aux"])


@dataclasses.dataclass
class _FakeMesh:
    shape: dict
    axis_names: tuple = ("data", "model")


@pytest.mark.parametrize("model,applies", [(1, True), (2, True), (4, True), (3, False),
                                           (8, False)])
def test_ep_applicable_needs_experts_divisible_by_the_model_axis(model, applies):
    cfg = _cfg()                                                  # 4 experts
    from repro_torch.models import moe_ep
    mesh = _FakeMesh({"data": 2, "model": model})
    assert not moe_ep.ep_applicable(cfg)                          # no context
    with distribution(DistContext(mesh=mesh, moe_impl="ep")):
        assert moe_ep.ep_applicable(cfg) is applies
    with distribution(DistContext(mesh=mesh, moe_impl="gspmd")):
        assert not moe_ep.ep_applicable(cfg)
