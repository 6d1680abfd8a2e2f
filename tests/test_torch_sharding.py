"""The port's sharding rules (``repro_torch/sharding/specs.py``) against the
JAX package's, on the JAX test's stand-in meshes (no devices, no process
group): the specs are pure data and must be equal as tuples.

  - ``param_specs`` of every ARCH_ID at its full config, on the 16x16 and
    the 2x16x16 mesh: JAX's from ``jax.eval_shape``, the port's from meta
    parameters;
  - ``kv_cache_specs`` for three archs at batch 128 and 1, fitted to the
    cache shapes;
  - ``batch_spec`` and ``token_specs``; ``fit_spec`` on 200 seeded random
    cases;
  - ``placements`` of multi-axis entries;
  - the dry-run's ``opt_specs`` and ``input_specs`` against
    ``repro.launch.dryrun``'s, which is imported only in a subprocess
    (its first lines force 512 host devices).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.models import transformer as jT
from repro.sharding import specs as JS
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": FakeMesh(), "2x16x16": FakePodMesh()}


def _norm(x):
    """Specs as nested tuples (JSON gives lists)."""
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    return x


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jtpl = jax.eval_shape(lambda: jT.init_params(jget_config(arch), jax.random.PRNGKey(0)))
    return jtpl, D.meta_params(get_config(arch))


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(k.key for k in path): tuple(v) for path, v in leaves}


def _flat_port(tree):
    out = {}
    S.map_with_path(lambda path, v: out.__setitem__(tuple(path), tuple(v)), tree)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh):
    jtpl, ttpl = _shapes(arch)
    m = MESHES[mesh]
    want = _flat_jax(JS.param_specs(jget_config(arch), jtpl, m))
    got = _flat_port(S.param_specs(get_config(arch), ttpl, m))
    assert got == want
    assert all(isinstance(s, S.PartitionSpec)
               for s in _leaves(S.param_specs(get_config(arch), ttpl, m)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", ["qwen2_5_14b", "falcon_mamba_7b", "zamba2_2_7b"])
def test_kv_cache_specs_equal_jax(arch, batch):
    jcache = jax.eval_shape(lambda: jT.init_decode_cache(jget_config(arch), batch, 32768))
    tcache = T.init_decode_cache(get_config(arch), batch, 32768, device="meta")
    assert set(jcache) == set(tcache)
    for mesh in MESHES.values():
        jspecs = JS.kv_cache_specs(jget_config(arch), mesh, batch)
        tspecs = S.kv_cache_specs(get_config(arch), mesh, batch)
        assert {k: tuple(v) for k, v in tspecs.items()} == {k: tuple(v) for k, v in jspecs.items()}
        for k in jcache:
            assert tuple(jcache[k].shape) == tuple(tcache[k].shape)
            assert tuple(S.fit_spec(mesh, tuple(tcache[k].shape), tspecs[k])) == tuple(
                JS.fit_spec(mesh, jcache[k].shape, jspecs[k]))


@pytest.mark.parametrize("batch", [256, 128, 32, 16, 3, 1])
def test_batch_and_token_specs_equal_jax(batch):
    for mesh in MESHES.values():
        assert S.batch_spec(mesh, batch) == JS.batch_spec(mesh, batch)
        for arch in ("qwen2_5_14b", "hubert_xlarge"):
            assert tuple(S.token_specs(get_config(arch), mesh, batch)) == tuple(
                JS.token_specs(jget_config(arch), mesh, batch))


def test_fit_spec_equals_jax_on_random_cases():
    rng = np.random.default_rng(0)
    entries = [None, "model", "data", "pod", ("data", "model"), ("pod", "data")]
    for i in range(200):
        mesh = MESHES["2x16x16"] if i % 2 else MESHES["16x16"]
        ndim = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 3, 8, 16, 24, 32, 48, 128, 2048])) for _ in range(ndim))
        n = int(rng.integers(0, ndim + 2))
        parts = [entries[int(j)] for j in rng.integers(0, len(entries) if i % 2 else 3, n)]
        want = JS.fit_spec(mesh, shape, JP(*parts))
        got = S.fit_spec(mesh, shape, S.P(*parts))
        assert tuple(got) == tuple(want), (shape, parts)


def test_partition_spec_normalises_as_jax_does():
    for parts in [(("data",), None), ((), "model"), (("pod", "data"), None, "model"), ()]:
        assert tuple(S.P(*parts)) == tuple(JP(*parts))


def test_placements_of_multi_axis_entries():
    from torch.distributed.tensor import Replicate, Shard
    pod = MESHES["2x16x16"]
    assert S.placements(pod, S.P(("pod", "data"), None, "model")) == (Shard(0), Shard(0),
                                                                      Shard(2))
    assert S.placements(pod, S.P(None, ("data", "model"))) == (Replicate(), Shard(1), Shard(1))
    assert S.placements(pod, S.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.placements(pod, S.P(("data", "pod"), None))
    assert S.local_shape(pod, (64, 8, 4096), S.P(("pod", "data"), None, "model")) == (2, 8, 256)


_JAX_DRYRUN_SPECS = r"""
import json, sys
import jax
from repro.configs.base import INPUT_SHAPES, get_config
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as T
from repro.sharding import specs as S

out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch)
        tpl = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
        ospecs = D.opt_specs(tpl, S.param_specs(cfg, tpl, mesh), mesh)
        flat = jax.tree_util.tree_flatten_with_path(
            ospecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        key = f"{arch}|{multi_pod}"
        out[key + "|opt"] = {"/".join(k.key for k in p): list(v) for p, v in flat}
        for name, shape in INPUT_SHAPES.items():
            ins = D.input_specs(cfg, shape, mesh)
            out[f"{key}|{name}"] = {k: [list(v.shape), str(v.dtype), list(v.sharding.spec)]
                                   for k, v in ins.items()}
print("SPECS" + json.dumps(out))
"""

_SPEC_ARCHS = ("qwen2_5_14b", "qwen3_moe_30b_a3b", "falcon_mamba_7b", "hubert_xlarge")


@pytest.fixture(scope="module")
def jax_dryrun_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_DRYRUN_SPECS, ",".join(_SPEC_ARCHS)],
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SPECS")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][5:])


@pytest.mark.parametrize("arch", _SPEC_ARCHS)
def test_opt_and_input_specs_equal_the_jax_dryrun(arch, jax_dryrun_specs):
    from repro_torch.configs.base import INPUT_SHAPES
    for multi_pod, mesh in ((False, MESHES["16x16"]), (True, MESHES["2x16x16"])):
        key = f"{arch}|{multi_pod}"
        cfg = get_config(arch)
        tpl = D.meta_params(cfg)
        ospecs = D.opt_specs(tpl, S.param_specs(cfg, tpl, mesh), mesh)
        got = {"/".join(p): v for p, v in _flat_port(ospecs).items()}
        assert got == {k: _norm(v) for k, v in jax_dryrun_specs[key + "|opt"].items()}
        for name, shape in INPUT_SHAPES.items():
            ins = D.input_specs(cfg, shape, mesh)
            want = jax_dryrun_specs[f"{key}|{name}"]
            assert set(ins) == set(want)
            for k, (shp, dt, spec) in ins.items():
                assert [list(shp), str(dt).replace("torch.", ""), tuple(spec)] == [
                    want[k][0], want[k][1], _norm(want[k][2])], (name, k)
