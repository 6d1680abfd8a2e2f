"""The port's model code against the JAX package on the same inputs and
weights: layers, parameter init and conversion, the DiT vocoder, and the
architecture configs.

Weights are made by the JAX package and carried across with
``repro_torch.convert.params_from_numpy``; inputs are numpy arrays from a
seed.  Tolerances: 2e-5 for f32 and 2e-2 for bf16, as in
tests/test_kernels.py, except where a test states otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import dit as jdit
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.configs.pipelines import tiny_lm
from repro_torch.convert import params_from_numpy
from repro_torch.models import dit as tdit
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT

torch.set_num_threads(1)
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_lm("t")
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    params = jT.init_params(jcfg, jax.random.PRNGKey(1))
    return cfg, jcfg, params, params_from_numpy(_to_np(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jL.rmsnorm({"scale": jnp.asarray(s).astype(jdt)}, jnp.asarray(x).astype(jdt))
    got = tL.rmsnorm({"scale": torch.from_numpy(s).to(tdt)}, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6]], np.int32)
    want = jL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv_and_mlp_match_jax(tiny, qkv_bias):
    cfg, jcfg, params, tparams = tiny
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jattn = dict(jax.tree.map(lambda a: a[0], params["blocks"]["attn"]))
    if qkv_bias:
        for k, shape in (("bq", (4, 32)), ("bk", (2, 32)), ("bv", (2, 32))):
            jattn[k] = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    tattn = params_from_numpy(_to_np(jattn))
    want = jL._qkv(jcfg.replace(qkv_bias=qkv_bias), jattn, jnp.asarray(x))
    got = tL._qkv(cfg.replace(qkv_bias=qkv_bias), tattn, torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    jmlp = jax.tree.map(lambda a: a[0], params["blocks"]["mlp"])
    tmlp = tL.tree_map(lambda a: a[0], tparams["blocks"]["mlp"])
    np.testing.assert_allclose(_np(tL.mlp(tmlp, torch.from_numpy(x))),
                               _np(jL.mlp(jmlp, jnp.asarray(x))), **F32)


def test_mlp_promotes_bf16_weights_like_jax(tiny):
    """An f32 activation against bf16 weights computes in f32 (prefill)."""
    _, _, params, _ = tiny
    jmlp = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16), params["blocks"]["mlp"])
    tmlp = params_from_numpy(_to_np(jmlp))
    x = np.random.default_rng(3).standard_normal((3, 128)).astype(np.float32)
    got = tL.mlp(tmlp, torch.from_numpy(x))
    want = jL.mlp(jmlp, jnp.asarray(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 6, 2, 32)).astype(np.float32)
    jq, js = jL.quantize_kv(jnp.asarray(x))
    tq, ts = tL.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


@pytest.mark.parametrize("arch,smoke", [("qwen2_5_14b", True), ("internlm2_1_8b", True),
                                        ("falcon_mamba_7b", True), ("zamba2_2_7b", True)])
def test_params_round_trip_and_layout(arch, smoke):
    """JAX params carried across are bit-identical (bf16 included), and
    the port's own init builds the same tree of shapes and dtypes."""
    jcfg = jbase.get_config(arch, smoke=smoke)
    tcfg = tbase.get_config(arch, smoke=smoke)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(_to_np(jp))
    own = tT.init_params(tcfg, torch.Generator().manual_seed(0))
    jl, tl, ol = list(_leaves(jp)), list(_leaves(tp)), list(_leaves(own))
    assert [k for k, _ in jl] == [k for k, _ in tl] == [k for k, _ in ol]
    for (k, j), (_, t), (_, o) in zip(jl, tl, ol):
        assert t.dtype == getattr(torch, str(j.dtype)), k
        assert tuple(t.shape) == tuple(j.shape) == tuple(o.shape), k
        assert o.dtype == t.dtype, k
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=k)


def test_params_from_numpy_bf16_bits():
    a = jnp.asarray([1.0, -2.5, 3.1415, 1e-3], jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))


ALL_CONFIGS = [(a, s) for a in jbase.ARCH_IDS for s in (False, True)]


@pytest.mark.parametrize("arch,smoke", ALL_CONFIGS)
def test_configs_equal_field_for_field(arch, smoke):
    j = dataclasses.asdict(jbase.get_config(arch, smoke=smoke))
    t = dataclasses.asdict(tbase.get_config(arch, smoke=smoke))
    assert t == j


# ---------------------------------------------------------------------------
# DiT vocoder
# ---------------------------------------------------------------------------

DIT = dict(name="v", num_layers=2, d_model=64, num_heads=2, d_ff=128, in_dim=16,
           cond_dim=48, num_steps=4)


@pytest.fixture(scope="module")
def dit():
    jcfg, tcfg = jdit.DiTConfig(**DIT), tdit.DiTConfig(**DIT)
    params = jdit.init_dit(jcfg, jax.random.PRNGKey(3))
    # adaLN-zero and the zero output projection make the built params a
    # trivial forward (0); random values make the parity test bite
    rng = np.random.default_rng(5)
    params["blocks"]["ada"] = jnp.asarray(
        0.05 * rng.standard_normal(params["blocks"]["ada"].shape), jnp.float32)
    params["out_proj"] = jnp.asarray(
        0.1 * rng.standard_normal(params["out_proj"].shape), jnp.float32)
    return jcfg, tcfg, params, params_from_numpy(_to_np(params))


@pytest.mark.parametrize("t_len,c_len", [(32, 16), (16, 8)])
def test_dit_forward_matches_jax(dit, t_len, c_len):
    jcfg, tcfg, jp, tp = dit
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, t_len, 16)).astype(np.float32)
    cond = rng.standard_normal((3, c_len, 48)).astype(np.float32)
    t = np.array([1.0, 0.5, 0.125], np.float32)
    want = jdit.dit_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = tdit.dit_forward(tcfg, tp, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(cond))
    assert float(np.abs(_np(want)).max()) > 1e-2          # not the trivial zero
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cache_interval", [1, 2])
def test_dit_sample_matches_jax_with_same_noise(dit, cache_interval):
    """sample() with the JAX key's noise handed over as a tensor; f32
    parity held at 1e-4 after 4 Euler steps of a 2-layer DiT."""
    jcfg, tcfg, jp, tp = dit
    cond = np.random.default_rng(7).standard_normal((2, 8, 48)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jdit.sample(jcfg, jp, jnp.asarray(cond), 16, key,
                       cache_interval=cache_interval)
    noise = jax.random.normal(key, (2, 16, 16), dtype=jnp.float32)
    got = tdit.sample(tcfg, tp, torch.from_numpy(cond), 16,
                      torch.from_numpy(np.asarray(noise)), cache_interval=cache_interval)
    assert not np.allclose(_np(want), np.asarray(noise))   # the sampler moved x
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_dit_sample_from_generator_is_deterministic(dit):
    _, tcfg, _, tp = dit
    cond = torch.zeros(2, 8, 48)
    a = tdit.sample(tcfg, tp, cond, 16, torch.Generator().manual_seed(3))
    b = tdit.sample(tcfg, tp, cond, 16, torch.Generator().manual_seed(3))
    assert a.shape == (2, 16, 16) and torch.equal(a, b)


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 0.25, 1.0], np.float32)
    np.testing.assert_allclose(
        _np(tdit.timestep_embedding(torch.from_numpy(t), 64)),
        _np(jdit.timestep_embedding(jnp.asarray(t), 64)), **F32)
