"""The plain references against the JAX package's forward, on the CPU, at
the smoke sizes of both configurations and of a Mamba1 model (the JAX
package is imported here only, never by the harness)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.models import transformer as JT

from omnibench import spec, weights
from omnibench.reference import model as ref


def _model(cfg) -> dict:
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                       "d_ff", "vocab_size", "rope_theta", "rmsnorm_eps",
                       "num_experts", "experts_per_token")}
    m["dtype"] = "float32"
    return m


def _jax_params(m: dict, seed: int) -> dict:
    p = weights.program_params(m, seed, "cpu")

    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(
            t.numpy())

    return conv(p)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen3_moe_30b_a3b"])
def test_reference_matches_the_jax_forward(arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32", capacity_factor=1e9)
    m = _model(cfg)
    seed = 2**31 + 11
    tokens = np.random.default_rng(0).integers(0, m["vocab_size"], size=(1, 40)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want, _ = JT.forward_full(cfg, _jax_params(m, seed), jnp.asarray(tokens), remat=False)
    want = np.asarray(want)[0]
    got = ref.logits(m, seed, [tokens[0].tolist()], [list(range(40))], "cpu")[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_mamba1_reference_matches_the_jax_forward():
    """Both sides in f32, the JAX products at "highest" precision: they
    differ only in the order of sums (the JAX package's scan against one
    position after another), which moves logits of magnitude ~4 by about
    1e-5; 2e-4 holds that with room, where a missing conv bias, D skip or
    gate moves them by tenths."""
    cfg = get_config("falcon_mamba_7b", smoke=True).replace(dtype="float32")
    m = {k: getattr(cfg, k) for k in ("num_layers", "d_model", "vocab_size", "rmsnorm_eps",
                                      "ssm_state", "ssm_expand", "ssm_conv")}
    m["dtype"] = "float32"
    fam = spec.family("mamba1")
    seed = 2**31 + 11
    p = fam.program_params(m, seed, "cpu")

    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(
            t.numpy())

    tokens = np.random.default_rng(0).integers(0, m["vocab_size"], size=(1, 40)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want, _ = JT.forward_full(cfg, conv(p), jnp.asarray(tokens), remat=False)
    got = fam.logits(m, seed, [tokens[0].tolist()], [list(range(40))], "cpu")[0].numpy()
    np.testing.assert_allclose(got, np.asarray(want)[0], atol=2e-4, rtol=2e-4)


def test_the_control_is_coarser_than_the_reference():
    cfg = get_config("internlm2_1_8b", smoke=True).replace(dtype="float32")
    m = _model(cfg)
    seq = list(range(1, 30))
    full = ref.logits(m, 5, [seq], [list(range(29))], "cpu")[0]
    low = ref.logits(m, 5, [seq], [list(range(29))], "cpu", quant="fp8")[0]
    err = (full - low).abs().max().item()
    assert 1e-3 < err < 0.5 * full.abs().max().item()


def test_each_layer_is_drawn_again_the_same():
    m = _model(get_config("qwen3_moe_30b_a3b", smoke=True))
    p = weights.program_params(m, 77, "cpu")
    again = weights.layer(m, 77, 1, "cpu")
    assert torch.equal(p["blocks"]["moe"]["wg"][1], again["moe"]["wg"])
    assert torch.equal(p["blocks"]["attn"]["wq"][1], again["attn"]["wq"])
    assert torch.equal(p["lm_head"], weights.top(m, 77, "cpu", "lm_head"))
    assert not torch.equal(p["blocks"]["attn"]["wq"][0], again["attn"]["wq"])
