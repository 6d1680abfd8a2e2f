"""The port's chunked Mamba2 scan (``ref.mamba2_scan_chunked``, the
state-space-duality form that ``ops.mamba2_scan`` takes above 64 steps)
against the JAX package's step-by-step ``ref.mamba2_scan``, on the same
numpy inputs:

  - y and h_last in f32 at rtol = atol = 2e-5, S in {1, 63, 64, 65, 200,
    1000} (ragged ones included), with and without h0, chunks of 64 and
    of 24; bf16 y at 2e-2 of its scale;
  - ``ops.mamba2_scan`` takes the chunked form above 64 steps and the
    step-by-step one up to 64, with no switch;
  - the gradients of a scalar loss of y and h_last through the chunked
    scan against ``jax.grad`` of the JAX scan at 2e-5, relative and of
    each gradient's scale (f32, S 200: sums of 200 terms reach ~60), none
    of them NaN;
  - ``mamba_block`` on the zamba2 smoke config (a 200-token segment, then
    a decode step from its state) and ``forward_prefill`` of a 200-token
    prompt against the JAX package at 1e-4 (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ref as jref
from repro.models import mamba as jM
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba as tM
from repro_torch.models import transformer as tT

torch.set_num_threads(1)

BT, NH, HP, N = 2, 4, 16, 8
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(s, h0, seed=0):
    """x, dt, A, B, C, D (and h0) as f32 numpy arrays, drawn as the JAX
    scan tests draw them: dt = 0.1 softplus(normal), A = -exp(0.3 normal)."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((BT, s, NH, HP)),
           np.log1p(np.exp(rng.standard_normal((BT, s, NH)))) * 0.1,
           -np.exp(rng.standard_normal(NH) * 0.3),
           rng.standard_normal((BT, s, N)), rng.standard_normal((BT, s, N)),
           1.0 + 0.1 * rng.standard_normal(NH)]
    if h0:
        out.append(rng.standard_normal((BT, NH, HP, N)))
    return [np.asarray(a, np.float32) for a in out]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("chunk", [64, 24])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1000])
def test_chunked_scan_matches_the_jax_scan(s, h0, chunk):
    args = _inputs(s, h0)
    jy, jh = jref.mamba2_scan(*[jnp.asarray(a) for a in args])
    y, h = tref.mamba2_scan_chunked(*[torch.from_numpy(a) for a in args], chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert tuple(y.shape) == (BT, s, NH, HP) and tuple(h.shape) == (BT, NH, HP, N)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


@pytest.mark.parametrize("s", [65, 200])
def test_chunked_scan_in_bf16_matches_the_jax_scan(s):
    """x, dt, B and C in bf16 (A and D f32, as the block passes them): y
    comes back in bf16 within 2e-2 of its scale, h_last in f32."""
    args = _inputs(s, True, seed=1)
    bf = {0, 1, 3, 4}
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if i in bf else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [torch.from_numpy(a).to(torch.bfloat16) if i in bf else torch.from_numpy(a)
             for i, a in enumerate(args)]
    jy, jh = jref.mamba2_scan(*jargs)
    y, h = tref.mamba2_scan_chunked(*targs)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    scale = max(1.0, float(np.abs(_np(jy)).max()))
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=2e-2 * scale)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


@pytest.mark.parametrize("s,chunked", [(1, False), (64, False), (65, True), (300, True)])
def test_ops_takes_the_chunked_scan_above_one_chunk(s, chunked, monkeypatch):
    calls = []
    for name in ("mamba2_scan", "mamba2_scan_chunked"):
        fn = getattr(tref, name)
        monkeypatch.setattr(tref, name, lambda *a, _fn=fn, _name=name, **k: (
            calls.append(_name), _fn(*a, **k))[1])
    args = [torch.from_numpy(a) for a in _inputs(s, True)]
    y, h = ops.mamba2_scan(*args)
    assert calls == ["mamba2_scan_chunked" if chunked else "mamba2_scan"]
    assert ops.MAMBA2_CHUNK == 64
    want = tref.mamba2_scan_chunked(*args, chunk=64) if chunked else tref.mamba2_scan(*args)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


def test_chunked_scan_gradients_match_jax_grad():
    """d/d(every input) of sum(y * wy) + sum(h_last * wh), S 200 (four
    chunks, the last ragged), from a given h0."""
    args = _inputs(200, True, seed=2)
    rng = np.random.default_rng(3)
    wy = rng.standard_normal((BT, 200, NH, HP)).astype(np.float32)
    wh = rng.standard_normal((BT, NH, HP, N)).astype(np.float32)

    def jloss(*a):
        y, h = jref.mamba2_scan(*a)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    jgrads = jax.grad(jloss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = tref.mamba2_scan_chunked(*targs)
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(h * torch.from_numpy(wh))).backward()
    for name, t, jg in zip(("x", "dt", "A", "B", "C", "D", "h0"), targs, jgrads):
        g = _np(t.grad)
        assert np.isfinite(g).all(), name
        scale = max(1.0, float(np.abs(_np(jg)).max()))     # up to ~60 here
        np.testing.assert_allclose(g, _np(jg), rtol=2e-5, atol=2e-5 * scale, err_msg=name)


def _zamba2(dtype="float32"):
    jcfg = jbase.get_config("zamba2_2_7b", smoke=True).replace(dtype=dtype)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg


def test_mamba_block_on_a_long_segment_matches_jax():
    """A 200-token segment from zero state (the chunked scan), then one
    decode step (the step-by-step scan) from the carried state, with
    A_log, D and dt_bias perturbed so that they bite."""
    jcfg, tcfg = _zamba2()
    p = jax.tree.map(np.asarray, jM.init_mamba(jcfg, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    for k in ("conv_b", "dt_bias", "D", "A_log"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(p[k].dtype)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p)
    block = jax.jit(lambda x, st: jM.mamba_block(jcfg, jp, x, st))
    jstate, tstate = None, None
    for s in (200, 1):
        x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
        jy, jstate = block(jnp.asarray(x), jstate)
        ty, tstate = tM.mamba_block(tcfg, tp, torch.from_numpy(x), tstate)
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
        for got, want in zip(tstate, jstate):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_forward_prefill_of_a_long_prompt_matches_jax():
    """Zamba2's smoke config, f32, one 200-token prompt: the logits and
    every layer's SSM and conv state."""
    jcfg, tcfg = _zamba2()
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (1, 200))
    jl, jc = jax.jit(lambda t: jT.forward_prefill(jcfg, jp, t, 256, remat=False))(
        jnp.asarray(toks))
    tl, tc = tT.forward_prefill(tcfg, tp, torch.from_numpy(toks).long(), 256)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert jleaves
    for path, want in jleaves:
        got = tc
        for key in path:
            got = got[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))
