"""The port's Mamba scans and blocks against the JAX package's, on the
same numpy inputs and the same weights.

  - ``ref.mamba1_scan`` against the JAX oracle and the Pallas kernel in
    interpret mode, at the shapes and tolerances of tests/test_kernels.py
    (f32 1e-4, bf16 5e-2 on y; the f32 state at 1e-4);
  - a ragged S against the JAX oracle only (the Pallas kernel asserts
    that its sequence block divides S), and chunked continuation;
  - ``ref.mamba2_scan`` against the JAX oracle (f32 1e-5);
  - ``mamba_block`` (Mamba1 and Mamba2) with and without carried state,
    on the falcon_mamba and zamba2 smoke configs: f32 at 1e-4, bf16 at
    2e-2 of the outputs' scale (the frameworks round bf16 at other
    places inside the block).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba1_scan as pallas_scan
from repro.models import mamba as jM
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba as tM

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jnp.float32).astype(jdt), torch.from_numpy(
        np.asarray(x, np.float32)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scan_inputs(rng, bt, s, di, n, dtype="float32", h0=False):
    """x, dt, A, B, C, D (and h0) as (jax, torch) pairs; dt is
    softplus(normal) * 0.1 and A = -exp(0.3 normal), as the JAX test draws."""
    x = rng.standard_normal((bt, s, di)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, di)))) * 0.1
    A = -np.exp(rng.standard_normal((di, n)) * 0.3)
    B = rng.standard_normal((bt, s, n))
    C = rng.standard_normal((bt, s, n))
    D = 1.0 + 0.1 * rng.standard_normal(di)
    out = [_pair(x, dtype), _pair(dt, dtype), _pair(A), _pair(B, dtype), _pair(C, dtype),
           _pair(D)]
    if h0:
        out.append(_pair(rng.standard_normal((bt, di, n))))
    return [j for j, _ in out], [t for _, t in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,s,di,n", [(1, 64, 128, 8), (2, 128, 256, 16)])
def test_mamba1_scan_ref_matches_jax_and_pallas(bt, s, di, n, dtype):
    jin, tin = _scan_inputs(np.random.default_rng(0), bt, s, di, n, dtype)
    y, h = tref.mamba1_scan(*tin)
    assert y.dtype == DTYPES[dtype][1] and h.dtype == torch.float32
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    jy, jh = jref.mamba1_scan(*jin)
    py, ph = pallas_scan(*jin, bd=128, bs=32, interpret=True)
    for want_y, want_h in ((jy, jh), (py, ph)):
        np.testing.assert_allclose(_np(y), _np(want_y), **tol)
        np.testing.assert_allclose(_np(h), _np(want_h), rtol=1e-4, atol=1e-4)
    # the wrapper and the dispatch take the plain version for CPU tensors
    for got in (tms.mamba1_scan(*tin), ops.mamba1_scan(*tin)):
        assert torch.equal(got[0], y) and torch.equal(got[1], h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_scan_ragged_length_matches_jax_ref(dtype):
    """S = 100 with a carried state: the Pallas kernel asserts its block
    divides S, so the JAX oracle is the only reference."""
    jin, tin = _scan_inputs(np.random.default_rng(1), 2, 100, 128, 16, dtype, h0=True)
    y, h = tref.mamba1_scan(*tin)
    jy, jh = jref.mamba1_scan(*jin)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [32, 37, 99])
def test_mamba1_scan_chunked_continuation_equals_whole(split):
    """Scanning [0, split) and then [split, S) from the carried state is
    the whole scan, in the port and against the JAX oracle's whole scan."""
    jin, tin = _scan_inputs(np.random.default_rng(2), 1, 100, 128, 8)
    x, dt, A, B, C, D = tin
    y_full, h_full = tref.mamba1_scan(*tin)
    y1, h1 = tref.mamba1_scan(x[:, :split], dt[:, :split], A, B[:, :split], C[:, :split], D)
    y2, h2 = tref.mamba1_scan(x[:, split:], dt[:, split:], A, B[:, split:], C[:, split:], D,
                              h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h2, h_full, rtol=1e-6, atol=1e-6)
    jy, jh = jref.mamba1_scan(*jin)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h2), _np(jh), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba2_scan_ref_matches_jax(with_h0):
    rng = np.random.default_rng(3)
    bt, s, nh, hp, n = 2, 40, 4, 16, 8
    x, dt = _pair(rng.standard_normal((bt, s, nh, hp))), _pair(
        np.log1p(np.exp(rng.standard_normal((bt, s, nh)))) * 0.1)
    A, D = _pair(-np.exp(rng.standard_normal(nh) * 0.3)), _pair(1 + 0.1 * rng.standard_normal(nh))
    B, C = _pair(rng.standard_normal((bt, s, n))), _pair(rng.standard_normal((bt, s, n)))
    args = [x, dt, A, B, C, D]
    if with_h0:
        args.append(_pair(rng.standard_normal((bt, nh, hp, n))))
    jy, jh = jref.mamba2_scan(*[j for j, _ in args])
    for fn in (tref.mamba2_scan, ops.mamba2_scan):
        y, h = fn(*[t for _, t in args])
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_and_causal_conv_match_jax(dtype):
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.standard_normal(64) * 8, [-40.0, -20.5, 0.0, 19.9, 20.1, 35.0]])
    jv, tv = _pair(v, dtype)
    np.testing.assert_allclose(_np(tM.softplus(tv)), _np(jax.nn.softplus(jv)),
                               rtol=1e-6 if dtype == "float32" else 1e-2)
    (jx, tx), (jw, tw), (jb, tb), (js, ts) = (
        _pair(rng.standard_normal(shape), dtype)
        for shape in ((2, 9, 24), (4, 24), (24,), (2, 3, 24)))
    for state in ((None, None), (js, ts)):
        jy, jst = jM._causal_conv(jx, jw, jb, state[0])
        ty, tst = tM._causal_conv(tx, tw, tb, state[1])
        assert ty.dtype == tx.dtype and tst.dtype == tx.dtype
        tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(_np(ty), _np(jy), **tol)
        np.testing.assert_array_equal(_np(tst), _np(jst))


# ---------------------------------------------------------------------------
# Mamba blocks
# ---------------------------------------------------------------------------

def _block_pair(arch, dtype, seed=5):
    """One Mamba layer of the arch's smoke config in ``dtype``, made by the
    JAX package (with its zero/constant leaves perturbed so that they
    bite) and carried across."""
    jcfg = jbase.get_config(arch, smoke=True).replace(dtype=dtype)
    tcfg = tbase.get_config(arch, smoke=True).replace(dtype=dtype)
    p = jax.tree.map(np.asarray, jM.init_mamba(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias", "D"):
        p[k] = (p[k].astype(np.float32) + 0.3 * rng.standard_normal(p[k].shape)).astype(
            p[k].dtype)
    p["A_log"] = p["A_log"] + 0.2 * rng.standard_normal(p["A_log"].shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    return jcfg, tcfg, jp, params_from_numpy(p)


def _close(got, want, dtype, rtol=1e-4):
    g, w = _np(got), _np(want)
    if dtype == "bfloat16":
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_2_7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_jax_with_and_without_state(arch, dtype):
    """A 12-token segment from zero state, then a 5-token segment and a
    1-token (decode) step from the carried state."""
    jcfg, tcfg, jp, tp = _block_pair(arch, dtype)
    rng = np.random.default_rng(6)
    jstate, tstate = None, None
    block = jax.jit(lambda x, st: jM.mamba_block(jcfg, jp, x, st))
    for s in (12, 5, 1):
        jx, tx = _pair(rng.standard_normal((2, s, jcfg.d_model)), dtype)
        jy, jstate = block(jx, jstate)
        ty, tstate = tM.mamba_block(tcfg, tp, tx, tstate)
        assert ty.dtype == tx.dtype
        _close(ty, jy, dtype)
        assert tstate[0].dtype == torch.float32 and tstate[1].dtype == tx.dtype
        _close(tstate[0], jstate[0], dtype)
        _close(tstate[1], jstate[1], dtype)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_2_7b"])
def test_init_mamba_layout_and_sizes_match_jax(arch):
    cfg = tbase.get_config(arch, smoke=True)
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    jp = jM.init_mamba(jcfg, jax.random.PRNGKey(0))
    tp = tM.init_mamba(cfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(1 for v in tp.values() for _ in (v.values()
                                                                if isinstance(v, dict) else [v]))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == getattr(torch, str(leaf.dtype))
    for k in ("A_log", "D", "dt_bias", "conv_b"):      # log(i) may differ in the last ulp
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6, atol=0)
    assert (tM.dt_rank(cfg), tM.n_heads2(cfg), tM.mamba2_head_dim(cfg)) == (
        jM.dt_rank(jcfg), jM.n_heads2(jcfg), jM.mamba2_head_dim(jcfg))
    for got, want in zip(tM.init_mamba_state(cfg, 3), jM.init_mamba_state(jcfg, 3)):
        assert tuple(got.shape) == want.shape and got.dtype == getattr(torch, str(want.dtype))
