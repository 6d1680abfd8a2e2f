"""The port's plain attention versions (repro_torch.kernels.ref, and the
kernel wrappers and ops dispatch on CPU tensors) against the JAX
package's Pallas kernels (interpret=True) and its jnp oracles.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of tests/test_kernels.py: 2e-5 for f32, 2e-2 for
bf16 (the two packages round bf16 at the same places; only the order of
f32 sums differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jdt)
    t = torch.from_numpy(np.asarray(x, np.float32)).to(tdt)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 128, 8, 1, 128)]
FLASH_MASKS = [(True, 0), (True, 64), (False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nq,nkv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_ref_matches_jax(b, s, nq, nkv, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((b, s, nq, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((b, s, nkv, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((b, s, nkv, hd)), dtype)
    got = tref.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1]
    want = jref.flash_attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if dtype == "float32" and s == 128:
        pallas = pallas_flash(qj, kj, vj, causal=causal, window=window, bq=64, bk=64,
                              interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("sq,sk", [(32, 16), (16, 8), (32, 32), (7, 13)])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 4), (False, 5)])
def test_flash_ref_ragged_matches_jax_ref(sq, sk, causal, window):
    """Ragged shapes (the vocoder's cross-attention) against the JAX oracle
    only: the Pallas version asserts divisibility by its tile sizes."""
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((2, sq, 4, 32)), "float32")
    kj, kt = _pair(rng.standard_normal((2, sk, 2, 32)), "float32")
    vj, vt = _pair(rng.standard_normal((2, sk, 2, 32)), "float32")
    want = _np(jref.flash_attention(qj, kj, vj, causal=causal, window=window))
    for got in (tref.flash_attention(qt, kt, vt, causal=causal, window=window),
                tfa.flash_attention(qt, kt, vt, causal=causal, window=window),
                ops.flash_attention(qt, kt, vt, causal=causal, window=window)):
        np.testing.assert_allclose(_np(got), want, **_tol("float32"))


def _paged_inputs(rng, b, nq, nkv, hd, page, pp, dtype, zero_row=False):
    P = b * pp + 2
    qj, qt = _pair(rng.standard_normal((b, nq, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((P, page, nkv, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((P, page, nkv, hd)), dtype)
    bt = rng.permutation(P)[:b * pp].reshape(b, pp).astype(np.int32)
    sl = rng.integers(1, page * pp + 1, size=b).astype(np.int32)
    if zero_row:
        sl[0] = 0
    return (qj, kj, vj, jnp.asarray(bt), jnp.asarray(sl)), \
        (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(sl))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nkv,hd,page,pp", [
    (2, 8, 2, 64, 8, 4), (3, 4, 4, 128, 16, 2), (1, 16, 2, 64, 8, 8)])
@pytest.mark.parametrize("window", [0, 16])
def test_paged_ref_matches_jax(b, nq, nkv, hd, page, pp, window, dtype):
    rng = np.random.default_rng(2)
    jin, tin = _paged_inputs(rng, b, nq, nkv, hd, page, pp, dtype)
    got = tref.paged_attention(*tin, window=window)
    want = jref.paged_attention(*jin, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pallas = pallas_paged(*jin, window=window, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    # the wrapper and the dispatch take the plain version for CPU tensors
    np.testing.assert_allclose(_np(tpa.paged_attention(*tin, window=window)), _np(got))
    np.testing.assert_allclose(_np(ops.paged_attention(*tin, window=window)), _np(got))


@pytest.mark.parametrize("window", [0, 16])
def test_paged_ref_zero_length_rows_match_jax_ref(window):
    """Inactive decode slots (seq_len 0) average V in both plain versions."""
    rng = np.random.default_rng(3)
    jin, tin = _paged_inputs(rng, 3, 8, 2, 64, 8, 4, "float32", zero_row=True)
    got = _np(tref.paged_attention(*tin, window=window))
    want = _np(jref.paged_attention(*jin, window=window))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **_tol("float32"))


def test_paged_ref_int8_matches_jax():
    b, nq, nkv, hd, page, pp = 2, 8, 2, 64, 8, 4
    P = b * pp + 2
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, nq, hd)).astype(np.float32)
    kf = rng.standard_normal((P, page, nkv, hd)).astype(np.float32)
    vf = rng.standard_normal((P, page, nkv, hd)).astype(np.float32)

    def quant(x):
        s = (np.abs(x).max(-1) / 127.0 + 1e-8).astype(np.float32)
        return np.round(x / s[..., None]).astype(np.int8), s
    kq, ks = quant(kf)
    vq, vs = quant(vf)
    bt = rng.permutation(P)[:b * pp].reshape(b, pp).astype(np.int32)
    sl = np.array([13, 29], np.int32)
    j = [jnp.asarray(a) for a in (q, kq, vq, bt, sl, ks, vs)]
    t = [torch.from_numpy(a) for a in (q, kq, vq, bt, sl, ks, vs)]
    got = tref.paged_attention(*t[:5], k_scale_pages=t[5], v_scale_pages=t[6])
    want = jref.paged_attention(*j[:5], k_scale_pages=j[5], v_scale_pages=j[6])
    pallas = pallas_paged(*j[:5], k_scale_pages=j[5], v_scale_pages=j[6], interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2e-5, atol=2e-5)
    exact = tref.paged_attention(*[torch.from_numpy(a) for a in (q, kf, vf, bt, sl)])
    np.testing.assert_allclose(_np(got), _np(exact), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("window", [0, 8])
def test_chunk_attention_matches_jax(window):
    rng = np.random.default_rng(5)
    b, c, t, nq, nkv, hd = 2, 8, 40, 4, 2, 32
    qj, qt = _pair(rng.standard_normal((b, c, nq, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((b, t, nkv, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((b, t, nkv, hd)), "float32")
    start = np.array([5, 17], np.int32)
    got = tref.chunk_attention(qt, kt, vt, torch.from_numpy(start), window=window)
    want = jref.chunk_attention(qj, kj, vj, jnp.asarray(start), window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    # a scalar start, as the prefill runner passes it
    got = tref.chunk_attention(qt, kt, vt, 9, window=window)
    want = jref.chunk_attention(qj, kj, vj, 9, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    b, s, nq, nkv, hd = 2, 24, 4, 2, 32
    qj, qt = _pair(rng.standard_normal((b, 1, nq, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((b, s, nkv, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((b, s, nkv, hd)), "float32")
    pos = np.array([3, 20], np.int32)
    for window in (0, 6):
        got = tref.decode_attention(qt, kt, vt, torch.from_numpy(pos), window=window)
        want = jref.decode_attention(qj, kj, vj, jnp.asarray(pos), window=window)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_backend_dispatch_on_cpu():
    q = torch.zeros(1, 4, 2, 32)
    assert ops.get_backend() == "auto"
    before = (tpa.launches.value, tfa.launches.value, tms.launches.value)
    ops.flash_attention(q, q, q)            # auto on a CPU tensor: plain version
    ops.set_backend("cuda")
    try:
        with pytest.raises(RuntimeError, match="backend 'cuda'"):
            ops.flash_attention(q, q, q)
        with pytest.raises(RuntimeError, match="backend 'cuda'"):
            ops.mamba1_scan(q[0], q[0], torch.zeros(32, 1), q[0, :, :, :1], q[0, :, :, :1],
                            torch.zeros(32))
        with pytest.raises(RuntimeError, match="backend 'cuda'"):
            ops.paged_attention(q[:, 0], torch.zeros(2, 4, 2, 32), torch.zeros(2, 4, 2, 32),
                                torch.zeros(1, 1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))
    finally:
        ops.set_backend("auto")
    with pytest.raises(ValueError):
        ops.set_backend("pallas")
    # plain versions on the CPU are no kernel launches
    ops.mamba1_scan(q[0], q[0], torch.zeros(32, 1), q[0, :, :, :1], q[0, :, :, :1],
                    torch.zeros(32))
    assert (tpa.launches.value, tfa.launches.value, tms.launches.value) == before
