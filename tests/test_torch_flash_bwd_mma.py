"""The arithmetic of the mma flash backward, on the CPU.

The CUDA backward's ``"mma"`` route (``csrc/flash_attention_bwd.cu``:
bf16 at head_dim 32 and 80 on ``mma.sync`` m16n8k16, f32 at every
head_dim as three m16n8k8 TF32 products of split operands) takes the
rows' logsumexp from the forward, walks tiles of 128 keys and 64 query
rows (32 in f32), and sums dQ over key tiles in f32.  Here, on numpy
inputs from a seed, against ``jax.vjp`` of the JAX package's oracle
``repro.kernels.ref.flash_attention`` (what its custom VJP,
``repro.kernels.ops._fa_bwd``, computes), at the f32 tolerance of 2e-5
(rtol = atol, as tests/test_kernels.py):

- ``ref.flash_attention_bwd_tiled`` at the bf16 kernel's tiles (in f32,
  and, rounded to bf16 as the kernel packs P^T and dS^T, at the bf16
  tolerance of 2e-2) at head_dim 32 and 80;
- ``ref.flash_attention_bwd_tiled(tf32x3=True)`` at the f32 kernel's
  tiles at every head_dim: causal, windows, ragged S, GQA;
- the mma forward's lse arithmetic (``ref.flash_attention_tf32x3(
  return_lse=True)``) against a numpy logsumexp;
- ``ops.FlashAttention`` carrying lse from its forward to its backward
  on every route;
- ``flash_attention.bwd_plan``: tiles, and the split of small grids.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
H100_SMS = 132
NEG_INF = -2.0 ** 30


def _inputs(seed, b, s, nq, nkv, hd, bf16=False):
    """q, k, v, dO from a seed; with ``bf16`` values that bf16 holds
    exactly, so that both packages see the same numbers."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd), (b, s, nq, hd)):
        x = rng.standard_normal(shape).astype(np.float32)
        if bf16:
            x = torch.from_numpy(x).bfloat16().float().numpy()
        out.append(x)
    return out


def _jax_vjp(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention(q_, k_, v_, causal=causal,
                                                              window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _tiles(dtype):
    return fa.BWD_TILES["mma", dtype]


CASES = [
    (2, 128, 8, 4, True, 0),       # the smoke configs' attention: causal GQA 2:1
    (1, 200, 4, 4, False, 0),      # the encoder: non-causal, S a multiple of neither tile
    (1, 300, 6, 2, True, 100),     # a window across key and query tiles, GQA 3:1
    (1, 77, 4, 2, False, 30),      # ragged, a window without causality
    (2, 1, 4, 2, True, 0),         # one row
]


@pytest.mark.parametrize("hd", [32, 80])
@pytest.mark.parametrize("b,s,nq,nkv,causal,window", CASES)
def test_bf16_tiling_matches_jax_vjp(hd, b, s, nq, nkv, causal, window):
    """The bf16 kernel's walk (64 query rows by 128 keys), in f32, with the
    forward's lse, gives the custom VJP's gradients."""
    q, k, v, do = _inputs(s + nq + hd + window, b, s, nq, nkv, hd)
    want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention(tq, tk, tv, causal=causal, window=window, return_lse=True)
    bq, bk = _tiles(torch.bfloat16)
    got = tref.flash_attention_bwd_tiled(tq, tk, tv, o, tdo, lse, block_q=bq, block_k=bk,
                                         causal=causal, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("hd", [32, 80])
@pytest.mark.parametrize("b,s,nq,nkv,causal,window", CASES[:4])
def test_bf16_rounding_stays_within_the_bf16_tolerance_of_jax_vjp(hd, b, s, nq, nkv, causal,
                                                                   window):
    """In bf16 the walk rounds P^T and dS^T to bf16 before the products
    (the kernel packs them so) and its outputs to bf16: within 2e-2 of
    the custom VJP on the same (bf16-exact) inputs."""
    q, k, v, do = _inputs(s + hd + 1, b, s, nq, nkv, hd, bf16=True)
    want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = tref.flash_attention(tq, tk, tv, causal=causal, window=window, return_lse=True)
    bq, bk = _tiles(torch.bfloat16)
    got = tref.flash_attention_bwd_tiled(tq, tk, tv, o, tdo, lse, block_q=bq, block_k=bk,
                                         causal=causal, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), w, **BF16_TOL, err_msg=name)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("b,s,nq,nkv,causal,window", CASES + [
    (1, 129, 10, 2, True, 0),      # GQA g = 5, one row past a key tile
    (1, 160, 4, 1, False, 0),      # GQA 4, non-causal across two key tiles
])
def test_tf32x3_backward_matches_jax_vjp(hd, b, s, nq, nkv, causal, window):
    """The f32 kernel's arithmetic: each of the five products as three
    TF32 products of split operands, over 32 query rows by 128 keys, with
    the forward's lse."""
    q, k, v, do = _inputs(2 * s + nq + hd + window, b, s, nq, nkv, hd)
    want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention(tq, tk, tv, causal=causal, window=window, return_lse=True)
    bq, bk = _tiles(torch.float32)
    got = tref.flash_attention_bwd_tiled(tq, tk, tv, o, tdo, lse, block_q=bq, block_k=bk,
                                         causal=causal, window=window, tf32x3=True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def test_tf32x3_products_differ_from_single_tf32():
    """The split matters: one TF32 product per product (the high parts
    alone) misses the f32 tolerance that the three products meet."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, 1, 96, 4, 2, 64))
    o, lse = tref.flash_attention(q, k, v, causal=True, return_lse=True)
    want = tref.flash_attention_bwd(q, k, v, o, do, causal=True)
    got = tref.flash_attention_bwd_tiled(q, k, v, o, do, lse, block_q=32, causal=True,
                                         tf32x3=True)
    one = tref.flash_attention_bwd_tiled(*(tref._tf32(t) for t in (q, k, v)), o,
                                         tref._tf32(do), lse, block_q=32, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    assert any(not torch.allclose(x, w, **TOL) for x, w in zip(one, want))


def _lse_numpy(q, k, causal, window):
    b, s, nq, hd = q.shape
    kk = np.repeat(k.astype(np.float64), nq // k.shape[2], axis=2)
    sc = np.einsum("bihd,bjhd->bhij", q.astype(np.float64), kk) * hd ** -0.5
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    sc = np.where(mask, sc, NEG_INF)
    m = sc.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(sc - m).sum(-1))) / np.log(2.0)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 20)])
def test_mma_forward_lse_matches_numpy_logsumexp(hd, causal, window):
    """The mma forward's epilogue in f32 (split TF32 scores, row max plus
    log of the row sum, log2 units) against a numpy logsumexp, and its
    output against the plain forward's."""
    q, k, v, _ = _inputs(hd + window, 1, 90, 4, 2, hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tref.flash_attention_tf32x3(tq, tk, tv, causal=causal, window=window,
                                           return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 90)
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, causal, window), **TOL)
    plain = tref.flash_attention_tf32x3(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 32), (torch.float32, 64),
                                      (torch.float32, 80), (torch.float32, 128),
                                      (torch.bfloat16, 32), (torch.bfloat16, 80),
                                      (torch.bfloat16, 64)])
def test_flash_attention_function_carries_lse_on_every_route(dtype, hd, monkeypatch):
    """``ops.FlashAttention`` on CPU tensors hands its forward's lse to the
    backward whatever the route, and its gradients are the tiled walk's at
    that route's tiles."""
    route = fa.bwd_route(dtype, hd)
    q, k, v, do = _inputs(hd, 1, 70, 4, 2, hd, bf16=dtype == torch.bfloat16)
    seen = []
    plain_bwd = tref.flash_attention_bwd

    def spy(*args, lse=None, **kwargs):
        seen.append(lse)
        return plain_bwd(*args, lse=lse, **kwargs)

    monkeypatch.setattr(tref, "flash_attention_bwd", spy)
    t = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = tops.FlashAttention.apply(*t, True, 0)
    out.backward(torch.from_numpy(do).to(dtype))
    assert len(seen) == 1 and seen[0] is not None and seen[0].shape == (1, 4, 70)
    x = [a.detach() for a in t]
    _, lse = tref.flash_attention(*x, causal=True, return_lse=True)
    torch.testing.assert_close(seen[0], lse, rtol=0, atol=0)
    bq, bk = fa.BWD_TILES[route, dtype]
    want = tref.flash_attention_bwd_tiled(*x, out.detach(), torch.from_numpy(do).to(dtype),
                                          lse, block_q=bq, block_k=bk, causal=True,
                                          tf32x3=dtype == torch.float32)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    for a, w in zip(t, want):
        torch.testing.assert_close(a.grad.float(), w.float(), **tol)


@pytest.mark.parametrize("dtype,hd,b,s,nq,nkv,splits", [
    (torch.float32, 32, 2, 128, 8, 4, 8),       # smoke f32: 8 CTAs, 2 heads x 4 tiles each
    (torch.bfloat16, 32, 2, 128, 8, 4, 4),      # smoke bf16: 64-row tiles, 4 items each
    (torch.float32, 80, 1, 77, 4, 2, 6),        # ragged S 77: 2 CTAs
    (torch.bfloat16, 80, 2, 1000, 16, 16, 1),   # HuBERT-XLarge: 256 CTAs
    (torch.bfloat16, 80, 4, 1000, 16, 16, 1),
    (torch.bfloat16, 80, 1, 2048, 32, 32, 1),   # Zamba2's attention: 512 CTAs
    (torch.bfloat16, 80, 1, 1000, 8, 8, 3),     # 64 CTAs: 3 each fill the card
    (torch.bfloat16, 128, 1, 128, 4, 4, 1),     # wgmma never splits
])
def test_bwd_plan_splits_small_grids(dtype, hd, b, s, nq, nkv, splits):
    p = fa.bwd_plan(dtype, b, s, nq, nkv, hd, H100_SMS)
    bq, bk = fa.BWD_TILES[p.route, dtype]
    assert (p.block_q, p.block_k) == (bq, bk) and p.route == fa.bwd_route(dtype, hd)
    assert p.splits == splits
    assert p.s_pad == -(-s // bq) * bq and p.key_tiles == -(-s // bk)
    assert p.dkv_floats == (2 * b * nkv * p.key_tiles * bk * hd if splits > 1 else 0)
    if splits > 1:   # never more CTAs than items to share
        assert splits <= nq // nkv * -(-s // bq)
