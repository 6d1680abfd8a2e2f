"""The arithmetic of the wgmma flash backward, on the CPU.

The CUDA backward for bf16 at head_dim 64 and 128
(``csrc/flash_attention_bwd.cu``, route ``"wgmma"``) takes the rows'
logsumexp from the forward instead of recomputing it, walks tiles of 128
keys and 64 query rows, and sums dQ over key tiles in f32.  Here, on
numpy inputs from a seed, in f32 at the tolerance of 2e-5 (rtol = atol,
as tests/test_kernels.py):

- ``ref.flash_attention(return_lse=True)``: the output against the JAX
  package's oracle ``repro.kernels.ref.flash_attention``, and lse (log2
  units) against a numpy logsumexp of the scaled, masked scores;
- ``ref.flash_attention_bwd_tiled`` (that tiling in plain PyTorch), fed
  the lse of the forward, against ``jax.vjp`` of the JAX oracle (what the
  JAX package's custom VJP, ``repro.kernels.ops._fa_bwd``, computes);
- ``ops.FlashAttention`` on CPU tensors carries lse from its forward to
  its backward;
- which backward route each (dtype, head_dim) takes.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
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
BLOCK_Q, BLOCK_K = 64, 128          # the wgmma kernel's tiles
NEG_INF = -2.0 ** 30


def _inputs(seed, b, sq, sk, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, nq, hd)).astype(np.float32)
    return q, k, v, do


def _lse_numpy(q, k, causal, window):
    """log2 of sum_j exp(scale q.k_j) over the visible keys, masked scores
    at -2**30 as the oracles mask them: (B, nq, Sq)."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), nq // nkv, axis=2)
    s = np.einsum("bihd,bjhd->bhij", q.astype(np.float64), kk) * hd ** -0.5
    pos = np.arange(sq)[:, None] + (sk - sq)
    j = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= j <= pos
    if window:
        mask &= j > pos - window
    s = np.where(mask, s, NEG_INF)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / np.log(2.0)


@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,causal,window", [
    (2, 64, 64, 4, 2, 32, True, 0),          # causal GQA 2:1
    (1, 200, 200, 4, 4, 64, True, 70),       # a window across tiles
    (1, 96, 96, 2, 1, 16, False, 0),         # not causal, GQA 2:1
    (1, 77, 77, 4, 2, 32, False, 30),        # ragged, a window without causality
    (1, 40, 90, 4, 2, 32, True, 0),          # Sq < Sk: ends aligned
])
def test_forward_lse_matches_oracle_and_logsumexp(b, sq, sk, nq, nkv, hd, causal, window):
    q, k, v, _ = _inputs(sq + nq + hd, b, sq, sk, nq, nkv, hd)
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window))
    out, lse = tref.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                    window=window, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, nq, sq)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, causal, window), **TOL)
    plain = tref.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                 window=window)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)


def _jax_vjp(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention(q_, k_, v_, causal=causal,
                                                              window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


BWD_CASES = [
    (2, 256, 4, 2, 32, True, 0),      # causal GQA 2:1, whole tiles
    (1, 300, 6, 2, 16, True, 100),    # a window across key and query tiles, GQA 3:1
    (1, 192, 4, 4, 32, False, 0),     # not causal
    (1, 77, 4, 2, 32, True, 0),       # S a multiple of neither tile
    (1, 1000, 4, 2, 16, True, 0),     # InternLM2's GQA, S a multiple of neither tile
    (1, 130, 2, 1, 32, False, 33),    # a window without causality
    (2, 1, 4, 2, 16, True, 0),        # one row
]


@pytest.mark.parametrize("b,s,nq,nkv,hd,causal,window", BWD_CASES)
def test_tiled_backward_matches_jax_vjp(b, s, nq, nkv, hd, causal, window):
    """The kernel's tiling with the forward's lse gives the gradients of
    the JAX package's custom VJP."""
    q, k, v, do = _inputs(s + nq + hd + window, b, s, s, nq, nkv, hd)
    want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention(tq, tk, tv, causal=causal, window=window, return_lse=True)
    got = tref.flash_attention_bwd_tiled(tq, tk, tv, o, tdo, lse, block_q=BLOCK_Q,
                                         block_k=BLOCK_K, causal=causal, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("b,s,nq,nkv,hd,causal,window", BWD_CASES[:4])
def test_plain_backward_takes_the_forward_lse(b, s, nq, nkv, hd, causal, window):
    """``ref.flash_attention_bwd`` with the forward's lse equals itself
    recomputing it, and the jax.vjp gradients."""
    q, k, v, do = _inputs(s + hd, b, s, s, nq, nkv, hd)
    want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention(tq, tk, tv, causal=causal, window=window, return_lse=True)
    with_lse = tref.flash_attention_bwd(tq, tk, tv, o, tdo, causal=causal, window=window,
                                        lse=lse)
    recomputed = tref.flash_attention_bwd(tq, tk, tv, o, tdo, causal=causal, window=window)
    for a, r, w in zip(with_lse, recomputed, want):
        np.testing.assert_allclose(a.numpy(), w, **TOL)
        np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL)


@pytest.mark.parametrize("block_q,block_k", [(64, 128), (32, 64), (64, 64), (16, 128)])
def test_tiled_backward_does_not_depend_on_the_tiles(block_q, block_k):
    """Other tile sizes walk other query ranges per key tile (causal and a
    window): the sums are the same."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, 1, 200, 200, 4, 2, 16))
    o, lse = tref.flash_attention(q, k, v, causal=True, window=50, return_lse=True)
    want = tref.flash_attention_bwd(q, k, v, o, do, causal=True, window=50)
    got = tref.flash_attention_bwd_tiled(q, k, v, o, do, lse, block_q=block_q,
                                         block_k=block_k, causal=True, window=50)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_tiled_backward_rounds_p_and_ds_as_the_kernel_does():
    """In bf16 the tiled version rounds P^T and dS^T to bf16 before the
    products (the kernel packs them so): its gradients stay within the
    bf16 tolerance of the f32 equations, and differ from the same walk
    without that rounding."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, 1, 160, 160, 4, 2, 32))
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    o, lse = tref.flash_attention(qb, kb, vb, causal=True, return_lse=True)
    got = tref.flash_attention_bwd_tiled(qb, kb, vb, o, dob, lse, causal=True)
    f32 = tref.flash_attention_bwd_tiled(*(t.float() for t in (qb, kb, vb, o, dob)), lse,
                                         causal=True)
    want = tref.flash_attention_bwd(qb, kb, vb, o, dob, causal=True)
    for g, f, w in zip(got, f32, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)
    assert any(not torch.equal(g.float(), f.bfloat16().float()) for g, f in zip(got, f32))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20), (False, 0)])
def test_flash_attention_function_carries_lse_to_its_backward(causal, window, monkeypatch):
    """``ops.FlashAttention`` on CPU tensors saves the forward's lse and
    hands it to the backward, whose gradients are the tiled version's."""
    q, k, v, do = _inputs(3, 2, 100, 100, 4, 2, 32)
    seen = []
    plain_bwd = tref.flash_attention_bwd

    def spy(*args, lse=None, **kwargs):
        seen.append(lse)
        return plain_bwd(*args, lse=lse, **kwargs)

    monkeypatch.setattr(tref, "flash_attention_bwd", spy)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tops.FlashAttention.apply(*t, causal, window)
    out.backward(torch.from_numpy(do))
    assert len(seen) == 1 and seen[0] is not None and seen[0].shape == (2, 4, 100)
    _, lse = tref.flash_attention(*(x.detach() for x in t), causal=causal, window=window,
                                  return_lse=True)
    torch.testing.assert_close(seen[0], lse, rtol=0, atol=0)
    want = tref.flash_attention_bwd_tiled(*(x.detach() for x in t), out.detach(),
                                          torch.from_numpy(do), lse, causal=causal,
                                          window=window)
    for x, w in zip(t, want):
        torch.testing.assert_close(x.grad, w, **TOL)
    jax_want = _jax_vjp(q, k, v, do, causal, window)
    for x, w in zip(t, jax_want):
        np.testing.assert_allclose(x.grad.numpy(), w, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_bwd_route_by_dtype_and_head_dim(dtype, hd):
    want = ("mma" if dtype == torch.float32
            else "wgmma" if hd in (64, 128) else "mma")
    assert fa.bwd_route(dtype, hd) == want
    # the backward takes its forward's route, whose lse it reads
    assert fa.route(dtype, hd) == want


def test_cpu_wrappers_return_lse_and_take_it():
    """On CPU tensors the wrappers run the plain versions, lse included."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 1, 70, 70, 4, 2, 64))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    want_out, want_lse = tref.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal=True), want_out, **TOL)
    got = fa.flash_attention_bwd(q, k, v, out, do, causal=True, lse=lse)
    for g, w in zip(got, tref.flash_attention_bwd(q, k, v, out, do, causal=True)):
        torch.testing.assert_close(g, w, **TOL)
