"""The f32 arithmetic of the mma.sync flash route, on the CPU.

The CUDA kernel computes f32 attention on the tensor cores through split
TF32 products: each operand a = a_hi + a_lo with both parts rounded to
TF32 (``cvt.rna.tf32.f32``), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
accumulated in f32.  ``repro_torch.kernels.ref.flash_attention_tf32x3``
is that arithmetic in plain PyTorch.  It is held here against the JAX
package's oracle ``repro.kernels.ref.flash_attention`` at the f32
tolerance of 2e-5 (rtol = atol) on numpy inputs from a seed, at head_dim
32, 80 and 128, causal and not, with windows, ragged Sq/Sk (rows at
negative causal positions included) and GQA g = 5.  This is the check
that chose split TF32 over CUDA-core f32 for the kernel.  The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [32, 80, 128])
@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal,window", [
    (2, 64, 64, 4, 4, True, 0),        # causal
    (1, 48, 48, 4, 2, False, 0),       # not causal
    (1, 70, 70, 4, 4, True, 16),       # a window
    (1, 40, 90, 4, 4, False, 25),      # a window without causality, Sq < Sk
    (1, 77, 33, 4, 2, True, 0),        # Sq > Sk: rows at negative positions average V
    (1, 50, 50, 10, 2, True, 0),       # GQA g = 5
    (2, 33, 65, 10, 2, False, 0),      # ragged, g = 5
])
def test_tf32x3_attention_matches_oracle(hd, b, sq, sk, nq, nkv, causal, window):
    rng = np.random.default_rng(hd + sq + sk + nq)
    q = rng.standard_normal((b, sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, nkv, hd)).astype(np.float32)
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window))
    got = tref.flash_attention_tf32x3(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal, window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    """10 mantissa bits kept; the 13 dropped bits round to nearest, a tie
    away from zero (cvt.rna), for either sign."""
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's spacing above 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23, one + 3 * ulp / 2,
                      -(one + ulp / 2), 3.0, 2.0 ** -30], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + 2 * ulp, -(one + ulp), 3.0, 2.0 ** -30],
                        dtype=torch.float32)
    assert torch.equal(tref._tf32(x), want)


def test_tf32_split_keeps_f32_precision():
    """hi + lo recovers an f32 value to about 2^-21 of its magnitude,
    where one TF32 rounding keeps about 2^-11."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tref._tf32(x)
    lo = tref._tf32(x - hi)
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0 ** -20
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -14
