"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit (the kernels
are built from src/repro_torch/kernels/csrc at first use); without a card
they skip.  Run them on the card (which has no JAX, so without the
repository's conftest) with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-5 for f32, 2e-2 for
bf16 (for the scan, bf16 on y, which is stored in bf16; its state is
f32).  Rows with seq_len 0 are compared for finiteness only: the kernel
reads no page for them (see kernels/paged_attention.py).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(dtype):
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    return dict(rtol=t, atol=t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd", [
    (2, 128, 128, 8, 2, 64), (8, 32, 16, 4, 4, 32), (1, 77, 200, 8, 1, 128),
    (1, 70, 70, 4, 4, 80)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0), (False, 9)])
def test_flash_kernel_matches_plain(cuda, b, sq, sk, nq, nkv, hd, causal, window, dtype):
    q = torch.randn((b, sq, nq, hd), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    v = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    n = fa.launches.value
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches.value == n + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_kernel_reads_strided_inputs(cuda):
    qkv = torch.randn((2, 40, 3, 4, 32), generator=cuda, device="cuda")
    q, k, v = qkv.unbind(2)                      # non-contiguous (B, S, H, hd) views
    got = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal=True), **_tol(None))


@pytest.mark.parametrize("dtype,quant", [(torch.float32, False), (torch.bfloat16, False),
                                         (torch.float32, True), (torch.bfloat16, True)])
@pytest.mark.parametrize("b,nq,nkv,hd,page,pp", [(3, 8, 2, 64, 8, 4), (4, 40, 8, 128, 16, 8),
                                                 (2, 4, 2, 32, 16, 16)])
@pytest.mark.parametrize("window", [0, 16])
def test_paged_kernel_matches_plain(cuda, b, nq, nkv, hd, page, pp, window, dtype, quant):
    P = b * pp + 2
    q = torch.randn((b, nq, hd), generator=cuda, device="cuda").to(dtype)
    kf = torch.randn((P, page, nkv, hd), generator=cuda, device="cuda")
    vf = torch.randn((P, page, nkv, hd), generator=cuda, device="cuda")
    if quant:
        ks, vs = kf.abs().amax(-1) / 127 + 1e-8, vf.abs().amax(-1) / 127 + 1e-8
        kp = torch.round(kf / ks[..., None]).to(torch.int8)
        vp = torch.round(vf / vs[..., None]).to(torch.int8)
    else:
        kp, vp, ks, vs = kf.to(dtype), vf.to(dtype), None, None
    bt = torch.randperm(P, generator=cuda, device="cuda")[:b * pp].reshape(b, pp).int()
    sl = torch.randint(1, page * pp + 1, (b,), generator=cuda, device="cuda").int()
    sl[0] = 0
    kw = dict(window=window, k_scale_pages=ks, v_scale_pages=vs)
    got = ops.paged_attention(q, kp, vp, bt, sl, backend="cuda", **kw)
    want = ref.paged_attention(q, kp, vp, bt, sl, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[1:].float(), want[1:].float(), **_tol(dtype))


def _scan_inputs(gen, bt, s, di, n, dtype, strided):
    """Seeded scan inputs; ``strided`` makes x, B and C column slices of
    wider tensors, as the model passes them (xs of xz, B and C of proj)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if strided:
        x = (rn(bt, s, 2 * di) * 0.5).to(dtype)[..., :di]
        proj = rn(bt, s, 3 * n).to(dtype)
        B, C = proj[..., n:2 * n], proj[..., 2 * n:]
    else:
        x = (rn(bt, s, di) * 0.5).to(dtype)
        B, C = rn(bt, s, n).to(dtype), rn(bt, s, n).to(dtype)
    dt = (torch.nn.functional.softplus(rn(bt, s, di)) * 0.1).to(dtype)
    A = -torch.exp(rn(di, n) * 0.3)
    D = 1 + 0.1 * rn(di)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,di,n", [(1, 100, 256, 16), (8, 1, 384, 16), (2, 64, 200, 8),
                                       (3, 129, 128, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_mamba_kernel_matches_plain(cuda, bt, s, di, n, dtype, with_h0, strided):
    x, dt, A, B, C, D = _scan_inputs(cuda, bt, s, di, n, dtype, strided)
    assert x.is_contiguous() != strided
    h0 = torch.randn((bt, di, n), generator=cuda, device="cuda") if with_h0 else None
    count = ms.launches.value
    y, h = ops.mamba1_scan(x, dt, A, B, C, D, h0, backend="cuda")
    torch.cuda.synchronize()
    assert ms.launches.value == count + 1
    want_y, want_h = ref.mamba1_scan(x, dt, A, B, C, D, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **_tol(dtype))
    torch.testing.assert_close(h, want_h, **_tol(None))


def test_mamba_kernel_continuation_equals_whole_scan(cuda):
    x, dt, A, B, C, D = _scan_inputs(cuda, 1, 200, 512, 16, torch.float32, False)
    y, h = ms.mamba1_scan(x, dt, A, B, C, D)
    y1, h1 = ms.mamba1_scan(x[:, :77], dt[:, :77], A, B[:, :77], C[:, :77], D)
    y2, h2 = ms.mamba1_scan(x[:, 77:], dt[:, 77:], A, B[:, 77:], C[:, 77:], D, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **_tol(None))
    torch.testing.assert_close(h2, h, **_tol(None))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q.half(), q.half(), q.half())
    kp = torch.zeros((4, 8, 2, 32), device="cuda", dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        pa.paged_attention(torch.zeros((1, 4, 32), device="cuda"), kp, kp,
                           torch.zeros((1, 2), dtype=torch.int32, device="cuda"),
                           torch.ones(1, dtype=torch.int32, device="cuda"))
    x, dt, A, B, C, D = _scan_inputs(cuda, 1, 4, 128, 16, torch.float32, False)
    with pytest.raises(ValueError, match="state size"):
        ms.mamba1_scan(x, dt, torch.zeros((128, 17), device="cuda"), B.new_zeros(1, 4, 17),
                       C.new_zeros(1, 4, 17), D)
    with pytest.raises(ValueError, match="dtypes"):
        ms.mamba1_scan(x, dt.bfloat16(), A, B, C, D)
    with pytest.raises(ValueError, match="f32"):
        ms.mamba1_scan(x, dt, A.bfloat16(), B, C, D)
