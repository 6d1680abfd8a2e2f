"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit (the kernels
are built from src/repro_torch/kernels/csrc at first use); without a card
they skip.  Run them on the card (which has no JAX, so without the
repository's conftest) with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-5 for f32, 2e-2 for
bf16 (for the scan, bf16 on y, which is stored in bf16; its state is
f32).  Rows with seq_len 0 come out of the paged kernel as zeros (it
reads no page for them, see kernels/paged_attention.py); the plain
version averages V there, so those rows are held to zeros instead.
"""
import pytest
import torch

from repro_torch.kernels import build
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
    (1, 70, 70, 4, 4, 80), (1, 129, 129, 10, 2, 64), (2, 1000, 77, 10, 2, 128),
    (1, 200, 77, 5, 1, 128), (1, 300, 300, 10, 2, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0), (False, 9),
                                           (True, 200), (False, 130)])
def test_flash_kernel_matches_plain(cuda, b, sq, sk, nq, nkv, hd, causal, window, dtype):
    """bf16 at hd 64/128 takes the tensor-core kernel, the rest the
    CUDA-core one: ragged Sq/Sk (77, 129, 1000 x 77), Sq > Sk under
    causal (rows at negative positions), windows across 128-key tiles,
    GQA with g = 5."""
    q = torch.randn((b, sq, nq, hd), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    v = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    n = fa.launches.value
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches.value == n + 1
    assert got.is_contiguous() and got.dtype == dtype
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def _views(kind, gen, b, s, h, hd, dtype):
    """q, k, v as non-contiguous (B, S, H, hd) views: columns of one qkv
    tensor (strides multiples of 16 bytes), rows padded by 4 elements (a
    head stride that is not), or starting one element in (base address
    not 16-byte aligned)."""
    if kind == "qkv":
        qkv = torch.randn((b, s, 3, h, hd), generator=gen, device="cuda").to(dtype)
        return qkv.unbind(2)
    if kind == "padded":
        return tuple(torch.randn((b, s, h, hd + 4), generator=gen, device="cuda")
                     .to(dtype)[..., :hd] for _ in range(3))
    flat = torch.randn(3 * b * s * h * hd + 1, generator=gen, device="cuda").to(dtype)
    return tuple(flat[1 + i * b * s * h * hd:1 + (i + 1) * b * s * h * hd].view(b, s, h, hd)
                 for i in range(3))


@pytest.mark.parametrize("kind,dtype,hd", [("qkv", torch.float32, 32),
                                           ("qkv", torch.bfloat16, 128),
                                           ("padded", torch.bfloat16, 128),
                                           ("padded", torch.bfloat16, 64),
                                           ("offset", torch.bfloat16, 64),
                                           ("padded", torch.float32, 80)])
def test_flash_kernel_reads_strided_inputs(cuda, kind, dtype, hd):
    q, k, v = _views(kind, cuda, 2, 140, 4, hd, dtype)
    if dtype == torch.bfloat16:
        assert fa.tma_ok(q) == (kind == "qkv")
    got = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, causal=True).float(),
                               **_tol(dtype))


def test_bf16_flash_failure_raises_without_fallback(cuda, monkeypatch):
    """A refused TMA descriptor is an error: no other kernel, no plain
    version, no launch counted."""
    class RefusingLib:
        def flash_attention_launch(self, *args):
            return -6
    monkeypatch.setattr(build, "load", lambda name: RefusingLib())
    q = torch.randn((1, 64, 4, 128), generator=cuda, device="cuda").bfloat16()
    n = fa.launches.value
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, q, q)
    assert fa.launches.value == n


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
    assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))
    torch.testing.assert_close(got[1:].float(), want[1:].float(), **_tol(dtype))


@pytest.mark.parametrize("dtype,quant", [(torch.float32, False), (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("page,pp,window", [(16, 24, 0), (16, 24, 40), (48, 8, 0),
                                           (16, 40, 100), (16, 24, 7)])
def test_paged_kernel_split_edges(cuda, dtype, quant, hd, page, pp, window):
    """seq_len 0, 1, exactly a partition, one past it, the full row, and
    rows whose window starts inside a partition or crosses its border;
    pages of 48 tokens make the second partition start mid-page.  Held
    against the plain version and the plain split version."""
    b, nq, nkv = 7, 10, 2
    partition = pa.PARTITION
    P = b * pp + 3
    full = page * pp
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
    sl = torch.tensor([0, 1, partition, partition + 1, full, full - 5, partition + 37],
                      device="cuda").clamp(max=full).int()
    kw = dict(window=window, k_scale_pages=ks, v_scale_pages=vs)
    plan = pa.plan(b, nq, nkv, hd, page, pp)
    assert plan.splits == -(-full // partition) > 1
    got = pa.paged_attention(q, kp, vp, bt, sl, **kw)
    want = ref.paged_attention(q, kp, vp, bt, sl, **kw)
    split = ref.paged_attention_split(q, kp, vp, bt, sl, partition=partition, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))
    torch.testing.assert_close(got[1:].float(), want[1:].float(), **_tol(dtype))
    torch.testing.assert_close(got.float(), split.float(), **_tol(dtype))


def test_paged_kernel_makes_no_host_sync(cuda):
    """The wrapper plans from shapes: no read of seq_lens on the host."""
    q = torch.randn((8, 40, 128), generator=cuda, device="cuda").bfloat16()
    kp = torch.randn((8 * 128, 16, 8, 128), generator=cuda, device="cuda").bfloat16()
    bt = torch.arange(8 * 128, device="cuda").reshape(8, 128).int()
    sl = torch.full((8,), 2048, device="cuda").int()
    pa.paged_attention(q, kp, kp, bt, sl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.paged_attention(q, kp, kp, bt, sl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pa.plan(8, 40, 8, 128, 16, 128).grid == (16, 8, 8)


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
