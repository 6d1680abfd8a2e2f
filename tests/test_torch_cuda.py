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
from repro_torch.kernels import mixed_gemm as mg
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
    """bf16 at hd 64/128 takes the wgmma kernel, the rest the mma.sync
    one: ragged Sq/Sk (77, 129, 1000 x 77), Sq > Sk under causal (rows at
    negative positions), windows across 128-key tiles, GQA with g = 5."""
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


MMA_CASES = [(torch.float32, 32), (torch.float32, 64), (torch.float32, 80),
             (torch.float32, 128), (torch.bfloat16, 32), (torch.bfloat16, 80)]


@pytest.mark.parametrize("dtype,hd", MMA_CASES)
@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal,window", [
    (1, 100, 60, 4, 2, True, 0),      # Sq > Sk: 40 causal rows at negative positions
    (2, 65, 97, 6, 3, True, 40),      # ragged tails of both, a window across key tiles
    (1, 130, 130, 10, 2, False, 33),  # GQA g = 5, a window without causality
    (3, 1, 33, 4, 4, True, 0),        # one query row
    (1, 512, 512, 4, 4, True, 0)])    # Zamba2's prefill shape, fewer heads
def test_flash_mma_route_matches_plain(cuda, dtype, hd, b, sq, sk, nq, nkv, causal, window):
    """The mma.sync route at every (type, head_dim) it serves; f32 also
    against the plain version of its split-TF32 arithmetic."""
    assert fa.route(dtype, hd) == "mma"
    q = torch.randn((b, sq, nq, hd), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    v = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.dtype == dtype
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == torch.float32:
        tf32x3 = ref.flash_attention_tf32x3(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, tf32x3, **_tol(dtype))


@pytest.mark.parametrize("kind", ["qkv", "padded", "offset"])
@pytest.mark.parametrize("dtype,hd", MMA_CASES)
def test_flash_mma_route_reads_misaligned_views(cuda, kind, dtype, hd):
    """Columns of a qkv tensor, rows padded by 4 elements and a base one
    element in: the K/V tiles are copied in 16-byte pieces only where
    every row starts on a 16-byte boundary, element by element otherwise."""
    q, k, v = _views(kind, cuda, 2, 140, 4, hd, dtype)
    got = fa.flash_attention(q, k, v, causal=True, window=50)
    want = ref.flash_attention(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_mma_failure_raises_without_fallback(cuda, monkeypatch):
    """A failed launch of the mma route is an error: no other kernel, no
    plain version, no launch counted."""
    class FailingLib:
        def flash_attention_launch(self, *args):
            return 9            # cudaErrorInvalidConfiguration

        def repro_cuda_error_string(self, code):
            return b"invalid configuration argument"

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(build, "load", lambda name: FailingLib())
    monkeypatch.setitem(build._libs, "flash_attention", FailingLib())
    monkeypatch.setattr(ref, "flash_attention", no_plain)
    q = torch.randn((1, 64, 4, 80), generator=cuda, device="cuda")
    n = fa.launches.value
    with pytest.raises(RuntimeError, match="kernel launch failed"):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 63, 64, 65, 128, 129, 1000])
def test_mamba_kernel_chunk_edges(cuda, dtype, s):
    """One step (the one-step kernel), two (the single pass), one chunk
    less a step, one chunk, one step more, two chunks, two and a step,
    Falcon's 1000-step prefill; 200 channels (not a multiple of a CTA's
    32) and h0.  Held against the plain scan and the plain version of the
    chunked order."""
    bt, di, n = 2, 200, 16
    x, dt, A, B, C, D = _scan_inputs(cuda, bt, s, di, n, dtype, True)
    h0 = torch.randn((bt, di, n), generator=cuda, device="cuda")
    plan = ms.plan(bt, s, di, n)
    assert (plan.kernel_launches == 1) == (s <= ms.CHUNK)
    y, h = ms.mamba1_scan(x, dt, A, B, C, D, h0)
    torch.cuda.synchronize()
    want_y, want_h = ref.mamba1_scan(x, dt, A, B, C, D, h0)
    torch.testing.assert_close(y.float(), want_y.float(), **_tol(dtype))
    torch.testing.assert_close(h, want_h, **_tol(None))
    cy, ch = ref.mamba1_scan_chunked(x, dt, A, B, C, D, h0, chunk=plan.chunk)
    torch.testing.assert_close(y.float(), cy.float(), **_tol(dtype))
    torch.testing.assert_close(h, ch, **_tol(None))


@pytest.mark.parametrize("bt", [1, 5, 9])
@pytest.mark.parametrize("n", [5, 16])
def test_mamba_step_kernel_batch_rows(cuda, bt, n):
    """The one-step kernel takes four batch rows per CTA: a batch that
    leaves a CTA's last rows empty, with and without whole lanes of
    states."""
    x, dt, A, B, C, D = _scan_inputs(cuda, bt, 1, 96, n, torch.bfloat16, True)
    h0 = torch.randn((bt, 96, n), generator=cuda, device="cuda")
    y, h = ms.mamba1_scan(x, dt, A, B, C, D, h0)
    want_y, want_h = ref.mamba1_scan(x, dt, A, B, C, D, h0)
    torch.testing.assert_close(y.float(), want_y.float(), **_tol(torch.bfloat16))
    torch.testing.assert_close(h, want_h, **_tol(None))


@pytest.mark.parametrize("split", [64, 77, 128])
def test_mamba_kernel_continuation_across_chunks(cuda, split):
    """Two calls with the carried state against one whole scan, split on
    a chunk boundary (64, 128) and inside a chunk (77), with n 5."""
    x, dt, A, B, C, D = _scan_inputs(cuda, 1, 200, 256, 5, torch.float32, True)
    y, h = ms.mamba1_scan(x, dt, A, B, C, D)
    y1, h1 = ms.mamba1_scan(x[:, :split], dt[:, :split], A, B[:, :split], C[:, :split], D)
    y2, h2 = ms.mamba1_scan(x[:, split:], dt[:, split:], A, B[:, split:], C[:, split:], D, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **_tol(None))
    torch.testing.assert_close(h2, h, **_tol(None))


@pytest.mark.parametrize("s", [1, 1000])
def test_mamba_kernel_makes_no_host_sync(cuda, s):
    """The wrapper plans chunks, grid and scratch from shapes alone."""
    x, dt, A, B, C, D = _scan_inputs(cuda, 2, s, 512, 16, torch.bfloat16, True)
    h0 = torch.randn((2, 512, 16), generator=cuda, device="cuda")
    ms.mamba1_scan(x, dt, A, B, C, D, h0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms.mamba1_scan(x, dt, A, B, C, D, h0)
    finally:
        torch.cuda.set_sync_debug_mode("default")


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


def test_cnn_vocoder_conv_stays_f32_with_cudnn_tf32_on(cuda, monkeypatch):
    """The Qwen3-Omni CNN vocoder's 3-tap convolution keeps f32 precision
    on the card with cuDNN's TF32 switch on: at this width one TF32
    product per term would miss the f32 tolerance by far."""
    from repro_torch.configs import pipelines as P
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.randn((4, 16, 128), generator=cuda, device="cuda")
    w = 0.05 * torch.randn((3, 128, 128), generator=cuda, device="cuda")
    got = P._conv1d_same(x, w)
    want = torch.nn.functional.conv1d(x.double().cpu().transpose(1, 2),
                                      w.double().cpu().permute(2, 1, 0), padding=1)
    torch.testing.assert_close(got.cpu(), want.transpose(1, 2).float(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 512])
def test_paged_kernel_at_the_moe_decode_shape(cuda, window):
    """Qwen3-30B-A3B's decode: B 8, 32 query heads over 4 KV heads (GQA
    8:1, two blocks of 4 query heads per KV head), hd 128, bf16, pages
    of 16 and a 2048-token table; an inactive row and a full one."""
    b, nq, nkv, hd, page, pp = 8, 32, 4, 128, 16, 128
    P = b * pp + 8
    q = torch.randn((b, nq, hd), generator=cuda, device="cuda").bfloat16()
    kp = torch.randn((P, page, nkv, hd), generator=cuda, device="cuda").bfloat16()
    vp = torch.randn((P, page, nkv, hd), generator=cuda, device="cuda").bfloat16()
    bt = torch.randperm(P, generator=cuda, device="cuda")[:b * pp].reshape(b, pp).int()
    sl = torch.randint(1, page * pp + 1, (b,), generator=cuda, device="cuda").int()
    sl[0], sl[-1] = 0, page * pp
    plan = pa.plan(b, nq, nkv, hd, page, pp)
    assert plan.grid == (nkv * 2, b, 8)
    got = pa.paged_attention(q, kp, vp, bt, sl, window=window)
    want = ref.paged_attention(q, kp, vp, bt, sl, window=window)
    split = ref.paged_attention_split(q, kp, vp, bt, sl, partition=pa.PARTITION, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))
    torch.testing.assert_close(got[1:].float(), want[1:].float(), **_tol(torch.bfloat16))
    torch.testing.assert_close(got.float(), split.float(), **_tol(torch.bfloat16))


@pytest.mark.parametrize("s", [6, 13, 23, 24])
def test_flash_kernel_at_the_monolithic_prefill_shape(cuda, s):
    """The monolithic baseline's prefill and recompute at the qwen_omni
    size: one request, causal, f32, 4 query / 2 KV heads of 32 (the mma
    route, one ragged 64-row tile)."""
    q = torch.randn((1, s, 4, 32), generator=cuda, device="cuda")
    k = torch.randn((1, s, 2, 32), generator=cuda, device="cuda")
    v = torch.randn((1, s, 2, 32), generator=cuda, device="cuda")
    assert fa.route(torch.float32, 32) == "mma"
    n = fa.launches.value
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches.value == n + 1
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal=True),
                               **_tol(torch.float32))


def test_bf16_kv_hop_round_trip_is_bit_exact_on_the_card(cuda):
    """extract_kv ships a bf16 pool's bits (int16, tagged) and inject_kv
    writes the same bits into other pages, on the engine's own stream."""
    from repro_torch.configs.pipelines import tiny_lm
    from repro_torch.device import engine_stream, on_stream
    from repro_torch.engine.kv_cache import PagedKVConfig
    from repro_torch.engine.runner import PagedRunner
    from repro_torch.models import transformer as T
    cfg = tiny_lm("t", vocab=256).replace(dtype="bfloat16")
    runner = PagedRunner(cfg, T.init_params(cfg, cuda), PagedKVConfig(
        num_pages=40, page_size=16, max_pages_per_seq=8))
    runner.k_pages.copy_(torch.randn(runner.k_pages.shape, generator=cuda, device="cuda"))
    runner.v_pages.copy_(torch.randn(runner.v_pages.shape, generator=cuda, device="cuda"))
    src = [3, 17, 9, 0, 0, 0, 0, 0]
    dst = [20, 21, 22, 0, 0, 0, 0, 0]
    stream = engine_stream(runner.device)
    with on_stream(stream):
        k, v, tag = runner.extract_kv(src, 37)
        runner.inject_kv(k, v, dst, 37, tag)
    stream.synchronize()
    assert tag == "bfloat16" and k.dtype.name == "int16"
    for pool in (runner.k_pages, runner.v_pages):
        assert torch.equal(pool[:, dst[:3]].view(torch.int16), pool[:, src[:3]].view(torch.int16))


# ---------------------------------------------------------------------------
# the decode step as one CUDA graph (engine/runner.py: PagedRunner.decode)
# ---------------------------------------------------------------------------

GRAPH_B, GRAPH_PAGE, GRAPH_PP = 16, 16, 4


def _graph_cfg(which):
    from repro_torch.configs.pipelines import tiny_lm
    from repro_torch.configs.qwen3_moe_30b_a3b import SMOKE_CONFIG
    return {"tiny_lm": tiny_lm("t", vocab=256), "qwen3_moe_smoke": SMOKE_CONFIG}[which]


def _decode_pair(cfg, gen):
    """Two runners over one set of weights and equal random pools: one
    decodes through its graph, the other runs the eager body."""
    from repro_torch.engine.kv_cache import PagedKVConfig
    from repro_torch.engine.runner import PagedRunner
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, gen)
    if cfg.is_moe:
        # a zero router ties every gate: every row picks the same experts,
        # and the first layer drops pairs at every step
        params["blocks"]["moe"]["router"][0].zero_()
    kv = PagedKVConfig(num_pages=GRAPH_B * GRAPH_PP + 8, page_size=GRAPH_PAGE,
                       max_pages_per_seq=GRAPH_PP)
    graph, eager = PagedRunner(cfg, params, kv), PagedRunner(cfg, params, kv)
    for name in ("k_pages", "v_pages"):
        pool = getattr(graph, name)
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda").to(pool.dtype))
        getattr(eager, name).copy_(pool)
    return graph, eager


def _decode_steps(cfg, gen, n=8, seed=0):
    """n steps of (embeds, tables, positions, active): rows join and leave
    between steps, slot 0 inactive in two steps of three, and inactive
    slots carry stale tables (other slots' pages) and positions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b, pp = GRAPH_B, GRAPH_PP
    own = np.arange(b)[:, None] * pp + 1 + np.arange(pp)[None]
    pos = rng.integers(0, GRAPH_PAGE, size=b)
    steps = []
    for step in range(n):
        active = rng.random(b) < 0.6
        active[0] = step % 3 == 2
        active[b - 1] |= not active.any()
        tables = np.where(active[:, None], own, rng.integers(0, b * pp, size=(b, pp)))
        positions = np.where(active, pos, rng.integers(0, pp * GRAPH_PAGE, size=b))
        embeds = torch.randn((b, 1, cfg.d_model), generator=gen, device="cuda")
        steps.append((embeds.to(getattr(torch, cfg.dtype)), tables.astype(np.int32),
                      positions.astype(np.int32), active))
        pos = pos + active
    return steps


def _eager_step(runner, embeds, tables, positions, active):
    """The eager body's (logits, hidden, routed experts or None)."""
    dev = runner.device
    logits, hidden, routed, _ = runner._decode_body(
        embeds, torch.as_tensor(tables, device=dev), torch.as_tensor(positions, device=dev),
        torch.as_tensor(active, device=dev))
    return logits, hidden, routed


def _same_step(graph, eager, step):
    """One step through the graph, inside an engine step's ``model.decode``
    phase, and through the eager body: bit-equal logits, hidden states
    and pools, the same routed experts kept on the span, and the same
    pairs dropped."""
    from repro_torch.core import metrics
    from repro_torch.models import moe
    counter = moe.drop_counter
    n0 = int(counter) if counter is not None else 0
    trace = metrics.StepTrace("graph", metrics.StepTotals(), first="model.decode")
    trace.worked = True
    got = [t.clone() for t in graph.decode(*step)]
    trace.finish()
    got.append(metrics.spans[-1].kept.get("routed_experts"))
    n1 = int(counter) if counter is not None else 0
    want = _eager_step(eager, *step)
    torch.cuda.synchronize()
    assert (got[2] is None) == (want[2] is None) == (not graph.cfg.is_moe)
    for g, w in zip(got, want):
        assert g is None or torch.equal(g, w)
    assert torch.equal(graph.k_pages, eager.k_pages)
    assert torch.equal(graph.v_pages, eager.v_pages)
    return n1 - n0, (int(counter) if counter is not None else 0) - n1


@pytest.mark.parametrize("which", ["tiny_lm", "qwen3_moe_smoke"])
def test_decode_graph_replays_the_eager_step_bit_for_bit(cuda, which, monkeypatch):
    """Eight steps: the first runs eagerly and captures, the other seven
    replay; each adds num_layers wrapper calls to ``launches`` (the
    capture holds num_layers), and the drop counter counts in the
    replays as in the eager body."""
    from repro_torch.models import moe
    cfg = _graph_cfg(which)
    graph, eager = _decode_pair(cfg, cuda)
    monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long, device="cuda"))
    captured = None
    for i, step in enumerate(_decode_steps(cfg, cuda)):
        n = pa.launches.value
        dropped, want = _same_step(graph, eager, step)
        assert pa.launches.value == n + 2 * cfg.num_layers     # this step's, then the eager's
        assert dropped == want and (dropped > 0) == cfg.is_moe
        if i == 0:
            captured = graph._graph
        assert graph._graph is captured
    assert captured.launches == cfg.num_layers and eager._graph is None


def test_decode_graph_captures_again_for_new_pools_or_counter(cuda, monkeypatch):
    from repro_torch.models import moe
    cfg = _graph_cfg("qwen3_moe_smoke")
    graph, eager = _decode_pair(cfg, cuda)
    steps = _decode_steps(cfg, cuda, seed=1)
    monkeypatch.setattr(moe, "drop_counter", None)
    _same_step(graph, eager, steps[0])
    first = graph._graph
    _same_step(graph, eager, steps[1])
    assert graph._graph is first
    monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long, device="cuda"))
    assert _same_step(graph, eager, steps[2])[0] > 0
    second = graph._graph
    assert second is not first
    dropped, want = _same_step(graph, eager, steps[3])
    assert graph._graph is second and dropped == want > 0
    old = graph.k_pages, graph.v_pages
    kept = [p.clone() for p in old]
    for r in (graph, eager):
        r.k_pages, r.v_pages = r.k_pages.clone(), r.v_pages.clone()
    _same_step(graph, eager, steps[4])
    third = graph._graph
    assert third is not second
    _same_step(graph, eager, steps[5])
    assert graph._graph is third
    for p, k in zip(old, kept):                # the replaced pools are written no more
        assert torch.equal(p, k)


def test_two_runners_capture_and_replay_from_two_threads(cuda):
    """The PD layout: two engine threads on one card, each on its own
    stream, capturing and replaying at once."""
    import threading

    from repro_torch.device import engine_stream, on_stream
    cfg = _graph_cfg("tiny_lm").replace(dtype="bfloat16")
    pairs = [_decode_pair(cfg, cuda) for _ in range(2)]
    steps = [_decode_steps(cfg, cuda, seed=s) for s in (2, 3)]
    results, errors = [[], []], []

    def serve(i):
        try:
            runner = pairs[i][0]
            stream = engine_stream(runner.device)
            with on_stream(stream):
                for step in steps[i]:
                    results[i].append([t.clone() for t in runner.decode(*step)])
            stream.synchronize()
        except Exception as exc:      # noqa: BLE001 - raised below, on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for (graph, eager), got, run in zip(pairs, results, steps):
        assert len(got) == len(run) and graph._graph is not None
        for g, step in zip(got, run):
            for a, b in zip(g, _eager_step(eager, *step)[:2]):
                assert torch.equal(a, b)
        torch.cuda.synchronize()
        assert torch.equal(graph.k_pages, eager.k_pages)
        assert torch.equal(graph.v_pages, eager.v_pages)


# ---------------------------------------------------------------------------
# the flash backward (training)
# ---------------------------------------------------------------------------

def _bwd_inputs(gen, b, s, nq, nkv, hd, dtype):
    q = torch.randn((b, s, nq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, nkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, nkv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, nq, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _assert_bwd_close(got, want, dtype):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.is_contiguous(), name
        torch.testing.assert_close(g.float(), w.float(), **_tol(dtype), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("b,s,nq,nkv,causal,window", [
    (2, 128, 8, 2, True, 0),       # causal, GQA 4, whole tiles
    (1, 77, 4, 4, False, 0),       # non-causal (the encoder), ragged S
    (1, 200, 10, 2, True, 64),     # a window across tiles, GQA 5
    (1, 130, 4, 1, False, 33),     # a window without causality, GQA 4
    (2, 1, 4, 2, True, 0)])        # one row
def test_flash_bwd_kernel_matches_plain(cuda, dtype, hd, b, s, nq, nkv, causal, window):
    """bf16 at head_dim 64 and 128 on the wgmma kernel, bf16 at 32 and 80
    and f32 on the mma.sync kernel (lse recomputed by the forward: none is
    given), against the plain FlashAttention-2 equations on the same
    inputs and output."""
    q, k, v, do = _bwd_inputs(cuda, b, s, nq, nkv, hd, dtype)
    o = ref.flash_attention(q, k, v, causal=causal, window=window)
    n = fa.bwd_launches.value
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.bwd_launches.value == n + 1
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("kind", ["qkv", "padded", "offset"])
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 32), (torch.bfloat16, 128),
                                      (torch.bfloat16, 80)])
def test_flash_bwd_kernel_reads_strided_inputs(cuda, kind, dtype, hd):
    """q, k, v and dO as views (strided, rows padded, base one element in):
    tiles are copied in 16-byte pieces only where every row allows it."""
    q, k, v = _views(kind, cuda, 2, 140, 4, hd, dtype)
    do = _views(kind, cuda, 2, 140, 4, hd, dtype)[1]
    o = ref.flash_attention(q, k, v, causal=True, window=50)
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=True, window=50)
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=True, window=50)
    _assert_bwd_close(got, want, dtype)


WGMMA_BWD_CASES = [
    (2, 128, 8, 2, True, 0),       # causal, GQA 4, whole tiles
    (1, 77, 4, 4, False, 0),       # non-causal, ragged S
    (1, 200, 10, 2, True, 64),     # a window across tiles, GQA 5
    (1, 130, 4, 1, False, 33),     # a window without causality
    (2, 1, 4, 2, True, 0),         # one row
    (1, 1000, 16, 8, True, 0),     # InternLM2's heads, S a multiple of neither tile
]


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("b,s,nq,nkv,causal,window", WGMMA_BWD_CASES)
def test_flash_bwd_wgmma_takes_the_forward_lse(cuda, hd, b, s, nq, nkv, causal, window):
    """The wgmma backward with the lse its forward wrote, as training runs
    it: within the bf16 tolerance of the plain FA2 equations, and of the
    same kernel recomputing lse."""
    assert fa.bwd_route(torch.bfloat16, hd) == "wgmma"
    q, k, v, do = _bwd_inputs(cuda, b, s, nq, nkv, hd, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    n = fa.bwd_launches.value
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
    torch.cuda.synchronize()
    assert fa.bwd_launches.value == n + 1
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    _assert_bwd_close(got, want, torch.bfloat16)
    recomputed = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    _assert_bwd_close(got, recomputed, torch.bfloat16)


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal,window", [
    (2, 128, 128, 8, 2, True, 0), (1, 77, 77, 4, 4, False, 0), (1, 200, 200, 10, 2, True, 64),
    (1, 70, 200, 8, 1, False, 0), (4, 2048, 2048, 16, 8, True, 0)])
def test_flash_forward_lse_matches_plain_and_leaves_out_unchanged(cuda, hd, b, sq, sk, nq, nkv,
                                                                 causal, window):
    """The wgmma forward's lse (log2 units) against the plain version's,
    and its output bit for bit the same with and without lse."""
    q = torch.randn((b, sq, nq, hd), generator=cuda, device="cuda").bfloat16()
    k = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").bfloat16()
    v = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").bfloat16()
    n = fa.launches.value
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    plain_out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches.value == n + 2
    assert lse.dtype == torch.float32 and lse.shape == (b, nq, sq) and lse.is_contiguous()
    assert torch.equal(out, plain_out)
    _, want = ref.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


MMA_BWD_TYPES = [(torch.bfloat16, 32), (torch.bfloat16, 80), (torch.float32, 32),
                 (torch.float32, 64), (torch.float32, 80), (torch.float32, 128)]


@pytest.mark.parametrize("dtype,hd", MMA_BWD_TYPES)
@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal,window", [
    (2, 128, 128, 8, 4, True, 0), (1, 77, 77, 4, 4, False, 0), (1, 200, 200, 10, 2, True, 64),
    (1, 70, 200, 8, 1, False, 0)])
def test_flash_forward_mma_route_lse_matches_plain_and_leaves_out_unchanged(
        cuda, dtype, hd, b, sq, sk, nq, nkv, causal, window):
    """The mma forward's lse (log2 units) against the plain version's (f32:
    the split-TF32 arithmetic's), and its output bit for bit the same with
    and without lse."""
    assert fa.route(dtype, hd) == "mma"
    q = torch.randn((b, sq, nq, hd), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    v = torch.randn((b, sk, nkv, hd), generator=cuda, device="cuda").to(dtype)
    n = fa.launches.value
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    plain_out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches.value == n + 2
    assert lse.dtype == torch.float32 and lse.shape == (b, nq, sq) and lse.is_contiguous()
    assert torch.equal(out, plain_out)
    if dtype == torch.float32:
        _, want = ref.flash_attention_tf32x3(q, k, v, causal=causal, window=window,
                                             return_lse=True)
        torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)
    _, want = ref.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


MMA_BWD_CASES = [
    (2, 128, 8, 4, True, 0),       # the smoke configs: causal GQA 2:1, a grid split 4 or 8 ways
    (1, 77, 4, 2, False, 0),       # non-causal, ragged S, split
    (1, 200, 10, 2, True, 64),     # a window across tiles, GQA 5
    (1, 300, 4, 1, False, 33),     # a window without causality, GQA 4, three key tiles
    (2, 1, 4, 2, True, 0),         # one row
    (2, 600, 16, 16, False, 0),    # HuBERT's heads: 160 CTAs, no split
]


@pytest.mark.parametrize("dtype,hd", MMA_BWD_TYPES)
@pytest.mark.parametrize("b,s,nq,nkv,causal,window", MMA_BWD_CASES)
def test_flash_bwd_mma_takes_the_forward_lse(cuda, dtype, hd, b, s, nq, nkv, causal, window):
    """The mma backward with the lse its forward wrote, as training runs
    it: within the tolerance of the plain FA2 equations (f32: also of
    the split-TF32 walk it computes), and of itself given no lse."""
    assert fa.bwd_route(dtype, hd) == "mma"
    plan = fa.bwd_plan(dtype, b, s, nq, nkv, hd,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    q, k, v, do = _bwd_inputs(cuda, b, s, nq, nkv, hd, dtype)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    n = fa.bwd_launches.value
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
    torch.cuda.synchronize()
    assert fa.bwd_launches.value == n + 1
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    _assert_bwd_close(got, want, dtype)
    if dtype == torch.float32:
        tiled = ref.flash_attention_bwd_tiled(q, k, v, o, do, lse, block_q=plan.block_q,
                                              block_k=plan.block_k, causal=causal,
                                              window=window, tf32x3=True)
        _assert_bwd_close(got, tiled, dtype)
    recomputed = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    _assert_bwd_close(got, recomputed, dtype)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 80), (torch.float32, 32)])
@pytest.mark.parametrize("b,s,nq,nkv", [(2, 1024, 16, 16), (2, 128, 8, 4)])
def test_flash_bwd_mma_two_calls_agree(cuda, dtype, hd, b, s, nq, nkv):
    """dQ (and, where the grid is split, dK and dV) is summed with f32
    atomics in no fixed order: two calls agree to the tolerance; unsplit,
    dK and dV bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, b, s, nq, nkv, hd, dtype)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    a = fa.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    c = fa.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    _assert_bwd_close(a, c, dtype)
    plan = fa.bwd_plan(dtype, b, s, nq, nkv, hd,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    if plan.splits == 1:
        assert torch.equal(a[1], c[1]) and torch.equal(a[2], c[2])


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
def test_flash_bwd_wgmma_two_calls_agree(cuda, hd):
    """dQ is summed with f32 atomics in no fixed order: two calls agree to
    the bf16 tolerance (dK and dV, summed in registers, bit for bit)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 512, 8, 2, hd, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    a = fa.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    b = fa.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    _assert_bwd_close(a, b, torch.bfloat16)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_flash_bwd_refuses_a_wrong_lse(cuda):
    q, k, v, do = _bwd_inputs(cuda, 1, 64, 4, 2, 128, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, do, lse=lse[:, :2])
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, do, lse=lse.double())


def test_flash_bwd_takes_equal_lengths_only(cuda):
    q, k, v, do = _bwd_inputs(cuda, 1, 32, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention_bwd(q, k[:, :16], v[:, :16], q, do)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros((1, 4, 2, 48), device="cuda")
        fa.flash_attention_bwd(z, z, z, z, z)


def test_flash_bwd_failure_raises_without_fallback(cuda, monkeypatch):
    """A failed launch of the backward is an error: no plain version, no
    launch counted."""
    class FailingLib:
        def flash_attention_bwd_launch(self, *args):
            return 9            # cudaErrorInvalidConfiguration

        def repro_cuda_error_string(self, code):
            return b"invalid configuration argument"

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version was called")

    q, k, v, do = _bwd_inputs(cuda, 1, 64, 4, 2, 64, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    monkeypatch.setattr(build, "load", lambda name: FailingLib())
    monkeypatch.setitem(build._libs, "flash_attention_bwd", FailingLib())
    monkeypatch.setattr(ref, "flash_attention_bwd", no_plain)
    n = fa.bwd_launches.value
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fa.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert fa.bwd_launches.value == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_under_grad_runs_both_kernels(cuda, dtype, monkeypatch):
    """``ops.flash_attention`` under autograd on the card: the forward and
    the backward kernel once each, no plain version, grads as autograd of
    the plain version gives."""
    q, k, v, do = _bwd_inputs(cuda, 2, 96, 8, 2, 64, dtype)
    want = torch.autograd.grad(ref.flash_attention(*(t.requires_grad_(True) for t in (q, k, v)),
                                                   causal=True, window=40), (q, k, v), do)
    monkeypatch.setattr(ref, "flash_attention", lambda *a, **kw: pytest.fail("plain fwd"))
    monkeypatch.setattr(ref, "flash_attention_bwd", lambda *a, **kw: pytest.fail("plain bwd"))
    nf, nb = fa.launches.value, fa.bwd_launches.value
    out = ops.flash_attention(q, k, v, causal=True, window=40)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.launches.value - nf, fa.bwd_launches.value - nb) == (1, 1)
    _assert_bwd_close(got, want, dtype)


def test_serving_forward_is_unchanged_without_grad(cuda, monkeypatch):
    monkeypatch.setattr(ops.FlashAttention, "apply", lambda *a: pytest.fail("autograd path"))
    q, k, v, _ = _bwd_inputs(cuda, 1, 64, 4, 2, 128, torch.bfloat16)
    nf, nb = fa.launches.value, fa.bwd_launches.value
    ops.flash_attention(q, k, v)                       # no input requires grad
    with torch.no_grad():
        ops.flash_attention(*(t.requires_grad_(True) for t in (q, k, v)))
    assert (fa.launches.value - nf, fa.bwd_launches.value - nb) == (2, 0)


def test_mamba_scan_under_grad_raises_on_the_card(cuda):
    x, dt, A, B, C, D = _scan_inputs(cuda, 1, 8, 128, 16, torch.float32, False)
    n = ms.launches.value
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.mamba1_scan(x.requires_grad_(True), dt, A, B, C, D)
    with torch.no_grad():
        ops.mamba1_scan(x, dt, A, B, C, D)
    assert ms.launches.value == n + 1


@pytest.mark.parametrize("remat", [True, "dots", False])
def test_tiny_train_step_cuda_matches_ref(cuda, remat):
    """One loss and gradient of a 2-layer f32 model with backend "cuda"
    against "ref" on the same weights and batch; each layer launches the
    backward once, and the forward once more when it is recomputed (remat
    True; "dots" recomputes attention too).  Held to 1e-4: the f32
    forward runs split TF32 products and both passes sum in other orders
    than the plain versions, across two layers and the loss."""
    from repro_torch.configs.pipelines import tiny_lm
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.data import TokenStream
    cfg = tiny_lm("t", vocab=64)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    b = next(TokenStream(cfg, 2, 48, seed=1))
    x, y = (torch.from_numpy(b[k]).cuda() for k in ("inputs", "labels"))
    out = {}
    for backend in ("ref", "cuda"):
        ops.set_backend(backend)
        try:
            nf, nb = fa.launches.value, fa.bwd_launches.value
            out[backend] = st.loss_and_grads(cfg, params, x, y, remat=remat)
            torch.cuda.synchronize()
            launched = (fa.launches.value - nf, fa.bwd_launches.value - nb)
        finally:
            ops.set_backend("auto")
        fwd = (2 if remat else 1) * cfg.num_layers
        assert launched == ((0, 0) if backend == "ref" else (fwd, cfg.num_layers))
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out["cuda"][0], out["ref"][0], **tol)
    for g, w in zip(opt.leaves(out["cuda"][2]), opt.leaves(out["ref"][2])):
        torch.testing.assert_close(g, w, **tol)


# ---------------------------------------------------------------------------
# the decode graph of interleaved attention, Mamba1 and MoE layers (Jamba)
# ---------------------------------------------------------------------------

def _hybrid_pair(cfg, gen):
    """Two Jamba runners over one set of weights and equal random pools and
    Mamba states: one decodes through its graph, the other runs the eager
    body."""
    from repro_torch.engine.kv_cache import PagedKVConfig
    from repro_torch.engine.runner import PagedRunner
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, gen)
    kv = PagedKVConfig(num_pages=GRAPH_B * GRAPH_PP + 8, page_size=GRAPH_PAGE,
                       max_pages_per_seq=GRAPH_PP)
    graph, eager = (PagedRunner(cfg, params, kv, max_batch=GRAPH_B) for _ in range(2))
    for name in ("k_pages", "v_pages", "ssm_h", "ssm_conv"):
        t = getattr(graph, name)
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
        getattr(eager, name).copy_(t)
    return graph, eager


def test_hybrid_decode_graph_replays_the_eager_step_bit_for_bit(cuda, monkeypatch):
    """Jamba's smoke period (7 Mamba layers, 1 attention, 4 MoE): eight
    steps, the first eager and captured, seven replayed, each bit for bit
    the eager body's (logits, hidden states, pools, Mamba states, the held
    experts kept); an inactive row's state, a slot whose prompt is still
    being prefilled, stays as it was."""
    from repro_torch.configs.jamba2_mini import SMOKE_CONFIG
    from repro_torch.models import moe
    cfg = SMOKE_CONFIG
    graph, eager = _hybrid_pair(cfg, cuda)
    monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long, device="cuda"))
    scans = cfg.layer_layout.count("M")
    for i, step in enumerate(_decode_steps(cfg, cuda, seed=3)):
        before = graph.ssm_h.clone(), graph.ssm_conv.clone()
        n, n_scan = pa.launches.value, ms.launches.value
        _same_step(graph, eager, step)
        assert pa.launches.value == n + 2 and ms.launches.value == n_scan + 2 * scans
        idle = torch.as_tensor(~step[3], device="cuda")
        for now, want, was in ((graph.ssm_h, eager.ssm_h, before[0]),
                               (graph.ssm_conv, eager.ssm_conv, before[1])):
            assert torch.equal(now, want)
            assert torch.equal(now[:, idle], was[:, idle])
    assert graph._graph.scan_launches == scans and graph._graph.launches == 1


def test_hybrid_capture_holds_each_layers_kernel_at_the_published_depth(cuda):
    """32 layers in Jamba's layout: the capture holds 28 scan and 4
    paged-attention calls, and each replay counts them."""
    from repro_torch.configs.jamba2_mini import SMOKE_CONFIG
    cfg = SMOKE_CONFIG.replace(num_layers=32)
    graph, _ = _hybrid_pair(cfg, cuda)
    steps = _decode_steps(cfg, cuda, seed=4, n=2)
    graph.decode(*steps[0])
    assert (graph._graph.scan_launches, graph._graph.launches) == (28, 4)
    n, n_scan = pa.launches.value, ms.launches.value
    graph.decode(*steps[1])
    torch.cuda.synchronize()
    assert (pa.launches.value - n, ms.launches.value - n_scan) == (4, 28)


# ---------------------------------------------------------------------------
# f32 activations x bf16 weights (kernels/mixed_gemm.py): the prefill's
# products, the weights read in place
# ---------------------------------------------------------------------------

# The kernel sums exact products of the activations' three bf16 parts in
# f32, in another order than cuBLAS's f32 SGEMM (the plain version, TF32
# off): the tensor cores sum each stage of 32 K-rows, the stages are added
# in f32 rounded to nearest.  With weights drawn as the models draw them
# (over sqrt(K)) |y| is about 1, and both sides round about sqrt(K / 32)
# times at 6e-8 of the running sum: the largest error is held to 1e-5 of
# the largest |y|.
MIXED_TOL = 1e-5

# (K, N) of every prefill product of the two configurations, and edges
MIXED_SHAPES = {
    "jamba in_proj": (4096, 16384), "jamba x_proj": (8192, 288), "jamba dt_proj": (256, 8192),
    "jamba out_proj": (8192, 4096), "jamba q/o": (4096, 4096), "jamba k/v": (4096, 1024),
    "jamba mlp up": (4096, 14336), "jamba mlp down": (14336, 4096), "jamba head": (4096, 65536),
    "qwen q": (2048, 4096), "qwen k/v": (2048, 512), "qwen o": (4096, 2048),
    "qwen head": (2048, 151936), "K and N ragged": (100, 40), "N one tile and 8": (512, 264)}


def _mixed_inputs(gen, m, k, n):
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5).to(torch.bfloat16)
    return x, w


def _assert_mixed_close(got, want, tol=MIXED_TOL):
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("name", sorted(MIXED_SHAPES))
@pytest.mark.parametrize("m", [1, 19, 64])
def test_mixed_gemm_matches_the_promoted_product(cuda, name, m):
    assert not torch.backends.cuda.matmul.allow_tf32
    k, n = MIXED_SHAPES[name]
    x, w = _mixed_inputs(cuda, m, k, n)
    launched = mg.launches.value
    got = mg.matmul(x, w)
    torch.cuda.synchronize()
    assert mg.launches.value == launched + 1
    _assert_mixed_close(got, ref.mixed_matmul(x, w))


@pytest.mark.parametrize("m,k,n", [(65, 2048, 4096), (200, 8192, 288), (1000, 2560, 2048)])
def test_mixed_gemm_takes_rows_past_one_block(cuda, m, k, n):
    """A whole prompt (the monolithic baseline's, a state runner's)."""
    x, w = _mixed_inputs(cuda, m, k, n)
    _assert_mixed_close(mg.matmul(x, w), ref.mixed_matmul(x, w))


@pytest.mark.parametrize("kind", ["column slice", "offset", "3-d"])
def test_mixed_gemm_reads_strided_activations(cuda, kind):
    """A column slice with a 16-byte aligned base is read in place; a base
    one element in is copied first; leading dimensions are flattened."""
    k, n = 1024, 512
    _, w = _mixed_inputs(cuda, 1, k, n)
    if kind == "column slice":
        x = torch.randn((19, k + 8), generator=cuda, device="cuda")[:, 4:4 + k]
    elif kind == "offset":
        x = torch.randn(19 * k + 1, generator=cuda, device="cuda")[1:].view(19, k)
    else:
        x = torch.randn((1, 19, k), generator=cuda, device="cuda")
    got = mg.matmul(x, w)
    assert got.shape == (*x.shape[:-1], n)
    _assert_mixed_close(got, ref.mixed_matmul(x, w))


def test_mixed_gemm_refuses_what_it_does_not_take(cuda):
    x, w = _mixed_inputs(cuda, 4, 256, 96)
    launched = mg.launches.value
    with pytest.raises(ValueError, match="invalid shape"):
        mg.matmul(x, w[:, :92])                        # N not a multiple of 8
    with pytest.raises(ValueError, match="against"):
        mg.matmul(x[:, :128], w)
    assert mg.launches.value == launched
    assert not mg.takes(x, w.float()) and not mg.takes(x.bfloat16(), w)
    assert not mg.takes(x.requires_grad_(True), w) and mg.takes(x.detach(), w)


def _routed(gen, T, d, f, E, width, k):
    """Tokens routed top-k over ``width`` experts (the first E held), none
    to experts 0 and 3; the held experts' weights as the models draw them."""
    xf = torch.randn((T, d), generator=gen, device="cuda")
    scores = torch.rand((T, width), generator=gen, device="cuda")
    scores[:, [0, 3]] = -1.0
    topi = torch.argsort(scores, dim=1, descending=True)[:, :k]
    topw = torch.softmax(torch.rand((T, k), generator=gen, device="cuda"), -1)
    ws = [(torch.randn(shape, generator=gen, device="cuda") / shape[1] ** 0.5)
          .to(torch.bfloat16) for shape in ((E, d, f), (E, d, f), (E, f, d))]
    return xf, topw, topi, ws


@pytest.mark.parametrize("shape", ["qwen", "jamba"])
@pytest.mark.parametrize("dropless", [True, False])
def test_grouped_experts_match_the_capacity_buffer(cuda, monkeypatch, shape, dropless):
    """The MoE layer's experts through the grouped kernel (two launches)
    against the capacity buffer of widened weights: Qwen's 128 experts of
    2048 x 768 top-8, Jamba's 8 held of 16 at 4096 x 14336 top-2, two
    experts without pairs; dropless, or at half the mean load, which
    drops pairs: the same y, counts and dropped pairs."""
    from repro_torch.models import moe
    T, d, f, E, width, k = {"qwen": (64, 2048, 768, 128, 128, 8),
                            "jamba": (64, 4096, 14336, 8, 16, 2)}[shape]
    xf, topw, topi, (wg, wu, wd) = _routed(cuda, T, d, f, E, width, k)
    C = T if dropless else T * k // width // 2
    runs = []
    for grouped in (True, False):
        if not grouped:
            monkeypatch.setattr(mg, "takes", lambda x, w: False)
        monkeypatch.setattr(moe, "drop_counter", torch.zeros((), dtype=torch.long,
                                                             device="cuda"))
        launched = mg.launches.value
        y, counts = moe.experts(xf, topw, topi, wg, wu, wd, 0, C)
        torch.cuda.synchronize()
        assert mg.launches.value - launched == (2 if grouped else 0)
        runs.append((y, counts, int(moe.drop_counter)))
    (y1, c1, d1), (y0, c0, d0) = runs
    assert torch.equal(c0, c1) and int(c0[0]) == int(c0[3]) == 0
    assert d0 == d1 == int((c0 - C).clamp(min=0).sum()) and (d0 > 0) == (not dropless)
    _assert_mixed_close(y1, y0)


def _two_layers(which):
    """Two layers at published widths: Qwen3-30B-A3B's (attention and MoE),
    or Jamba2-Mini's kinds (Mamba1 and dense MLP, then attention and MoE,
    8 experts held of 16); dropless."""
    from repro_torch.configs import jamba2_mini, qwen3_moe_30b_a3b
    if which == "qwen":
        return qwen3_moe_30b_a3b.CONFIG.replace(num_layers=2, capacity_factor=1e9)
    return jamba2_mini.CONFIG.replace(num_layers=2, attn_layer_period=2, attn_layer_offset=1,
                                      capacity_factor=1e9)


@pytest.mark.parametrize("which", ["qwen", "jamba"])
def test_a_prefill_chunk_through_the_kernel_matches_the_widening(cuda, monkeypatch, which):
    """A 50-token chunk (of 64 rows) through the kernel, every product
    once (Qwen: q, k, v, o and the grouped experts' two launches a layer,
    and the head; Jamba adds in_proj, x_proj, dt_proj and out_proj, and
    the dense MLP's three), against the widening on the same weights; then
    the decode graph, which holds no launch of it.  Logits and hidden
    states held to 1e-3 of their largest: the two paths' f32 sums differ
    in their last bits, and the chunk's K and V are stored in the bf16 page
    pool and read back from it, where a last-bit difference can move a
    value by one bf16 step (2**-8 of it); the kernel's own products are
    held to 1e-5 above."""
    import numpy as np

    from repro_torch.engine.kv_cache import PagedKVConfig
    from repro_torch.engine.runner import PagedRunner
    from repro_torch.models import transformer as T
    cfg = _two_layers(which)
    params = T.init_params(cfg, cuda)
    kv = PagedKVConfig(num_pages=GRAPH_B * GRAPH_PP + 8, page_size=GRAPH_PAGE,
                       max_pages_per_seq=GRAPH_PP)
    embeds = torch.randn((1, 64, cfg.d_model), generator=cuda, device="cuda")
    table = np.arange(1, GRAPH_PP + 1, dtype=np.int32)
    products = {"A": 4, "M": 4, "moe": 2, "mlp": 3}
    want_launches = 1 + sum(products[kind] + products["moe" if cfg.is_moe_layer(i) else "mlp"]
                            for i, kind in enumerate(cfg.layer_layout))
    out = []
    for through_kernel in (True, False):
        if not through_kernel:
            monkeypatch.setattr(mg, "takes", lambda x, w: False)
        runner = PagedRunner(cfg, params, kv, max_batch=GRAPH_B)
        launched = mg.launches.value
        out.append(runner.prefill_chunk(embeds, table, 0, 50, slot=1))
        torch.cuda.synchronize()
        assert mg.launches.value - launched == (want_launches if through_kernel else 0)
    for got, want in zip(*out):
        _assert_mixed_close(got, want, tol=1e-3)
    monkeypatch.undo()
    runner = PagedRunner(cfg, params, kv, max_batch=GRAPH_B)
    launched, paged = mg.launches.value, pa.launches.value
    for step in _decode_steps(cfg, cuda, n=2, seed=5):
        runner.decode(*step)
    torch.cuda.synchronize()
    n_attn = cfg.layer_layout.count("A")
    assert mg.launches.value == launched and runner._graph.launches == n_attn
    assert pa.launches.value - paged == 2 * n_attn
