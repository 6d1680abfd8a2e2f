"""The chunked Mamba1 scan, on the CPU.

``repro_torch.kernels.ref.mamba1_scan_chunked`` is the plain version of
what the chunked CUDA kernels compute: chunk end states and decays from
a zero state, the true start states carried over the chunks in order,
then every chunk rerun from its start.  It is held against the JAX
package's oracle ``repro.kernels.ref.mamba1_scan`` on numpy inputs from
a seed, at 2e-5 in f32 (only the order of f32 operations differs), over
sequence lengths on both sides of the chunk edges, chunks of 1 to 256
steps, with and without an initial state, state sizes 5 and 16, and
column slices of wider tensors as the model passes them.

The wrapper's host plan (chunk, chunks, grid, scratch, launches per
call) is plain Python and is tested here too.  The kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, bt, s, di, n, h0):
    """numpy f32 inputs drawn as tests/test_kernels.py draws them: dt is
    softplus(normal) * 0.1 and A = -exp(0.3 normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, s, di)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, di)))) * 0.1
    A = -np.exp(rng.standard_normal((di, n)) * 0.3)
    B = rng.standard_normal((bt, s, n))
    C = rng.standard_normal((bt, s, n))
    D = 1.0 + 0.1 * rng.standard_normal(di)
    h = rng.standard_normal((bt, di, n)) if h0 else None
    return [None if a is None else a.astype(np.float32) for a in (x, dt, A, B, C, D, h)]


def _torch(args, strided):
    """torch tensors of the inputs; ``strided`` hands x, B and C over as
    column slices of wider tensors (xs of xz, B and C of x_proj's output)."""
    x, dt, A, B, C, D, h = (None if a is None else torch.from_numpy(a) for a in args)
    if strided:
        x = torch.cat([x, torch.zeros_like(x)], -1)[..., :x.shape[-1]]
        n = B.shape[-1]
        proj = torch.cat([torch.zeros_like(B), B, C], -1)
        B, C = proj[..., n:2 * n], proj[..., 2 * n:]
        assert not x.is_contiguous() and not B.is_contiguous()
    return x, dt, A, B, C, D, h


def _check(args, chunk, strided):
    want_y, want_h = jref.mamba1_scan(*(None if a is None else jnp.asarray(a) for a in args))
    y, h = tref.mamba1_scan_chunked(*_torch(args, strided), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("s", [1, 7, 64, 65, 200, 1000])
@pytest.mark.parametrize("chunk", [1, 16, 64, 256])
def test_chunked_scan_matches_oracle(s, chunk):
    """One chunk, a partial one, a chunk exactly, one step past it, and
    many chunks (1000 one-step chunks at the extreme)."""
    _check(_inputs(s + chunk, 2, s, 12, 16, h0=True), chunk, strided=False)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("n", [5, 16])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s,chunk", [(200, 64), (65, 16)])
def test_chunked_scan_variants(s, chunk, h0, n, strided):
    """Without and with an initial state, a state size that leaves the
    last lane of a channel partly empty (5), column slices."""
    _check(_inputs(7 * n + h0, 2, s, 10, n, h0), chunk, strided)


def test_chunked_scan_keeps_bf16_outputs():
    args = _inputs(3, 1, 70, 8, 16, h0=False)
    x, dt, A, B, C, D, _ = _torch(args, False)
    y, h = tref.mamba1_scan_chunked(x.bfloat16(), dt.bfloat16(), A, B.bfloat16(),
                                    C.bfloat16(), D, chunk=64)
    want_y, want_h = tref.mamba1_scan(x.bfloat16(), dt.bfloat16(), A, B.bfloat16(),
                                      C.bfloat16(), D)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(h, want_h, **TOL)


@pytest.mark.parametrize("bt,s,di,n,chunk,chunks,grid,launches", [
    (8, 1, 8192, 16, 64, 1, (256, 2, 1), 1),        # Falcon-Mamba decode: the one-step kernel
    (3, 1, 200, 5, 64, 1, (7, 1, 1), 1),            # its batch rows, four per CTA
    (2, 2, 200, 5, 64, 1, (7, 1, 2), 1),            # S = 2: the single-pass scan
    (1, 1000, 8192, 16, 64, 16, (256, 16, 1), 3),   # Falcon-Mamba prefill
    (1, 64, 200, 5, 64, 1, (7, 1, 1), 1),           # S = one chunk: still one pass
    (1, 65, 200, 5, 64, 2, (7, 2, 1), 3),           # one step more: chunked
    (2, 2048, 64, 16, 64, 32, (2, 32, 2), 3),       # the most chunks of 64 steps
    (2, 4096, 64, 16, 128, 32, (2, 32, 2), 3),      # wider chunks beyond
    (1, 5000, 64, 8, 192, 27, (2, 27, 1), 3),
])
def test_scan_plan(bt, s, di, n, chunk, chunks, grid, launches):
    plan = tms.plan(bt, s, di, n)
    assert (plan.chunk, plan.chunks, plan.grid, plan.kernel_launches) == (
        chunk, chunks, grid, launches)
    assert (chunks - 1) * chunk < s <= chunks * chunk
    n4 = -(-n // 4) * 4        # each lane's four states are one 16-byte slot
    assert plan.scratch_floats == 2 * bt * (chunks - 1) * di * n4
    assert (plan.scratch_floats == 0) == (s <= tms.CHUNK)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 2047, 2048, 2049, 10_000, 100_000])
def test_scan_plan_bounds_the_chunks(s):
    """Chunks are whole 64-step tiles, the narrowest that make at most 32
    of them, and one pass takes every S up to one chunk."""
    plan = tms.plan(1, s, 8192, 16)
    assert plan.chunk % tms.CHUNK == 0 and plan.chunks <= tms.MAX_CHUNKS
    assert plan.chunk == tms.CHUNK or -(-s // (plan.chunk - tms.CHUNK)) > tms.MAX_CHUNKS
    assert (plan.kernel_launches == 1) == (s <= tms.CHUNK)


def test_scan_wrapper_runs_the_plain_scan_on_the_cpu():
    args = _inputs(11, 2, 90, 16, 16, h0=True)
    t = _torch(args, strided=True)
    n = tms.launches.value
    y, h = tms.mamba1_scan(*t)
    want_y, want_h = tref.mamba1_scan(*t)
    assert tms.launches.value == n
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
