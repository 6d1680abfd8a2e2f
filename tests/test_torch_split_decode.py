"""The split (flash-decoding) paged attention, on the CPU.

``repro_torch.kernels.ref.paged_attention_split`` is the plain version
of what the split CUDA kernel computes: each row's tokens cut into
partitions, one partial softmax state per partition, merged by
rescaling.  It is held against the JAX package's oracle
``repro.kernels.ref.paged_attention`` on numpy inputs from a seed, at
2e-5 in f32 (only the order of f32 sums differs).  Rows with seq_len 0
are zeros in the split version (the kernel reads no page for them) and
the average of V in the oracle, so they are compared with zeros.

The wrappers' host-side plans are plain Python and are tested here too:
the paged split (splits, grid, scratch, launches per call)
and the flash route and TMA stride eligibility.  The kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, nq, nkv, hd, page, pp, seq_lens, quant=False):
    """numpy inputs of one call: q, k/v pools (int8 codes and f32 scales
    when ``quant``), a shuffled block table and the given lengths."""
    rng = np.random.default_rng(seed)
    n_pages = b * pp + 3
    q = rng.standard_normal((b, nq, hd)).astype(np.float32)
    kf = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    bt = rng.permutation(n_pages)[:b * pp].reshape(b, pp).astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    if not quant:
        return q, kf, vf, bt, sl, None, None
    ks = np.abs(kf).max(-1) / 127 + 1e-8
    vs = np.abs(vf).max(-1) / 127 + 1e-8
    kq = np.round(kf / ks[..., None]).astype(np.int8)
    vq = np.round(vf / vs[..., None]).astype(np.int8)
    return q, kq, vq, bt, sl, ks.astype(np.float32), vs.astype(np.float32)


def _both(args, window, partition):
    q, kp, vp, bt, sl, ks, vs = args
    j = [None if a is None else jnp.asarray(a) for a in args]
    t = [None if a is None else torch.from_numpy(a) for a in args]
    want = np.asarray(jref.paged_attention(*j[:5], window=window, k_scale_pages=j[5],
                                           v_scale_pages=j[6]))
    got = tref.paged_attention_split(*t[:5], partition=partition, window=window,
                                     k_scale_pages=t[5], v_scale_pages=t[6]).numpy()
    return got, want


# (page, pp, partition): partitions that start on a page, mid-page (48 over
# pages of 16 and 32 over pages of 12), and one partition for the whole row
LAYOUTS = [(16, 8, 32), (16, 8, 48), (12, 10, 32), (16, 8, 256), (8, 16, 64)]


@pytest.mark.parametrize("page,pp,partition", LAYOUTS)
@pytest.mark.parametrize("window", [0, 20, 50])
@pytest.mark.parametrize("quant", [False, True])
def test_split_plain_matches_jax_oracle(page, pp, partition, window, quant):
    full = page * pp
    # empty row, one token, exactly a partition, one past it, the full row,
    # a row that leaves the last partitions empty, a window across borders
    lens = [0, 1, min(partition, full), min(partition + 1, full), full, full // 3,
            min(2 * partition + 5, full)]
    args = _inputs(7, len(lens), 10, 2, 32, page, pp, lens, quant)
    got, want = _both(args, window, partition)
    np.testing.assert_allclose(got[1:], want[1:], **TOL)
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))


@pytest.mark.parametrize("nq,nkv,hd", [(40, 8, 128), (4, 2, 64), (36, 4, 32)])
def test_split_plain_matches_jax_oracle_at_model_groupings(nq, nkv, hd):
    """Qwen2.5-14B's g = 5 at hd 128, qwen_omni's g = 2, StarCoder2's g = 9
    (several head blocks of the kernel)."""
    lens = [300, 511, 17, 256]
    args = _inputs(3, 4, nq, nkv, hd, 16, 32, lens)
    got, want = _both(args, 0, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_split_plain_equals_plain_version_in_bf16():
    """In the serving type the split and the unsplit plain versions round
    to the same bf16 values but for last-bit flips."""
    args = _inputs(11, 3, 10, 2, 64, 16, 12, [190, 64, 129])
    t = [torch.from_numpy(a).bfloat16() for a in args[:3]] + \
        [torch.from_numpy(a) for a in args[3:5]]
    got = tref.paged_attention_split(*t, partition=64).float()
    want = tref.paged_attention(*t).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,nq,nkv,hd,page,pp,splits,grid,launches", [
    (8, 40, 8, 128, 16, 128, 8, (16, 8, 8), 2),     # Qwen2.5-14B: g = 5, 2 head blocks
    (8, 4, 2, 32, 16, 16, 1, (2, 8, 1), 1),         # qwen_omni slice: one split
    (4, 36, 4, 128, 16, 64, 4, (12, 4, 4), 2),      # g = 9: three head blocks
    (3, 10, 2, 64, 48, 8, 2, (4, 3, 2), 2),         # the second partition starts mid-page
    (2, 16, 1, 64, 16, 3, 1, (4, 2, 1), 1),         # g = 16
])
def test_paged_plan(b, nq, nkv, hd, page, pp, splits, grid, launches):
    plan = tpa.plan(b, nq, nkv, hd, page, pp)
    assert plan.splits == splits
    assert plan.grid == grid and plan.kernel_launches == launches
    assert plan.scratch_floats == (b * nq * splits * (hd + 2) if splits > 1 else 0)
    assert (splits - 1) * tpa.PARTITION < page * pp <= splits * tpa.PARTITION


def test_paged_plan_has_more_ctas_than_sms_at_the_14b_shape():
    g = tpa.plan(8, 40, 8, 128, 16, 128).grid
    assert g[0] * g[1] * g[2] == 1024 > 132


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.float32, 128, "mma"), (torch.float32, 64, "mma")])
def test_flash_route(dtype, hd, route):
    assert tfa.route(dtype, hd) == route


def _tma_views():
    qkv = torch.zeros((2, 40, 3, 4, 128), dtype=torch.bfloat16)
    flat = torch.zeros(2 * 40 * 4 * 128 + 1, dtype=torch.bfloat16)
    return {
        "contiguous": (torch.zeros((2, 40, 4, 128), dtype=torch.bfloat16), True),
        "qkv column": (qkv[:, :, 1], True),
        "padded rows": (torch.zeros((2, 40, 4, 132), dtype=torch.bfloat16)[..., :128],
                        False),
        "odd base": (flat[1:].view(2, 40, 4, 128), False),
        "head_dim strided": (torch.zeros((2, 40, 4, 256),
                                         dtype=torch.bfloat16)[..., ::2], False),
        "f32 padded by 4": (torch.zeros((2, 40, 4, 84))[..., :80], True),
    }


@pytest.mark.parametrize("name", list(_tma_views()))
def test_flash_tma_eligibility(name):
    t, ok = _tma_views()[name]
    assert tfa.tma_ok(t) is ok


def test_wrappers_take_the_plain_versions_on_cpu():
    args = _inputs(5, 3, 8, 2, 64, 16, 4, [0, 33, 64])
    t = [torch.from_numpy(a) for a in args[:5]]
    n = tpa.launches.value
    got = tpa.paged_attention(*t)
    torch.testing.assert_close(got, tref.paged_attention(*t))
    assert tpa.launches.value == n        # no kernel, no count
