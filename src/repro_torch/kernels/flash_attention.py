"""Full-sequence attention: wrappers around ``csrc/flash_attention.cu``
(the forward) and ``csrc/flash_attention_bwd.cu`` (its gradient).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``.  The CUDA source holds two kernels, both on the tensor
cores, and the route is chosen here, explicitly, by type and head_dim
(``route``), with no fallback from one to the other:

- ``"wgmma"``: bf16 at head_dim 64 and 128.  Warpgroup wgmma tiles fed
  by TMA loads; q, k and v are read through TMA descriptors, which need
  the base address and the head, sequence and batch strides to be
  multiples of 16 bytes (``tma_ok``).  A view that fails this is copied
  into a fresh contiguous tensor first: a copy, not another kernel.
- ``"mma"``: f32 at every head_dim and bf16 at head_dim 32 and 80
  (80-element rows fit no TMA swizzle span; 32 is too narrow for
  wgmma).  Warp-level mma.sync; f32 products are split into three TF32
  products (held to the f32 tolerance of 2e-5;
  ``ref.flash_attention_tf32x3`` is that arithmetic in plain PyTorch).
  Reads through strides; only head_dim must be contiguous.

The source's header says what bounds each on the card and how its design
answers that.  Unlike the Pallas version both take any Sq and Sk (ragged
tails are masked in the kernel).  On a CUDA tensor this wrapper launches
the routed kernel or raises: a failed build, a refused TMA descriptor or
a failed launch is an error, never a quiet switch to the other kernel or
to the plain version.  On a CPU tensor it runs the plain version,
``ref.flash_attention``.

With ``return_lse=True`` the forward also returns each row's logsumexp
of the scaled scores, f32 (B, nq, Sq) in log2 units (``ref.
flash_attention``'s convention), for the backward: both kernels write it
from their epilogue (a second instantiation of each; the serving path
launches the one without).

``flash_attention_bwd`` is the gradient; its source's header gives each
route's design, chosen by ``bwd_route``.  Both take the forward's lse
(given none, the wrapper runs the forward's lse instantiation first) and
run three launches: a pre-pass (D = rowsum(dO o), the f32 dQ accumulator
zeroed), the main kernel (the five products per tile, keys as rows, dK
and dV in registers, dQ added with f32 atomics, so its last bits vary
from run to run), and a post-pass (dQ to the input type):

- ``"wgmma"``: bf16 at head_dim 64 and 128 (training's route).  One
  wgmma kernel fed by TMA (FlashAttention-3's backward); q, k, v and do
  pass through TMA (``tma_ok``: a view that fails it is copied).
- ``"mma"``: bf16 at head_dim 32 and 80 and f32 at every head_dim.  One
  ``mma.sync`` kernel, f32 as three TF32 products of split operands
  (``ref.flash_attention_bwd_tiled(tf32x3=True)`` is that arithmetic);
  reads through strides.  ``bwd_plan`` sizes its grid from the shapes:
  where the key tiles fill less than the card, each is split over
  several CTAs, which add dK and dV through f32 atomics too.

It takes Sq == Sk only (all a training forward calls) and raises
otherwise; it has its own launch counter (one per call), and the same
rule: on a CUDA tensor it launches or raises, on a CPU tensor it runs
``ref.flash_attention_bwd``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = build.LaunchCounter()
#: launches of the backward's kernels (one per call) since the last reset
bwd_launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
WGMMA_HEAD_DIMS = (64, 128)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a call takes."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel of ``csrc/flash_attention_bwd.cu`` a call takes: the
    forward's route (f32 and bf16 at head_dim 32 and 80 on mma.sync)."""
    return route(dtype, head_dim)


#: (query rows, keys) per tile of each backward kernel: lse, D and dQ's
#: f32 accumulator are kept in rows padded to a multiple of the first
BWD_TILES = {("wgmma", torch.bfloat16): (64, 128), ("mma", torch.bfloat16): (64, 128),
             ("mma", torch.float32): (32, 128)}


class BwdPlan(NamedTuple):
    """How one backward call runs: its route, tiles, padded row count
    (``s_pad``), key tiles, and how many CTAs share each key tile's walk
    (``splits``; the f32 dK/dV accumulator takes ``dkv_floats``)."""
    route: str
    block_q: int
    block_k: int
    s_pad: int
    key_tiles: int
    splits: int
    dkv_floats: int


def bwd_plan(dtype: torch.dtype, batch: int, s: int, nq: int, nkv: int, hd: int,
             sms: int) -> BwdPlan:
    """The backward's grid from shapes alone.  The mma route runs one CTA
    per (key tile, kv head, batch); where those fill fewer than the
    card's ``sms`` multiprocessors, each key tile's walk over (query head,
    query tile) is split over ceil(sms / CTAs) CTAs, or as many as the
    walk has items if that is fewer."""
    r = bwd_route(dtype, hd)
    bq, bk = BWD_TILES[r, dtype]
    n_qt, n_kt = -(-s // bq), -(-s // bk)
    splits = 1
    ctas = n_kt * nkv * batch
    if r == "mma" and ctas < sms:
        splits = min(-(-sms // ctas), nq // nkv * n_qt)
    dkv = 2 * batch * nkv * n_kt * bk * hd if splits > 1 else 0
    return BwdPlan(r, bq, bk, n_qt * bq, n_kt, splits, dkv)


def tma_ok(t: torch.Tensor) -> bool:
    """Whether a (B, S, H, hd) tensor can be described to TMA as it is:
    head_dim contiguous, base address and the other strides multiples of
    16 bytes."""
    if t.stride(-1) != 1:
        return False
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s > 0 and s * es % 16 == 0 for s in t.stride()[:3])


def _tma_views(*ts: torch.Tensor):
    """Each tensor as it is if TMA can read it, else a contiguous copy
    (which starts on the allocator's aligned base)."""
    return tuple(t if tma_ok(t) else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, return_lse: bool = False):
    """q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd), all f32 or all bf16.
    Returns a contiguous (B, Sq, nq, hd) in q.dtype; with ``return_lse``
    the pair (out, lse), lse the rows' logsumexp (f32 (B, nq, Sq), log2
    units)."""
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)
    _check("flash_attention", q, k, v)
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if route(q.dtype, hd) == "wgmma":
        q, k, v = _tma_views(q, k, v)
    else:   # only head_dim has to be contiguous; the rest is read through strides
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    lse = (torch.empty((b, nq, sq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    out = torch.empty((b, sq, nq, hd), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, sk, nq, nkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _DTYPES[q.dtype], int(causal), int(window), float(hd ** -0.5), stream)
    build.check(rc, "flash_attention")
    launches.add()
    return (out, lse) if return_lse else out


def _check(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *q_like: torch.Tensor) -> None:
    """Raise on what the kernels do not take: devices, dtypes, shapes,
    head_dim, head grouping.  ``q_like`` tensors must match q."""
    b, _, nq, hd = q.shape
    bk, _, nkv, hd_k = k.shape
    if any(t.device != q.device for t in (k, v, *q_like)):
        raise ValueError(f"{op}: every tensor must be on one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *q_like)):
        raise ValueError(f"{op}: dtypes {[str(t.dtype) for t in (q, k, v, *q_like)]}; "
                         f"need all f32 or all bf16")
    if v.shape != k.shape or bk != b or hd_k != hd or any(t.shape != q.shape for t in q_like):
        raise ValueError(f"{op}: shapes {[tuple(t.shape) for t in (q, k, v, *q_like)]} "
                         f"do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{op}: head_dim {hd} not in {HEAD_DIMS}")
    if nq % nkv:
        raise ValueError(f"{op}: {nq} query heads over {nkv} kv heads")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True, window: int = 0,
                        lse: torch.Tensor | None = None):
    """Gradient of ``flash_attention``: q, o (its output) and do (the
    output's gradient) (B, S, nq, hd); k, v (B, S, nkv, hd), all f32 or
    all bf16; lse, optional, the forward's (f32 (B, nq, S), log2 units):
    given None, the forward's lse instantiation computes it first (one
    more forward launch).  Returns contiguous (dq, dk, dv) in q.dtype."""
    if not q.is_cuda:
        return ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
    _check("flash_attention_bwd", q, k, v, o, do)
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    if k.shape[1] != s:
        raise ValueError(f"flash_attention_bwd: {s} queries over {k.shape[1]} keys; "
                         f"the backward takes Sq == Sk only")
    if lse is None:
        lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)[1]
    elif lse.shape != (b, nq, s) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}; need f32 {(b, nq, s)} on {q.device}")
    lse = lse.contiguous()
    plan = bwd_plan(q.dtype, b, s, nq, nkv, hd,
                    torch.cuda.get_device_properties(q.device).multi_processor_count)
    if plan.route == "wgmma":
        q, k, v, do = _tma_views(q, k, v, do)
        o = o if o.stride(-1) == 1 else o.contiguous()
    else:   # only head_dim has to be contiguous; the rest is read through strides
        q, k, v, o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, o, do))
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, nq, plan.s_pad), **f32)
    lse_pad = torch.empty_like(delta)
    dq_acc = torch.empty((b, nq, plan.s_pad, hd), **f32)
    dkv_acc = torch.empty(plan.dkv_floats, **f32) if plan.dkv_floats else None
    dq = torch.empty((b, s, nq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, nkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            lse_pad.data_ptr(), dq_acc.data_ptr(),
            None if dkv_acc is None else dkv_acc.data_ptr(),
            b, s, nq, nkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3],
            _DTYPES[q.dtype], int(causal), int(window), plan.splits, float(hd ** -0.5),
            stream)
    build.check(rc, "flash_attention_bwd")
    bwd_launches.add()
    return dq, dk, dv
