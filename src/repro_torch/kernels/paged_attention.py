"""Paged decode attention: wrapper around ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:
paged_attention``.  The CUDA source's header says what bounds it on the
card and how its design answers that: the tokens of each row are split
into partitions of ``PARTITION`` tokens, one CTA per (kv head, sequence,
partition), and a second kernel merges the partitions' partial softmax
states (flash-decoding).  ``plan`` computes the split from shapes alone,
so no call reads ``seq_lens`` on the host.  One wrapper call is two
kernel launches (split, then combine), or one when a row fits in one
partition; ``launches`` counts wrapper calls.

On a CUDA tensor this wrapper launches the kernels (or raises); on a CPU
tensor it runs the plain version, ``ref.paged_attention``.
``ref.paged_attention_split`` is the plain version of the split itself.

One difference from the plain version: a row with ``seq_len == 0`` (an
inactive decode slot) comes out as zeros from the kernel, which reads no
page for it, where the plain version averages V over the row's gathered
pages.  Both are finite and the serving path discards those rows.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset (one per call)
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
#: query heads one CTA takes at most; larger groups are split into balanced blocks
HEADS_PER_CTA = 4
#: tokens of a row per CTA, a whole number of the kernel's 32-token tiles
PARTITION = 256


class Plan(NamedTuple):
    """How one call is split: ``grid`` of the split kernel (kv heads x
    head blocks, sequences, splits), the f32 scratch for the partials
    (``(B, nq, splits, hd)`` partial outputs, then ``(B, nq, splits, 2)``
    maxima and sums; none with one split) and the launches per call.
    The kernel checks that ``splits`` is its own count."""
    splits: int
    grid: Tuple[int, int, int]
    scratch_floats: int
    kernel_launches: int


def plan(batch: int, nq: int, nkv: int, hd: int, page: int, pp: int) -> Plan:
    """The split of a call with a (batch, pp) block table of ``page``-token
    pages, from shapes alone."""
    splits = -(-pp * page // PARTITION)
    head_blocks = -(-(nq // nkv) // HEADS_PER_CTA)
    scratch = batch * nq * splits * (hd + 2) if splits > 1 else 0
    return Plan(splits, (nkv * head_blocks, batch, splits), scratch, 2 if splits > 1 else 1)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                    window: int = 0, k_scale_pages: torch.Tensor | None = None,
                    v_scale_pages: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, nq, hd); k/v_pages: (P, page, nkv, hd) f32/bf16 (the dtype
    of q) or int8 with (P, page, nkv) f32 scales; block_tables (B, pp)
    int32; seq_lens (B,) int32.  Returns (B, nq, hd) in q.dtype."""
    if not q.is_cuda:
        return ref.paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                                   window=window, k_scale_pages=k_scale_pages,
                                   v_scale_pages=v_scale_pages)
    b, nq, hd = q.shape
    _, page, nkv, hd_k = k_pages.shape
    quant = k_pages.dtype == torch.int8
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    if quant:
        if k_scale_pages is None or v_scale_pages is None:
            raise ValueError("int8 page pools need k_scale_pages and v_scale_pages")
        tensors += [k_scale_pages, v_scale_pages]
        for s in (k_scale_pages, v_scale_pages):
            if s.dtype != torch.float32 or s.shape != k_pages.shape[:3] \
                    or not s.is_contiguous():
                raise ValueError("scale pages must be contiguous f32 (P, page, nkv)")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must be on q's device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: unsupported q dtype {q.dtype}")
    if not quant and k_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: pages {k_pages.dtype} must match q {q.dtype} "
                         f"or be int8")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: k_pages and v_pages differ")
    if hd not in HEAD_DIMS or hd_k != hd:
        raise ValueError(f"paged_attention: head_dim {hd} not in {HEAD_DIMS}")
    if nq % nkv or nq // nkv > MAX_GROUP:
        raise ValueError(f"paged_attention: {nq} query heads over {nkv} kv heads")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) \
            or (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("paged_attention: page pools must be contiguous and "
                         "16-byte aligned")
    if k_pages.shape[0] * page * nkv >= 2 ** 31:
        raise ValueError("paged_attention: the pool has 2**31 rows or more")
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("paged_attention: block_tables/seq_lens do not match the batch")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    p = plan(b, nq, nkv, hd, page, bt.shape[1])
    out = torch.empty_like(q)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32, device=q.device)
               if p.scratch_floats else None)
    lib = build.load("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale_pages.data_ptr() if quant else None,
            v_scale_pages.data_ptr() if quant else None,
            bt.data_ptr(), sl.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, nq, nkv, hd, page, bt.shape[1], _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
            int(window), PARTITION, p.splits, float(hd ** -0.5), stream)
    build.check(rc, "paged_attention")
    launches.add()
    return out
