"""Paged decode attention: wrapper around ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:
paged_attention``.  The CUDA kernel's header says what bounds it on the
card and how its design answers that.  On a CUDA tensor this wrapper
launches the kernel (or raises); on a CPU tensor it runs the plain
version, ``ref.paged_attention``.

One difference from the plain version: a row with ``seq_len == 0`` (an
inactive decode slot) comes out as zeros from the kernel, which reads no
page for it, where the plain version averages V over the row's gathered
pages.  Both are finite and the serving path discards those rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16


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
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("paged_attention: block_tables/seq_lens do not match the batch")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.load("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale_pages.data_ptr() if quant else None,
            v_scale_pages.data_ptr() if quant else None,
            bt.data_ptr(), sl.data_ptr(), out.data_ptr(),
            b, nq, nkv, hd, page, bt.shape[1], _DTYPES[q.dtype],
            _DTYPES[k_pages.dtype], int(window), float(hd ** -0.5), stream)
    build.check(rc, "paged_attention")
    launches.add()
    return out
