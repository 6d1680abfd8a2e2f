"""Full-sequence attention: wrapper around ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``.  The CUDA kernel's header says what bounds it on the
card and how its design answers that.  Unlike the Pallas version it
takes any Sq and Sk (ragged tails are masked in the kernel) and reads
q, k and v through their strides in the (B, S, H, hd) layout.  On a CUDA
tensor this wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``ref.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd), all f32 or all bf16.
    Returns (B, Sq, nq, hd) in q.dtype."""
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    b, sq, nq, hd = q.shape
    bk, sk, nkv, hd_k = k.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"need all f32 or all bf16")
    if v.shape != k.shape or bk != b or hd_k != hd:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if nq % nkv:
        raise ValueError(f"flash_attention: {nq} query heads over {nkv} kv heads")
    # only head_dim has to be contiguous; the rest is read through strides
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, nq, hd), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, nq, nkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _DTYPES[q.dtype], int(causal), int(window), float(hd ** -0.5), stream)
    build.check(rc, "flash_attention")
    launches.add()
    return out
