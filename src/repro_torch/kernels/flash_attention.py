"""Full-sequence attention: wrapper around ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``.  The CUDA source holds two kernels, and the route is
chosen here, explicitly, by type and head_dim (``route``):

- ``"tensor-core"``: bf16 at head_dim 64 and 128.  wgmma tiles fed by TMA
  loads; q, k and v are read through TMA descriptors, which need the base
  address and the head, sequence and batch strides to be multiples of 16
  bytes (``tma_ok``).  A view that fails this is copied into a fresh
  contiguous tensor first: a copy, not another kernel.
- ``"cuda-core"``: f32 at any supported head_dim (f32 parity at 2e-5
  rules out TF32) and bf16 at head_dim 32 and 80 (80-element rows fit no
  TMA swizzle span; 32 is too narrow for wgmma).  Reads through strides;
  only head_dim must be contiguous.

The source's header says what bounds each on the card and how its design
answers that.  Unlike the Pallas version both take any Sq and Sk (ragged
tails are masked in the kernel).  On a CUDA tensor this wrapper launches
the routed kernel or raises: a failed build, a refused TMA descriptor or
a failed launch is an error, never a quiet switch to the other kernel or
to the plain version.  On a CPU tensor it runs the plain version,
``ref.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
TENSOR_CORE_HEAD_DIMS = (64, 128)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a call takes."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor-core"
    return "cuda-core"


def tma_ok(t: torch.Tensor) -> bool:
    """Whether a (B, S, H, hd) tensor can be described to TMA as it is:
    head_dim contiguous, base address and the other strides multiples of
    16 bytes."""
    if t.stride(-1) != 1:
        return False
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s > 0 and s * es % 16 == 0 for s in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd), all f32 or all bf16.
    Returns a contiguous (B, Sq, nq, hd) in q.dtype."""
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
    if route(q.dtype, hd) == "tensor-core":
        # a copy is contiguous and starts on the allocator's aligned base
        q, k, v = (t if tma_ok(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:   # only head_dim has to be contiguous; the rest is read through strides
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
