"""Dispatch between the hand-written CUDA kernels and their plain versions.

Backends:
  - "ref":  the plain PyTorch versions (kernels/ref.py), on any device.
  - "cuda": the CUDA kernels; raises for tensors that are not on a CUDA
            device, so a run set to "cuda" cannot reach anything else.
  - "auto": "cuda" when the tensors lie on a CUDA device, else "ref".

Set globally with ``set_backend`` or per call with ``backend=``.  Forward
only: the recompute backward of the JAX package's ``custom_vjp`` belongs
to the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

BACKENDS = ("auto", "ref", "cuda")
_BACKEND = "auto"


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    _BACKEND = name


def get_backend(override: str | None = None) -> str:
    return override or _BACKEND


def _use_cuda(x: torch.Tensor, backend: str | None, op: str) -> bool:
    b = get_backend(backend)
    if b == "auto":
        return x.is_cuda
    if b == "cuda" and not x.is_cuda:
        raise RuntimeError(f"{op}: backend 'cuda' was asked for a tensor on {x.device}")
    return b == "cuda"


def flash_attention(q, k, v, *, causal=True, window=0, backend=None):
    if _use_cuda(q, backend, "flash_attention"):
        from repro_torch.kernels import flash_attention as fa
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, pos, *, window=0, backend=None,
                     k_scale=None, v_scale=None, key_positions=None):
    # dense-cache decode has no kernel of its own (it is plain jnp in the
    # JAX package too); the paged path is what the engines run
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window,
                                k_scale=k_scale, v_scale=v_scale,
                                key_positions=key_positions)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    window=0, backend=None, k_scale_pages=None,
                    v_scale_pages=None):
    if _use_cuda(q, backend, "paged_attention"):
        from repro_torch.kernels import paged_attention as pa
        return pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                                  window=window, k_scale_pages=k_scale_pages,
                                  v_scale_pages=v_scale_pages)
    return ref.paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                               window=window, k_scale_pages=k_scale_pages,
                               v_scale_pages=v_scale_pages)


def mamba1_scan(x, dt, A, B, C, D, h0=None, *, backend=None):
    if _use_cuda(x, backend, "mamba1_scan"):
        from repro_torch.kernels import mamba_scan as ms
        return ms.mamba1_scan(x, dt, A, B, C, D, h0)
    return ref.mamba1_scan(x, dt, A, B, C, D, h0)


def mamba2_scan(x, dt, A, B, C, D, h0=None, *, backend=None):
    # no kernel in either package: the JAX package runs its jnp oracle too
    return ref.mamba2_scan(x, dt, A, B, C, D, h0)
