"""Dispatch between the hand-written CUDA kernels and their plain versions.

Backends:
  - "ref":  the plain PyTorch versions (kernels/ref.py), on any device.
  - "cuda": the CUDA kernels; raises for tensors that are not on a CUDA
            device, so a run set to "cuda" cannot reach anything else.
  - "auto": "cuda" when the tensors lie on a CUDA device, else "ref".

Set globally with ``set_backend`` or per call with ``backend=``.

Gradients.  The plain versions are differentiated by autograd.  On the
CUDA path, ``flash_attention`` under grad (grad mode on and an input that
requires grad) runs ``FlashAttention``, the counterpart of the JAX
package's ``flash_attention_trainable`` custom VJP: the CUDA forward, and
a CUDA backward that recomputes the scores from the saved q, k, v,
output and the rows' logsumexp (no O(S^2) residual is kept).  Without
grad the serving path is unchanged: the forward kernel alone.
``mamba1_scan``'s kernel has no backward (nor has the JAX package's: its
Pallas scan has no custom VJP), so its CUDA path raises under grad
rather than run the plain version.
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=0, backend=None):
    if _use_cuda(q, backend, "flash_attention"):
        if _needs_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window)
        from repro_torch.kernels import flash_attention as fa
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' forward and backward: the port's
    ``flash_attention_trainable``.  Saves q, k, v, the output and the
    rows' logsumexp, which the forward writes on every route (its kLse
    instantiation) and the backward takes; the backward recomputes only
    the scores.  On CPU tensors both run the plain versions (the
    wrappers' rule), lse included, so the CPU tests reach it too."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        from repro_torch.kernels import flash_attention as fa
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import flash_attention as fa
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                            window=ctx.window, lse=lse)
        return dq, dk, dv, None, None


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
        if _needs_grad(x, dt, A, B, C, D, h0):
            raise NotImplementedError(
                "mamba1_scan: the CUDA scan has no backward yet; differentiate the plain "
                "version with backend='ref' (or on the CPU)")
        from repro_torch.kernels import mamba_scan as ms
        return ms.mamba1_scan(x, dt, A, B, C, D, h0)
    return ref.mamba1_scan(x, dt, A, B, C, D, h0)


def mamba2_scan(x, dt, A, B, C, D, h0=None, *, backend=None):
    # no kernel in either package: the JAX package runs its jnp oracle too
    return ref.mamba2_scan(x, dt, A, B, C, D, h0)
