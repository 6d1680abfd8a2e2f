"""Core neural layers: RMSNorm, RoPE, GQA projections, full-sequence
(flash) and dense-cache decode attention, int8 KV quantization, SwiGLU
MLP, and the pre-norm transformer block (MLP or MoE).

Functional, like the JAX package: ``init_*`` builds a parameter dict of
tensors from a ``torch.Generator``, the other functions consume it.
Layer parameters stack over a leading ``num_layers`` axis (see
``transformer.init_params``) so weights carry across one tensor per leaf.

Matrix products follow JAX's type promotion, which ``torch.matmul`` does
not do by itself: an f32 activation against bf16 weights computes in
f32 (chunked prefill), a bf16 activation against bf16 weights in bf16
(batched decode).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def _dense_init(gen: torch.Generator, shape, in_axis_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / np.sqrt(max(1, in_axis_size))
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def stack_init(init_fn, gen: torch.Generator, n: int) -> dict:
    """Stack ``n`` draws of ``init_fn(gen)`` along a new leading axis,
    filling preallocated tensors one layer at a time (a full-width model
    never holds two copies of a stacked leaf)."""
    first = init_fn(gen)

    def alloc(leaf):
        out = torch.empty((n, *leaf.shape), dtype=leaf.dtype, device=leaf.device)
        out[0] = leaf
        return out

    stacked = tree_map(alloc, first)
    for i in range(1, n):
        _tree_zip(lambda dst, src: dst[i].copy_(src), stacked, init_fn(gen))
    return stacked


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp`` computes it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) x (d, *out) -> (..., *out): ``einsum("...d,d...")``."""
    return matmul(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def unproject(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., nh, hd) x (nh, hd, d) -> (..., d): ``einsum("...qh,qhd")``."""
    return matmul(o.reshape(*o.shape[:-2], -1), w.reshape(-1, w.shape[-1]))


# ----------------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _rope_freqs(half: int, theta: float, device: str) -> torch.Tensor:
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    return torch.exp(-log_theta * (torch.arange(half, dtype=torch.float32) / half)
                     ).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embeddings.

    x: (..., S, H, hd); positions: broadcastable to (..., S). Split-half
    convention, computed in f32.
    """
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), str(x.device))
    ang = positions[..., None].float() * freqs         # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                 # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Attention projections (GQA, optional bias)
# ----------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dtype = torch_dtype(cfg.dtype)
    p = {
        "wq": _dense_init(gen, (d, nq, hd), d, dtype),
        "wk": _dense_init(gen, (d, nkv, hd), d, dtype),
        "wv": _dense_init(gen, (d, nkv, hd), d, dtype),
        "wo": _dense_init(gen, (nq, hd, d), nq * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq, hd), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((nkv, hd), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((nkv, hd), dtype=dtype, device=gen.device)
    return p


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    q = project(x, p["wq"])
    k = project(x, p["wk"])
    v = project(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) int8 symmetric quantization.

    x: (..., hd) -> (int8 (..., hd), scale (...,) f32).
    """
    x32 = x.float()
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """One-token decode against a dense KV cache.

    x: (B, 1, d); pos: (B,) current positions; caches (B, S, nkv, hd),
    int8 with (B, S, nkv) f32 scales when cfg.kv_cache_dtype == "int8".
    The new token's K/V are written into the caches in place (the JAX
    package returns new caches instead), for the batch rows ``rows`` (all
    when None): the other rows' caches stay as they were, as the JAX
    runner's mask keeps them.  A sliding-window cache of ``window``
    columns is a ring: writes wrap, and column j holds absolute position
    pos - ((pos - j) mod S).  Returns (B, 1, d).
    """
    q, k, v = _qkv(cfg, p, x)                       # q (B,1,nq,hd), k/v (B,1,nkv,hd)
    posb = pos.long().expand(x.shape[0])
    if cfg.head_dim and cfg.rope_theta:
        q = rope(q, posb[:, None], cfg.rope_theta)
        k = rope(k, posb[:, None], cfg.rope_theta)
    s = k_cache.shape[1]
    window = cfg.sliding_window if cfg.attn_variant == "swa" else 0
    ring = bool(window) and s == window
    write_idx = posb % s if ring else posb
    if rows is None:
        rows = torch.arange(x.shape[0], device=x.device)
    col = write_idx[rows]
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_cache[rows, col] = kq[rows, 0]
        v_cache[rows, col] = vq[rows, 0]
        k_scale[rows, col] = ks[rows, 0]
        v_scale[rows, col] = vs[rows, 0]
    else:
        k_cache[rows, col] = k[rows, 0].to(k_cache.dtype)
        v_cache[rows, col] = v[rows, 0].to(v_cache.dtype)
    key_positions = None
    if ring:
        j = torch.arange(s, device=x.device)[None, :]
        key_positions = posb[:, None] - ((posb[:, None] - j) % s)
    o = ops.decode_attention(q, k_cache, v_cache, posb, window=window,
                             k_scale=k_scale, v_scale=v_scale,
                             key_positions=key_positions)
    return unproject(o.to(x.dtype), p["wo"])


# ----------------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dtype = torch_dtype(cfg.dtype)
    return {
        "wg": _dense_init(gen, (d, f), d, dtype),
        "wu": _dense_init(gen, (d, f), d, dtype),
        "wd": _dense_init(gen, (f, d), f, dtype),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, p["wg"])) * matmul(x, p["wu"])
    return matmul(h, p["wd"])


# ----------------------------------------------------------------------------
# Transformer block (attention + MLP or MoE), pre-norm
# ----------------------------------------------------------------------------

def init_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    from repro_torch.models import moe as moe_mod
    dtype = torch_dtype(cfg.dtype)
    p = {
        "ln1": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": init_attention(cfg, gen),
        "ln2": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if cfg.is_moe:
        p["moe"] = moe_mod.init_moe(cfg, gen)
    else:
        p["mlp"] = init_mlp(cfg, gen)
    return p


def mlp_or_moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
               routes: list | None = None) -> torch.Tensor:
    """The block's feed-forward: the SwiGLU MLP, or the MoE layer (its aux
    loss dropped, as every serving path of the JAX package drops it;
    ``routes`` as ``moe.moe_forward`` takes it)."""
    if cfg.is_moe:
        from repro_torch.models import moe as moe_mod
        return moe_mod.moe_forward(cfg, p["moe"], x, routes)[0]
    return mlp(p["mlp"], x)


def attention_full(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder), through the
    flash kernel on the card."""
    q, k, v = _qkv(cfg, p, x)
    if cfg.head_dim and cfg.rope_theta and not cfg.is_encoder:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if cfg.attn_variant == "swa" else 0
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return unproject(o, p["wo"])


def block_full(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
               causal: bool = True):
    """Full-sequence transformer block.  Returns (x, aux_loss)."""
    x = x + attention_full(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.rmsnorm_eps),
                           positions, causal=causal)
    h = rmsnorm(p["ln2"], x, cfg.rmsnorm_eps)
    if cfg.is_moe:
        from repro_torch.models import moe as moe_mod
        y, aux = moe_mod.moe_forward(cfg, p["moe"], h)
    else:
        y, aux = mlp(p["mlp"], h), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-norm attention + MLP (or MoE) block for one decode token; the
    caches are written in place (see ``attention_decode``).  Every batch
    row goes through the MoE router, inactive ones too, as in the JAX
    package (an expert's capacity counts them)."""
    x = x + attention_decode(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.rmsnorm_eps), pos,
                             k_cache, v_cache, k_scale, v_scale, rows)
    return x + mlp_or_moe(cfg, p, rmsnorm(p["ln2"], x, cfg.rmsnorm_eps))
