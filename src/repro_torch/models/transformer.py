"""Unified model definition of the port: one functional API over the
dense / MoE / SSM / hybrid / encoder / VLM configs.

  init_params(cfg, gen)                          -> params
  forward_full(cfg, params, inputs, remat=True)  -> (logits, aux)      train / encode
  forward_prefill(cfg, params, inputs, max_seq)  -> (logits, cache)    fill a dense cache
  init_decode_cache(cfg, batch, max_seq, device) -> cache
  forward_decode(cfg, params, cache, tok, pos)   -> (logits, cache)    one token

Layer parameters stack over a leading axis (``blocks``; ``mamba`` for the
SSM and hybrid families, whose hybrid also has ONE ``shared_attn`` block
applied after every ``shared_attn_every`` Mamba layers, with a KV cache
per application site).  A model of interleaved layer kinds (Jamba,
``cfg.interleaved``) stacks each kind apart: ``attn`` and ``mamba``
mixers, ``mlp`` and ``moe`` feed-forwards, each row with its own norm
(``ln``); ``layer_views`` gives any model's layers one by one.  The
serving engines run the attention families and the interleaved kinds
through ``engine/runner.py``'s paged KV pool; these dense-cache paths
serve the monolithic baseline and the recurrent-state runner, and
refuse interleaved kinds.  The layers loop in Python where the JAX
package scans them.

``forward_decode`` updates the cache in place (the JAX package returns a
new one): a full-width cache is not copied every step.

Under autograd ``forward_full`` recomputes activations as the JAX
package's ``remat`` does (``torch.utils.checkpoint``), and cuts each
stacked leaf into its layers once (``torch.unbind``) rather than
indexing it per layer: the backward of ``a[i]`` writes a zero tensor of
the whole stack for every layer, that of ``unbind`` stacks the layers'
gradients once.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LAYER_ATTN, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe

_STATE_FAMILIES = ("ssm", "hybrid")
_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``.  The layout
    is the JAX package's: stacked leaves carry a leading layer axis."""
    dtype = L.torch_dtype(cfg.dtype)
    p: dict = {}
    if cfg.modality != "audio_frames":
        emb = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=gen.device)
        for lo in range(0, cfg.vocab_size, 1 << 14):     # bounded f32 temporaries
            hi = min(lo + (1 << 14), cfg.vocab_size)
            emb[lo:hi] = torch.randn((hi - lo, cfg.d_model), generator=gen,
                                     device=gen.device) * 0.02
        p["embed"] = emb
    p["final_ln"] = L.init_rmsnorm(cfg.d_model, dtype, gen.device)
    p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype)
    if cfg.interleaved:
        p.update(_init_kinds(cfg, gen))
    elif cfg.arch_type in _STATE_FAMILIES:
        p["mamba"] = L.stack_init(lambda g: M.init_mamba(cfg, g), gen, cfg.num_layers)
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = L.init_block(cfg, gen)    # one block, shared by every site
    else:
        p["blocks"] = L.stack_init(lambda g: L.init_block(cfg, g), gen, cfg.num_layers)
    return p


def layer_kinds(cfg: ModelConfig) -> list:
    """(mixer, feed-forward) stack names of each layer of an interleaved
    model: ``attn`` or ``mamba``, ``moe`` or ``mlp``."""
    return [("attn" if kind == LAYER_ATTN else "mamba",
             "moe" if cfg.is_moe_layer(i) else "mlp")
            for i, kind in enumerate(cfg.layer_layout)]


def _init_kinds(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The per-kind stacks of an interleaved model, each row with its norm
    (a Mamba layer's ``init_mamba`` draws its own)."""
    dtype = L.torch_dtype(cfg.dtype)

    def with_ln(init):
        return lambda g: {"ln": L.init_rmsnorm(cfg.d_model, dtype, g.device), **init(cfg, g)}

    inits = {"attn": with_ln(L.init_attention), "mamba": lambda g: M.init_mamba(cfg, g),
             "mlp": with_ln(L.init_mlp), "moe": with_ln(moe.init_moe)}
    kinds = [k for pair in layer_kinds(cfg) for k in pair]
    return {k: L.stack_init(init, gen, kinds.count(k))
            for k, init in inits.items() if k in kinds}


def layer_views(cfg: ModelConfig, params: dict) -> list:
    """Each layer's parameters as one dict, views of the stacked leaves:
    a ``blocks`` row for the attention families; for interleaved kinds
    ``ln1`` and the ``attn`` or ``mamba`` mixer, ``ln2`` and the ``mlp``
    or ``moe`` feed-forward, from their stacks' rows."""
    if not cfg.interleaved:
        return [_block(params, i) for i in range(cfg.num_layers)]
    seen = {k: 0 for k in ("attn", "mamba", "mlp", "moe")}
    out = []
    for mixer, ffn in layer_kinds(cfg):
        m = L.tree_map(lambda a, j=seen[mixer]: a[j], params[mixer])
        f = L.tree_map(lambda a, j=seen[ffn]: a[j], params[ffn])
        seen[mixer] += 1
        seen[ffn] += 1
        out.append({"ln1": m["ln"], mixer: m, "ln2": f["ln"], ffn: f})
    return out


def _embed(cfg: ModelConfig, params: dict, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.modality == "audio_frames":
        return inputs  # precomputed frame embeddings (stub frontend)
    return params["embed"][inputs]


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_ln"], x, cfg.rmsnorm_eps)
    return L.matmul(x, params["lm_head"])


def _n_sites(cfg: ModelConfig) -> int:
    """Hybrid: number of shared-attention application sites."""
    return cfg.num_layers // cfg.shared_attn_every


def _layer(params: dict, i: int) -> dict:
    return L.tree_map(lambda a: a[i], params["mamba"])


def _check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.arch_type not in _STATE_FAMILIES + _ATTN_FAMILIES:
        raise NotImplementedError(f"{what}: no {cfg.arch_type!r} family in the port")
    if cfg.interleaved:
        raise NotImplementedError(f"{what}: {cfg.name} interleaves attention and Mamba "
                                  f"layers, which engine/runner.py: PagedRunner serves")


def _block(params: dict, i: int) -> dict:
    return L.tree_map(lambda a: a[i], params["blocks"])


# ----------------------------------------------------------------------------
# full-sequence forward (train / encode)
# ----------------------------------------------------------------------------

# the products that remat="dots" keeps: those with no batch dimension, as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable (the MoE
# experts' batched products and the attention are recomputed)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(body, remat):
    """remat: False | True (recompute the whole body in the backward) |
    "dots" (keep the products' outputs, recompute the rest).  Only under
    autograd: without it there is nothing to recompute for."""
    if not remat or not torch.is_grad_enabled():
        return body
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_products)
        return lambda *a: checkpoint(body, *a, use_reentrant=False, context_fn=ctx)
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def _unbind_layers(tree, n: int) -> list:
    """A stacked tree as ``n`` per-layer trees (``torch.unbind`` per leaf)."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree, 0)


def forward_full(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                 positions: torch.Tensor | None = None, remat=True):
    """inputs: int tokens (B, S) or float frames (B, S, d).  Returns
    (logits (B, S, V), aux): the MoE layers' summed load-balance loss, a
    0-d f32 zero for the other families.  ``remat`` as ``_remat_wrap``:
    per block, per Mamba layer, per hybrid group."""
    _check_family(cfg, "forward_full")
    x = _embed(cfg, params, inputs)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.arch_type in _STATE_FAMILIES:
        x = _state_backbone_full(cfg, params, x, positions, remat)
    else:
        causal = not cfg.is_encoder
        body = _remat_wrap(lambda lp, h: L.block_full(cfg, lp, h, positions, causal=causal),
                           remat)
        for lp in _unbind_layers(params["blocks"], cfg.num_layers):
            x, a = body(lp, x)
            aux = aux + a
    return _unembed(cfg, params, x), aux


def _state_backbone_full(cfg: ModelConfig, params: dict, x: torch.Tensor,
                         positions: torch.Tensor, remat) -> torch.Tensor:
    """The SSM / hybrid layers over a whole sequence, states dropped."""
    layers = _unbind_layers(params["mamba"], cfg.num_layers)
    if cfg.arch_type == "ssm":
        body = _remat_wrap(lambda lp, h: M.mamba_block(cfg, lp, h)[0], remat)
        for lp in layers:
            x = body(lp, x)
        return x

    def group(shared, h, *lps):
        for lp in lps:
            h, _ = M.mamba_block(cfg, lp, h)
        return L.block_full(cfg, shared, h, positions, causal=True)[0]

    group = _remat_wrap(group, remat)
    gs = cfg.shared_attn_every
    for g in range(_n_sites(cfg)):
        x = group(params["shared_attn"], x, *layers[g * gs:(g + 1) * gs])
    return x


# ----------------------------------------------------------------------------
# decode cache
# ----------------------------------------------------------------------------

def _kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.int8 if cfg.kv_cache_dtype == "int8" else L.torch_dtype(cfg.dtype)


def kv_cache_seq(cfg: ModelConfig, max_seq: int) -> int:
    """SWA caches are ring buffers of ``sliding_window`` columns."""
    if cfg.attn_variant == "swa" and 0 < cfg.sliding_window < max_seq:
        return cfg.sliding_window
    return max_seq


def _kv_cache(cfg: ModelConfig, n: int, batch: int, max_seq: int, device) -> dict:
    shape = (n, batch, kv_cache_seq(cfg, max_seq), cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=_kv_store_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=_kv_store_dtype(cfg), device=device)}
    if cfg.kv_cache_dtype == "int8":
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    """Zero caches: dense KV (``k``/``v`` with a leading layer axis, int8
    with ``k_scale``/``v_scale``) for the attention families; ``ssm_h``
    (f32) and ``ssm_conv`` (cfg.dtype) for the state families, and for
    the hybrid one dense KV cache per shared-attention site."""
    _check_family(cfg, "init_decode_cache")
    if cfg.arch_type in _ATTN_FAMILIES:
        return _kv_cache(cfg, cfg.num_layers, batch, max_seq, device)
    h, conv = M.init_mamba_state(cfg, batch, device)
    n = cfg.num_layers
    cache = {"ssm_h": torch.zeros((n, *h.shape), dtype=h.dtype, device=device),
             "ssm_conv": torch.zeros((n, *conv.shape), dtype=conv.dtype, device=device)}
    if cfg.arch_type == "hybrid":
        cache.update(_kv_cache(cfg, _n_sites(cfg), batch, max_seq, device))
    return cache


# ----------------------------------------------------------------------------
# decode step (one new token against the cache)
# ----------------------------------------------------------------------------

def _update(dst: torch.Tensor, src: torch.Tensor, rows: torch.Tensor | None) -> None:
    if rows is None:
        dst.copy_(src)
    else:
        dst[rows] = src[rows].to(dst.dtype)


def _site_kv(cfg: ModelConfig, cache: dict, i: int):
    """Layer (or site) i's dense KV cache views: k, v, k_scale, v_scale."""
    scales = ((cache["k_scale"][i], cache["v_scale"][i])
              if cfg.kv_cache_dtype == "int8" else (None, None))
    return (cache["k"][i], cache["v"][i], *scales)


def forward_decode(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                   pos, rows: torch.Tensor | None = None):
    """tokens: (B, 1) int (or (B, 1, d) frames); pos: scalar or (B,).
    Updates ``cache`` in place for the batch rows ``rows`` (all when None;
    the others keep their state and KV) and returns (logits (B, 1, V),
    cache)."""
    _check_family(cfg, "forward_decode")
    x = _embed(cfg, params, tokens)
    posb = torch.as_tensor(pos, device=x.device).long().expand(x.shape[0])
    if cfg.arch_type in _ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            x = L.block_decode(cfg, _block(params, i), x, posb, *_site_kv(cfg, cache, i),
                               rows=rows)
        return _unembed(cfg, params, x), cache
    gs = cfg.shared_attn_every if cfg.arch_type == "hybrid" else cfg.num_layers
    for i in range(cfg.num_layers):
        sh, sc = cache["ssm_h"][i], cache["ssm_conv"][i]
        x, (h, conv) = M.mamba_block(cfg, _layer(params, i), x, (sh, sc))
        _update(sh, h, rows)
        _update(sc, conv, rows)
        if cfg.arch_type == "hybrid" and (i + 1) % gs == 0:
            x = L.block_decode(cfg, params["shared_attn"], x, posb,
                               *_site_kv(cfg, cache, i // gs), rows=rows)
    return _unembed(cfg, params, x), cache


# ----------------------------------------------------------------------------
# prefill: full-seq compute that also fills the decode cache
# ----------------------------------------------------------------------------

def _attn_prefill(cfg: ModelConfig, lp: dict, h: torch.Tensor, positions: torch.Tensor):
    """One attention block over the whole sequence, causal (flash kernel
    on the card), MLP or MoE: (h, (k, v))."""
    hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
    q, k, v = L._qkv(cfg, lp["attn"], hn)
    if cfg.head_dim and cfg.rope_theta and not cfg.is_encoder:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if cfg.attn_variant == "swa" else 0
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    h = h + L.unproject(o, lp["attn"]["wo"])
    h = h + L.mlp_or_moe(cfg, lp, L.rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps))
    return h, (k, v)


def _to_cache_layout(cfg: ModelConfig, a: torch.Tensor, axis: int, s: int,
                     cache_seq: int) -> torch.Tensor:
    """Lay prompt K/V (seq length s along ``axis``) into the cache's seq
    columns.  Plain cache: right-pad to cache_seq.  Ring (SWA) cache of w
    columns: column j holds the latest prompt position p = j (mod w);
    earlier positions are overwritten, matching decode-time wrapping."""
    axis = axis % a.ndim
    ring = (cfg.attn_variant == "swa" and cfg.sliding_window > 0
            and cache_seq == cfg.sliding_window)
    if not ring:
        shape = list(a.shape)
        shape[axis] = cache_seq - s
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    j = torch.arange(cache_seq, device=a.device)
    p = (s - 1) - ((s - 1 - j) % cache_seq)                 # latest position per column
    gathered = torch.index_select(a, axis, p.clamp(0, s - 1))
    mask_shape = [1] * a.ndim
    mask_shape[axis] = cache_seq
    return torch.where((p >= 0).reshape(mask_shape), gathered, gathered.new_zeros(()))


def _state_backbone(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor):
    """The SSM / hybrid layers over a whole sequence: (x, (hs, convs, ks,
    vs)), the per-layer final states and the per-site prompt K/V."""
    gs = cfg.shared_attn_every if cfg.arch_type == "hybrid" else cfg.num_layers
    hs, convs, ks, vs = [], [], [], []
    for i in range(cfg.num_layers):
        x, (h, conv) = M.mamba_block(cfg, _layer(params, i), x)
        hs.append(h)
        convs.append(conv)
        if cfg.arch_type == "hybrid" and (i + 1) % gs == 0:
            x, (k, v) = _attn_prefill(cfg, params["shared_attn"], x, positions)
            ks.append(k)
            vs.append(v)
    return x, (hs, convs, ks, vs)


def _kv_to_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, s: int,
                 max_seq: int) -> dict:
    """Stacked prompt K/V (n, B, s, nkv, hd) as a dense cache's entries,
    quantized when the cache is int8."""
    cache_seq = kv_cache_seq(cfg, max_seq)
    cache = {}
    if cfg.kv_cache_dtype == "int8":
        (k, ks_), (v, vs_) = L.quantize_kv(k), L.quantize_kv(v)
        cache["k_scale"] = _to_cache_layout(cfg, ks_, -2, s, cache_seq)
        cache["v_scale"] = _to_cache_layout(cfg, vs_, -2, s, cache_seq)
    cache["k"] = _to_cache_layout(cfg, k, -3, s, cache_seq)
    cache["v"] = _to_cache_layout(cfg, v, -3, s, cache_seq)
    return cache


def forward_prefill(cfg: ModelConfig, params: dict, inputs: torch.Tensor, max_seq: int):
    """Process the prompt and return (logits (B, S, V), filled cache), the
    cache as ``init_decode_cache`` lays it out (sized to ``max_seq``;
    prompt K/V occupy its first S columns, or the ring's), in the
    activations' type: the caller casts it into its own cache, or decodes
    on it as it is (as the JAX package does)."""
    _check_family(cfg, "forward_prefill")
    x = _embed(cfg, params, inputs)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    if cfg.arch_type in _ATTN_FAMILIES:
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = _attn_prefill(cfg, _block(params, i), x, positions)
            ks.append(k)
            vs.append(v)
        cache = _kv_to_cache(cfg, torch.stack(ks), torch.stack(vs), s, max_seq)
        return _unembed(cfg, params, x), cache
    x, (hs, convs, ks, vs) = _state_backbone(cfg, params, x, positions)
    cache = {"ssm_h": torch.stack(hs), "ssm_conv": torch.stack(convs)}
    if cfg.arch_type == "hybrid":
        cache.update(_kv_to_cache(cfg, torch.stack(ks), torch.stack(vs), s, max_seq))
    return _unembed(cfg, params, x), cache
