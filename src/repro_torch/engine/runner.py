"""Model runners: the step functions one AR engine executes.

PagedRunner (dense / moe / vlm / audio stages):
  - ``prefill_chunk``: process C prompt tokens of ONE request, writing their
    K/V into the request's pages and attending over all its history pages
    (chunked prefill, Sarathi-style).
  - ``decode``: batched one-token step for ALL active slots against the
    shared page pool (vLLM-style paged attention, the CUDA kernel on the
    card).

StateRunner (ssm / hybrid stages): a constant-size recurrent state per
slot (plus a dense KV cache per shared-attention site of the hybrid),
through the model's ``forward_prefill``/``forward_decode``; every Mamba1
layer's scan is the CUDA kernel on the card.

The page pools and state caches are updated in place (the JAX package
donates them to its jitted steps instead).  Writes go only to the
positions a request owns: the JAX package routes the rest to page id
``num_pages`` and drops them, or masks inactive slots back; here they are
never issued.  A MoE layer routes every row of its input, as the JAX
runner does: a prefill chunk's padding and a decode batch's inactive
slots take expert capacity too, so the same pairs are dropped.  Prefill
runs with the f32 activations its f32 embeddings
give (bf16 weights are promoted, as ``jnp`` promotes them); decode runs
in the model dtype.  PagedRunner returns final-layer hidden states so
stage-transfer functions can forward them downstream (e.g. Thinker
hidden states → Talker); StateRunner, as in the JAX package, returns
none.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import metrics
from repro_torch.engine.kv_cache import (PagedKVConfig, init_kv_pages,
                                         init_kv_scale_pages)
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (bf16 widens to f32: numpy has no bf16)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return metrics.to_cpu(t.detach(), copy=True).numpy()


def kv_to_host(t: torch.Tensor) -> tuple:
    """(numpy copy, dtype tag) of KV pages: bf16 crosses as its 16-bit
    pattern (an int16 array tagged ``"bfloat16"``), as ``convert.py``
    carries bf16 weights; other types as themselves, tagged with their
    name.  The JAX package ships ``ml_dtypes`` bf16 arrays instead."""
    if t.dtype == torch.bfloat16:
        return metrics.to_cpu(t.detach().view(torch.int16), copy=True).numpy(), "bfloat16"
    host = metrics.to_cpu(t.detach(), copy=True).numpy()
    return host, host.dtype.name


def kv_from_host(a: np.ndarray, kv_dtype: str | None, device) -> torch.Tensor:
    """A tensor on ``device`` from ``kv_to_host``'s array and tag (a copy:
    connector payloads are read-only views of their buffers)."""
    t = torch.tensor(np.asarray(a), device=device)
    return t.view(torch.bfloat16) if kv_dtype == "bfloat16" else t


class PagedRunner:
    """Paged-KV execution for attention architectures."""

    def __init__(self, cfg: ModelConfig, params, kv: PagedKVConfig):
        if cfg.arch_type not in ("dense", "moe", "vlm", "audio"):
            raise NotImplementedError(
                f"PagedRunner serves attention families, not {cfg.arch_type!r}")
        self.cfg = cfg
        self.params = params
        self.kv = kv
        self.device = params["lm_head"].device
        self.quant = cfg.kv_cache_dtype == "int8"
        self.k_pages, self.v_pages = init_kv_pages(cfg, kv, cfg.num_layers, self.device)
        if self.quant:
            self.k_scales, self.v_scales = init_kv_scale_pages(
                cfg, kv, cfg.num_layers, self.device)
        else:
            self.k_scales = self.v_scales = None
        # per-layer views of the stacked block parameters
        blocks = params["blocks"]
        self._layers = [L.tree_map(lambda a, i=i: a[i], blocks)
                        for i in range(cfg.num_layers)]
        self._window = cfg.sliding_window if cfg.attn_variant == "swa" else 0

    # ---- embeds ---------------------------------------------------------
    def embed(self, tokens: np.ndarray) -> np.ndarray:
        """Token embeddings as a host f32 array (the gather runs where the
        table lives; widening bf16 rows to f32 is exact)."""
        idx = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        return metrics.to_cpu(self.params["embed"][idx].float()).numpy()

    def _layer_pools(self, i: int):
        if self.quant:
            return (self.k_pages[i], self.v_pages[i], self.k_scales[i],
                    self.v_scales[i])
        return self.k_pages[i], self.v_pages[i], None, None

    def _write_kv(self, i: int, k: torch.Tensor, v: torch.Tensor,
                  pid: torch.Tensor, slot: torch.Tensor) -> None:
        """Write rows k, v (N, nkv, hd) of layer i at (page, slot)."""
        kp, vp, ksp, vsp = self._layer_pools(i)
        if self.quant:
            kq, ks = L.quantize_kv(k)
            vq, vs = L.quantize_kv(v)
            kp[pid, slot] = kq
            vp[pid, slot] = vq
            ksp[pid, slot] = ks
            vsp[pid, slot] = vs
        else:
            kp[pid, slot] = k.to(kp.dtype)
            vp[pid, slot] = v.to(vp.dtype)

    # ---- prefill chunk ---------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, embeds, block_table, start, valid_len):
        """embeds: (1, C, d); block_table: (pp,); start, valid_len: ints.
        Returns (logits (C, V), hidden (C, d)) on the runner's device."""
        cfg = self.cfg
        page = self.kv.page_size
        h = torch.as_tensor(embeds, device=self.device)
        c = h.shape[1]
        start, valid_len = int(start), int(valid_len)
        bt = torch.as_tensor(np.asarray(block_table), dtype=torch.long,
                             device=self.device)
        pos = start + torch.arange(c, device=self.device)
        positions = pos[None]                                   # (1, C)
        written = pos[:valid_len]                               # padding is not written
        pid, slot = bt[written // page], written % page
        nkv, hd = cfg.num_kv_heads, cfg.head_dim
        for i, lp in enumerate(self._layers):
            hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
            q, k, v = L._qkv(cfg, lp["attn"], hn)
            if cfg.rope_theta:
                q = L.rope(q, positions, cfg.rope_theta)
                k = L.rope(k, positions, cfg.rope_theta)
            self._write_kv(i, k[0, :valid_len], v[0, :valid_len], pid, slot)
            kp, vp, ksp, vsp = self._layer_pools(i)
            if self.quant:
                k_all = (kp[bt].float() * ksp[bt][..., None]).to(h.dtype)
                v_all = (vp[bt].float() * vsp[bt][..., None]).to(h.dtype)
            else:
                k_all, v_all = kp[bt], vp[bt]
            k_all = k_all.reshape(1, -1, nkv, hd)
            v_all = v_all.reshape(1, -1, nkv, hd)
            o = ref.chunk_attention(q, k_all, v_all, start, window=self._window)
            h = h + L.unproject(o, lp["attn"]["wo"])
            hn = L.rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps)
            h = h + L.mlp_or_moe(cfg, lp, hn)
        logits = T._unembed(cfg, self.params, h)[0]
        return logits, h[0]

    # ---- prefix cache: copy-on-write page copies -------------------------
    @torch.no_grad()
    def copy_pages(self, src_pages, dst_pages) -> None:
        """Copy whole KV pages across all layers (copy-on-write: a request
        extending a shared cached page gets a private copy first), in
        place in the pools."""
        src = torch.as_tensor(np.asarray(src_pages), dtype=torch.long, device=self.device)
        dst = torch.as_tensor(np.asarray(dst_pages), dtype=torch.long, device=self.device)
        pools = [self.k_pages, self.v_pages]
        if self.quant:
            pools += [self.k_scales, self.v_scales]
        for pool in pools:
            pool[:, dst] = pool[:, src]

    # ---- PD disaggregation: KV extraction / injection -------------------
    @torch.no_grad()
    def extract_kv(self, block_table, n_tokens: int):
        """Pull one request's prompt KV out of the page pool.

        Returns (k, v, kv_dtype): (L, n_pages*page, nkv, hd) host arrays,
        copies and never views of the pool (trailing padding past n_tokens
        holds whatever the pages hold), and their type's tag
        (``kv_to_host``) — the payload a prefill stage ships to a decode
        stage through the unified connector.  A bf16 pool ships its bits;
        a quantized pool ships dequantized f32.  The host copy runs on the
        caller's current stream, which must be the one that wrote the
        pages (the engine's).
        """
        page = self.kv.page_size
        n_pages = -(-n_tokens // page)
        bt = torch.as_tensor(np.asarray(block_table[:n_pages]), dtype=torch.long,
                             device=self.device)
        k = self.k_pages[:, bt]
        v = self.v_pages[:, bt]
        if self.quant:
            k = k.float() * self.k_scales[:, bt][..., None]
            v = v.float() * self.v_scales[:, bt][..., None]
        shape = (self.cfg.num_layers, n_pages * page,
                 self.cfg.num_kv_heads, self.cfg.head_dim)
        (k, tag), (v, _) = kv_to_host(k.reshape(shape)), kv_to_host(v.reshape(shape))
        return k, v, tag

    @torch.no_grad()
    def inject_kv(self, k_seed, v_seed, block_table, n_tokens: int,
                  kv_dtype: str | None = None) -> None:
        """Write transferred prompt KV into this engine's page pool;
        ``kv_dtype`` is ``extract_kv``'s tag (None: the arrays' own type).
        The copy to the device runs on the caller's current stream."""
        page = self.kv.page_size
        n_pages = -(-n_tokens // page)
        k_seed, v_seed = np.asarray(k_seed), np.asarray(v_seed)
        pad = n_pages * page - k_seed.shape[1]
        if pad:
            padw = [(0, 0), (0, pad), (0, 0), (0, 0)]
            k_seed = np.pad(k_seed, padw)
            v_seed = np.pad(v_seed, padw)
        n_layers, _, nkv, hd = k_seed.shape
        shape = (n_layers, n_pages, page, nkv, hd)
        kp = kv_from_host(k_seed.reshape(shape), kv_dtype, self.device)
        vp = kv_from_host(v_seed.reshape(shape), kv_dtype, self.device)
        bt = torch.as_tensor(np.asarray(block_table[:n_pages]), dtype=torch.long,
                             device=self.device)
        if self.quant:
            kq, ks = L.quantize_kv(kp)
            vq, vs = L.quantize_kv(vp)
            self.k_pages[:, bt] = kq
            self.v_pages[:, bt] = vq
            self.k_scales[:, bt] = ks
            self.v_scales[:, bt] = vs
        else:
            self.k_pages[:, bt] = kp.to(self.k_pages.dtype)
            self.v_pages[:, bt] = vp.to(self.v_pages.dtype)

    # ---- batched decode ---------------------------------------------------
    @torch.no_grad()
    def decode(self, embeds, block_tables, positions, active):
        """embeds: (B, 1, d) in the model dtype; block_tables: (B, pp);
        positions: (B,) current token's write position; active: (B,) bool
        (host arrays).  Returns (logits (B, V), hidden (B, d)) on the
        runner's device."""
        cfg = self.cfg
        page = self.kv.page_size
        dev = self.device
        positions = np.asarray(positions, np.int64)
        active = np.asarray(active, bool)
        tables = np.asarray(block_tables, np.int32)
        rows = np.nonzero(active)[0]
        pid = torch.as_tensor(tables[rows, positions[rows] // page].astype(np.int64),
                              device=dev)
        slot = torch.as_tensor(positions[rows] % page, device=dev)
        rows_t = torch.as_tensor(rows, device=dev)
        seq_lens = torch.as_tensor(np.where(active, positions + 1, 0).astype(np.int32),
                                   device=dev)
        bt = torch.as_tensor(tables, device=dev)
        pos_t = torch.as_tensor(positions, device=dev)[:, None]  # (B, 1)
        h = torch.as_tensor(embeds, device=dev)
        # host time of each half of the layers (enqueueing their kernels),
        # noted on the engine step's model.decode phase
        attn_s = ffn_s = 0.0
        t_ffn = time.perf_counter()
        for i, lp in enumerate(self._layers):
            hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
            q, k, v = L._qkv(cfg, lp["attn"], hn)
            if cfg.rope_theta:
                q = L.rope(q, pos_t, cfg.rope_theta)
                k = L.rope(k, pos_t, cfg.rope_theta)
            self._write_kv(i, k[rows_t, 0], v[rows_t, 0], pid, slot)
            kp, vp, ksp, vsp = self._layer_pools(i)
            o = ops.paged_attention(q[:, 0], kp, vp, bt, seq_lens,
                                    window=self._window, k_scale_pages=ksp,
                                    v_scale_pages=vsp)
            h = h + L.unproject(o.to(h.dtype), lp["attn"]["wo"])[:, None]
            t_attn = time.perf_counter()
            attn_s += t_attn - t_ffn
            hn = L.rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps)
            h = h + L.mlp_or_moe(cfg, lp, hn)
            t_ffn = time.perf_counter()
            ffn_s += t_ffn - t_attn
        metrics.note(attn_host_s=attn_s, ffn_host_s=ffn_s)
        logits = T._unembed(cfg, self.params, h)[:, 0]
        return logits, h[:, 0]


class StateRunner:
    """Recurrent-state execution for SSM / hybrid architectures.

    Slots share batched state tensors; prefill is one scan per request
    (an SSM prefill has no chunking: the scan IS the prefill) whose
    batch-1 cache is cast into the slot, and decode is a batched
    one-token step that leaves inactive slots' state and KV untouched.
    """

    def __init__(self, cfg: ModelConfig, params, kv: PagedKVConfig, max_batch: int):
        if cfg.arch_type not in ("ssm", "hybrid"):
            raise ValueError(f"StateRunner serves ssm and hybrid models, not {cfg.arch_type}")
        self.cfg = cfg
        self.params = params
        self.kv = kv
        self.max_batch = max_batch
        self.device = params["lm_head"].device
        self.cache = T.init_decode_cache(cfg, max_batch, kv.max_seq, self.device)

    def embed(self, tokens: np.ndarray) -> np.ndarray:
        """Token embeddings as a host f32 array."""
        idx = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        return metrics.to_cpu(self.params["embed"][idx].float()).numpy()

    @torch.no_grad()
    def prefill(self, embeds: torch.Tensor, slot: int):
        """embeds: (1, S, d), the whole prompt.  Fills ``slot``'s state
        (and KV) and returns (logits (S, V), None)."""
        logits, cache1 = _prefill_from_embeds(self.cfg, self.params, embeds,
                                              self.kv.max_seq)
        for name, c in self.cache.items():
            c[:, slot] = cache1[name][:, 0]     # cast to the cache's dtype, as .at[].set does
        return logits[0], None

    @torch.no_grad()
    def decode(self, embeds, block_tables, positions, active):
        """embeds: (B, 1, d) in the model dtype; positions: (B,) current
        token's position; active: (B,) bool (host arrays; block_tables is
        unused).  Returns (logits (B, V), None)."""
        rows = torch.as_tensor(np.nonzero(np.asarray(active, bool))[0], device=self.device)
        pos = torch.as_tensor(np.asarray(positions, np.int64), device=self.device)
        logits, _ = _decode_from_embeds(self.cfg, self.params, self.cache, embeds, pos, rows)
        return logits[:, 0], None


# ---- embed-level wrappers around transformer.py (prompts may be embeds) ----

def _prefill_from_embeds(cfg, params, embeds, max_seq):
    """transformer.forward_prefill starting from embeddings (the inputs
    are treated as precomputed frames, which _embed passes through)."""
    return T.forward_prefill(cfg.replace(modality="audio_frames"), params, embeds, max_seq)


def _decode_from_embeds(cfg, params, cache, embeds, positions, rows=None):
    return T.forward_decode(cfg.replace(modality="audio_frames"), params, cache, embeds,
                            positions, rows)
