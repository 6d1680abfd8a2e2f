"""Model runners: the step functions one AR engine executes.

PagedRunner (dense / moe / vlm / audio stages, and the interleaved
attention / Mamba1 / MoE layers of Jamba, ``cfg.interleaved``):
  - ``prefill_chunk``: process C prompt tokens of ONE request, writing their
    K/V into the request's pages and attending over all its history pages
    (chunked prefill, Sarathi-style); a Mamba layer carries the request's
    slot state from the chunk before (zeroed at the prompt's first chunk);
    on the card one CUDA graph of the whole chunk, replayed.
  - ``decode``: batched one-token step for ALL active slots against the
    shared page pool (vLLM-style paged attention, the CUDA kernel on the
    card) and, for Mamba layers, the slots' states (the scan's CUDA
    kernel); on the card one CUDA graph of the whole step, replayed.
  Paged KV exists for the attention layers only; beside it each Mamba
  layer keeps one recurrent state per slot (h in f32, the conv window in
  the model dtype, as ``models/mamba.py: init_mamba_state``).  What moves
  pages between requests or stages (prefix-cache copies, PD KV hops)
  cannot carry such a state, and refuses a model with Mamba layers.

StateRunner (ssm: Falcon-Mamba; hybrid: Zamba2's Mamba2 layers and its
shared attention block): a constant-size recurrent state per slot (plus
a dense KV cache per shared-attention site of the hybrid), through the
model's ``forward_prefill``/``forward_decode``; every Mamba1 layer's
scan is the CUDA kernel on the card.

``make_runner`` chooses between them; the AR engine reads only what both
state (``chunk_size``, ``whole_prompts``, ``pages_carry_state``) and call
``prefill`` and ``decode``.

The page pools and state caches are updated in place (the JAX package
donates them to its jitted steps instead).  Writes go only to the
positions a request owns: the JAX package routes the rest to page id
``num_pages`` and drops them, or masks inactive slots back; here a
prefill chunk's padding row writes what its last valid row writes, and
a decode batch's inactive slot what its first active slot writes, to
the same place.  A MoE layer routes every row of its input, as the JAX
runner does: a prefill chunk's padding and a decode batch's inactive
slots take expert capacity too, so the same pairs are dropped.  Prefill runs with the f32
activations its f32 embeddings give (f32 arithmetic against bf16
weights, as ``jnp`` promotes them; on the card the weights are read in
place, ``kernels/mixed_gemm.py``); decode runs in the model dtype.
PagedRunner returns final-layer hidden states so stage-transfer functions can
forward them downstream (e.g. Thinker hidden states → Talker);
StateRunner, as in the JAX package, returns none.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import metrics
from repro_torch.engine.kv_cache import (PagedKVConfig, init_kv_pages,
                                         init_kv_scale_pages)
from repro_torch.kernels import build, mamba_scan, mixed_gemm, ops, paged_attention, ref
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.sharding.context import get_context


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


def make_runner(cfg: ModelConfig, params, kv: PagedKVConfig, max_batch: int,
                chunk_size: int):
    """``StateRunner`` for the ssm and hybrid families, ``PagedRunner``
    for the attention families (Jamba's interleaved layers among them)."""
    if cfg.arch_type in T._STATE_FAMILIES:
        return StateRunner(cfg, params, kv, max_batch)
    if cfg.arch_type in T._ATTN_FAMILIES:
        return PagedRunner(cfg, params, kv, max_batch, chunk_size)
    raise NotImplementedError(f"no runner serves the {cfg.arch_type!r} family")


def embed(params, tokens, slots=None, batch: int = 0, extra=None, dtype=None):
    """Without ``slots``: ``tokens``'s embeddings as a host f32 array (bf16
    widens exactly).  With them: a decode step's (batch, 1, d) input in
    ``dtype`` on the device, row ``slots[i]`` holding ``tokens[i]``'s
    embedding plus ``extra[i]`` (an ``extra_embed``) in f32, every other
    row zero (a MoE layer routes inactive rows too), read back by nothing."""
    table, dev = params["embed"], params["embed"].device
    if slots is None:
        idx = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        return metrics.to_cpu(table[idx].float()).numpy()

    def upload(a):      # to the card from pinned memory, without waiting
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    n, extra = len(tokens), extra or {}
    idx = upload(np.array([*tokens, *slots, *extra], np.int64))
    rows = table[idx[:n]].float()
    if extra:
        rows[idx[2 * n:]] += upload(np.stack([np.asarray(e, np.float32)
                                              for e in extra.values()]))
    out = torch.zeros((batch, 1, table.shape[1]), dtype=torch.float32, device=dev)
    out[idx[n:2 * n], 0] = rows
    return out.to(dtype)


class PagedRunner:
    """Paged-KV execution for attention architectures, and for interleaved
    attention and Mamba1 layers with a recurrent state per slot beside the
    pages (``max_batch`` slots: the decode batch's rows)."""

    whole_prompts = False

    def __init__(self, cfg: ModelConfig, params, kv: PagedKVConfig, max_batch: int = 0,
                 chunk_size: int = 64):
        self.cfg = cfg
        self.params = params
        self.kv = kv
        self.chunk_size = chunk_size
        self.device = params["lm_head"].device
        self.quant = cfg.kv_cache_dtype == "int8"
        # each layer's index into its kind's pools (KV pages, Mamba states)
        self._pool = [sum(k == kind for k in cfg.layer_layout[:i])
                      for i, kind in enumerate(cfg.layer_layout)]
        n_attn = cfg.layer_layout.count("A")
        self.k_pages, self.v_pages = init_kv_pages(cfg, kv, n_attn, self.device)
        if self.quant:
            self.k_scales, self.v_scales = init_kv_scale_pages(cfg, kv, n_attn, self.device)
        else:
            self.k_scales = self.v_scales = None
        self.ssm_h = self.ssm_conv = None
        if cfg.has_mamba:
            if max_batch < 1:
                raise ValueError(f"{cfg.name}: a Mamba layer keeps a state per slot, "
                                 f"so PagedRunner needs max_batch")
            h, conv = M.init_mamba_state(cfg, max_batch, self.device)
            n = cfg.layer_layout.count("M")
            self.ssm_h = h.new_zeros((n, *h.shape))
            self.ssm_conv = conv.new_zeros((n, *conv.shape))
        self.pages_carry_state = self.ssm_h is None     # no Mamba state beside them
        self._layers = T.layer_views(cfg, params)
        self._window = cfg.sliding_window if cfg.attn_variant == "swa" else 0
        self._graph = None          # the decode step's _StepGraph, on a CUDA runner
        self._prefill_graph = None  # the prefill chunk's, at the bucket shape
        if self.device.type == "cuda" and ops.get_backend() != "ref":
            # the kernels the steps launch, built together (one nvcc each)
            # rather than one after another at their first launches
            build.build(["paged_attention"]
                        + (["mixed_gemm"] if cfg.dtype == "bfloat16" else [])
                        + (["mamba_scan"] if cfg.has_mamba else []))

    def _refuse_state(self, what: str) -> None:
        if not self.pages_carry_state:
            raise ValueError(f"{what} moves KV pages, which cannot carry the recurrent "
                             f"state of {self.cfg.name}'s Mamba layers")

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
    def prefill(self, embeds, slot, block_table, start):
        """``prefill_chunk`` of n = embeds.shape[1] rows padded to
        ``chunk_size``, as the JAX engine pads them (the padding takes MoE
        capacity; its K/V writes repeat the last valid row's); (logits,
        hidden) of the n rows."""
        n = embeds.shape[1]
        padded = torch.nn.functional.pad(embeds, (0, 0, 0, max(0, self.chunk_size - n)))
        logits, hidden = self.prefill_chunk(padded, block_table, start, n, slot=slot)
        return logits[:n], hidden[:n]

    @torch.no_grad()
    def prefill_chunk(self, embeds, block_table, start, valid_len, slot=None):
        """embeds: (1, C, d); block_table: (pp,); start, valid_len: ints,
        1 <= valid_len <= C; ``slot``: the request's batch slot, which a
        model with Mamba layers needs: the chunk's valid rows scan on from
        the slot's state (a zero state at start 0, a prompt's first chunk
        or a preempted request's recompute) and leave it for the next
        chunk or decode.  Returns (logits (C, V), hidden (C, d)) on the
        runner's device.

        On a CUDA runner a chunk of the bucket shape (``chunk_size`` f32
        rows, a table of ``max_pages_per_seq`` pages) is one CUDA graph of
        ``_prefill_body`` (see ``_StepGraph``), replayed on the caller's
        current stream: the returned tensors are then the graph's own
        outputs, which the next such call overwrites.  The body runs
        eagerly on the CPU, under a ``DistContext``, with the plain
        attention (backend "ref") and for other shapes or types
        (speculative verification's buckets in the model dtype).  The
        call notes ``prefill_graph_replays``, ``prefill_graph_captures``
        or ``prefill_eager``."""
        cfg = self.cfg
        embeds = torch.as_tensor(embeds)
        start, valid_len = int(start), int(valid_len)
        if not 1 <= valid_len <= embeds.shape[1]:
            # every padding row repeats the last valid row's K/V write
            raise ValueError(f"a prefill chunk of {embeds.shape[1]} rows with "
                             f"{valid_len} valid")
        if self.ssm_h is not None:
            if slot is None:
                raise ValueError(f"{cfg.name}: a prefill chunk needs its request's slot")
            metrics.note(**{"mamba_resets" if start == 0 else "mamba_carries": 1})
        ints = (np.asarray(block_table, np.int32), np.int32(start), np.int32(valid_len),
                np.int32(slot or 0))
        if self._graphs() and embeds.dtype == torch.float32 \
                and embeds.shape == (1, self.chunk_size, cfg.d_model) \
                and ints[0].shape == (self.kv.max_pages_per_seq,):
            return self._run_graph("_prefill_graph", self._prefill_body, embeds, ints,
                                   "prefill_graph")[0]
        metrics.note(prefill_eager=1)
        return self._prefill_body(embeds.to(self.device), *_device_ints(ints, self.device))

    def _prefill_body(self, h, table, start, valid, slot):
        """A prefill chunk on device tensors: h (1, C, d); table (pp,)
        int32; start, valid and slot 0-d int32.  Its device work depends on
        (C, pp) alone and nothing in it reads the device from the host, so
        one CUDA graph can hold it.  Every row is computed; the rows from
        ``valid`` on are padding.  A padding row writes the last valid
        row's K/V to that row's place, so duplicate writes carry equal
        values and no page the request does not own is touched (the JAX
        package sends those rows to page ``num_pages`` and drops them); a
        Mamba layer carries its state over the padding unchanged and
        gives it nothing (``_prefill_mamba``), so every row of the
        residual stream is what the valid rows alone leave.  Returns
        (logits (C, V), hidden (C, d))."""
        cfg = self.cfg
        page = self.kv.page_size
        start, valid = start.long(), valid.long()
        rows = torch.arange(h.shape[1], device=h.device)
        positions = (start + rows)[None]                        # (1, C)
        src = torch.minimum(rows, valid - 1)                    # padding: the last valid row
        written = start + src
        bt = table.long()
        pid, wslot = bt[written // page], written % page
        nkv, hd = cfg.num_kv_heads, cfg.head_dim
        for i, lp in enumerate(self._layers):
            hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
            j = self._pool[i]
            if "mamba" in lp:
                h = h + self._prefill_mamba(j, lp["mamba"], hn, slot, start, valid)
            else:
                q, k, v = L._qkv(cfg, lp["attn"], hn)
                if cfg.rope_theta:
                    q = L.rope(q, positions, cfg.rope_theta)
                    k = L.rope(k, positions, cfg.rope_theta)
                self._write_kv(j, k[0, src], v[0, src], pid, wslot)
                kp, vp, ksp, vsp = self._layer_pools(j)
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

    def _prefill_mamba(self, j: int, p: dict, hn, slot, start, valid):
        """Mamba layer j over a chunk, from ``slot``'s state (a zero state
        at start 0), which its valid rows then leave there: the padding
        rows' dt is 0, which carries the state over them unchanged, and
        they get nothing."""
        hs, cs = self.ssm_h[j], self.ssm_conv[j]
        slot = slot.long()[None]
        carry = torch.as_tensor(start > 0, device=hn.device)
        state = (torch.where(carry, hs[slot], 0.0),
                 torch.where(carry, cs[slot], 0).to(hn.dtype))
        y, (h_last, conv) = M.mamba1_forward(self.cfg, p, hn, state, valid=valid)
        hs.index_copy_(0, slot, h_last)
        cs.index_copy_(0, slot, conv.to(cs.dtype))
        rows = torch.arange(hn.shape[1], device=hn.device)
        return torch.where((rows < valid)[:, None], y, 0.0)

    # ---- prefix cache: copy-on-write page copies -------------------------
    @torch.no_grad()
    def copy_pages(self, src_pages, dst_pages) -> None:
        """Copy whole KV pages across all layers (copy-on-write: a request
        extending a shared cached page gets a private copy first), in
        place in the pools."""
        self._refuse_state("a prefix-cache copy-on-write page copy")
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
        self._refuse_state("extract_kv (a PD KV hop)")
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
        self._refuse_state("inject_kv (a PD KV hop)")
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
        positions: (B,) current token's write position; active: (B,) bool,
        at least one row true (host arrays).  Returns (logits (B, V),
        hidden (B, d)) on the runner's device.

        On a CUDA runner the step is one CUDA graph of ``_decode_body``
        (see ``_StepGraph``), replayed on the caller's current stream:
        the returned tensors are then the graph's own outputs, which the
        next call overwrites.  The body runs eagerly on the CPU, under a
        ``DistContext`` (expert parallelism's collectives are not
        captured) and with the plain attention (backend "ref").  Either
        way a MoE step keeps its ``routed_experts`` on its ``model.decode``
        span (``metrics.keep``)."""
        ints = (np.asarray(block_tables, np.int32), np.asarray(positions, np.int32),
                np.asarray(active, bool).astype(np.int32))
        embeds = torch.as_tensor(embeds)
        if not ints[2].any():
            # every inactive row repeats an active row's K/V write
            raise ValueError("a decode batch needs an active row")
        if self._graphs():
            (logits, hidden, routed), replayed = self._run_graph(
                "_graph", self._decode_body, embeds, ints, "graph")
        else:
            logits, hidden, routed = self._decode_body(embeds.to(self.device),
                                                       *_device_ints(ints, self.device))
            replayed = False
        if routed is not None and metrics.keeping():
            metrics.keep(routed_experts=routed.clone() if replayed else routed)
        return logits, hidden

    def _decode_body(self, h, tables, positions, active):
        """The batched decode step on device tensors: h (B, 1, d); tables
        (B, pp) int32; positions (B,) int32; active (B,) bool or 0/1, at
        least one row active.  Its device work depends on (B, pp) alone and
        nothing in it reads the device from the host, so one CUDA graph can
        hold it.  Every row is computed and writes its K/V: an inactive row
        writes the first active row's K/V to that row's slot, so duplicate
        writes carry equal values and every write lands where an active
        row's does (the JAX package sends those rows to page ``num_pages``
        and drops them).  A Mamba layer's state is written back for the
        active rows only: an inactive row's slot may hold a prompt that is
        still being prefilled, chunk by chunk.  Returns (logits (B, V),
        hidden (B, d), ``_routed_experts`` of the MoE layers' routes)."""
        cfg = self.cfg
        page = self.kv.page_size
        live = active.bool()
        pos = positions.long()
        seq_lens = torch.where(live, positions + 1, 0).to(torch.int32)
        first = torch.argmax(live.to(torch.int32))
        src = torch.where(live, torch.arange(h.shape[0], device=h.device), first)
        wpos = pos[src]
        pid = tables[src, wpos // page].long()
        slot = wpos % page
        pos_col = pos[:, None]                                  # (B, 1)
        routes = [] if cfg.is_moe else None
        for i, lp in enumerate(self._layers):
            hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
            j = self._pool[i]
            if "mamba" in lp:
                h = h + self._decode_mamba(j, lp["mamba"], hn, live)
            else:
                q, k, v = L._qkv(cfg, lp["attn"], hn)
                if cfg.rope_theta:
                    q = L.rope(q, pos_col, cfg.rope_theta)
                    k = L.rope(k, pos_col, cfg.rope_theta)
                self._write_kv(j, k[src, 0], v[src, 0], pid, slot)
                kp, vp, ksp, vsp = self._layer_pools(j)
                o = ops.paged_attention(q[:, 0], kp, vp, tables, seq_lens,
                                        window=self._window, k_scale_pages=ksp,
                                        v_scale_pages=vsp)
                h = h + L.unproject(o.to(h.dtype), lp["attn"]["wo"])[:, None]
            hn = L.rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps)
            h = h + L.mlp_or_moe(cfg, lp, hn, routes)
        logits = T._unembed(cfg, self.params, h)[:, 0]
        return logits, h[:, 0], self._routed_experts(routes, live)

    def _decode_mamba(self, j: int, p: dict, hn, live):
        """Mamba layer j's one step for every row, from and into the slots'
        states; an inactive row's state is written back as it was."""
        hs, cs = self.ssm_h[j], self.ssm_conv[j]
        y, (h_new, conv) = M.mamba1_forward(self.cfg, p, hn, (hs, cs))
        keep = live[:, None, None]
        hs.copy_(torch.where(keep, h_new, hs))
        cs.copy_(torch.where(keep, conv, cs))
        return y

    def _routed_experts(self, routes, live):
        """The distinct experts held here that the active rows routed to in
        each MoE layer, (layers,) int64 on the device, from the layers'
        top-k ids (B, k); None without routes (a dense model, expert
        parallelism)."""
        if not routes:
            return None
        e = self.cfg.num_experts
        ids, mine = torch.stack(routes), live[None, :, None]             # (layers, B, k)
        if self.cfg.router_experts:         # a share of the experts: the held ones
            ids = ids - self.cfg.expert_offset
            mine = mine & (ids >= 0) & (ids < e)
        ids = torch.where(mine, ids, e)
        hit = torch.zeros((ids.shape[0], e + 1), dtype=torch.bool, device=ids.device)
        return hit.scatter_(1, ids.flatten(1), True)[:, :e].sum(1)

    def _graphs(self) -> bool:
        """Whether the steps run as CUDA graphs: on the card, with the
        kernels (not backend "ref") and outside a ``DistContext``, whose
        collectives are not captured."""
        return self.device.type == "cuda" and ops.get_backend() != "ref" \
            and get_context() is None

    def _run_graph(self, name: str, body, embeds, ints, note: str):
        """``body`` by the CUDA graph this runner holds as ``name``:
        captured after one eager run at the first call, and again whenever
        what the capture baked in changes (the shapes, the pools, the
        Mamba states, ``models/moe.py: drop_counter``); replayed at every
        other call.  Notes ``<note>_captures`` or ``<note>_replays``.
        Returns (the body's outputs, whether they are the graph's)."""
        baked = (self.k_pages, self.v_pages, self.k_scales, self.v_scales, self.ssm_h,
                 self.ssm_conv, moe.drop_counter)
        g = getattr(self, name)
        if g is not None and g.fits(embeds, ints, baked):
            out = g.replay(embeds, ints)
            metrics.note(**{f"{note}_replays": 1})
            return out, True
        setattr(self, name, None)           # the old graph's memory goes first
        g = _StepGraph(self.device, embeds, ints, baked)
        g.load(embeds, ints)
        out = body(g.embeds, *g.inputs)
        metrics.note(**{f"{note}_captures": 1})
        g.capture(body)
        setattr(self, name, g)
        return out, False


def _pack(ints) -> np.ndarray:
    """The host integer arrays ``ints`` one after another in one int32 vector."""
    return np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in ints])


def _device_ints(ints, device) -> list:
    """The host integer arrays ``ints`` as int32 tensors on ``device``,
    views of one vector copied in one go."""
    return _unpack(torch.as_tensor(_pack(ints), device=device), ints)


def _unpack(packed: torch.Tensor, ints) -> list:
    """Views of ``packed`` shaped as the arrays ``ints``, one after another."""
    out, at = [], 0
    for a in ints:
        n = int(np.size(a))
        out.append(packed[at:at + n].view(np.shape(a)))
        at += n
    return out


#: one capture at a time in a process: ``torch.cuda.graph`` empties the
#: allocator's cache as it starts, which must not meet another thread's
#: capture (the PD graph runs two engine threads on one card)
_capture_lock = threading.Lock()


@functools.cache
def _libcuda() -> ctypes.PyDLL:
    """The CUDA driver, its calls made with the interpreter lock held."""
    lib = ctypes.PyDLL("libcuda.so.1")
    lib.cuGraphLaunch.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    lib.cuGraphLaunch.restype = ctypes.c_int
    return lib


class _StepGraph:
    """A step body of ``PagedRunner`` (``_decode_body``, ``_prefill_body``)
    captured as one CUDA graph: the static buffers its kernels read (the
    embeddings, and its integer inputs packed in one int32 vector, filled
    from pinned host memory) and write (``outputs``); the wrapper calls of
    the paged-attention, scan and f32 x bf16 product kernels it holds
    (``launches``, ``scan_launches``, ``gemm_launches``) and the counts
    its capture noted (``notes``: the products' weight bytes), which each
    replay counts and notes again; the ``shapes`` it was captured at and
    the tensors it ``baked`` in."""

    def __init__(self, device, embeds, ints, baked):
        self.shapes, self.baked = _shapes(embeds, ints), baked
        n = sum(int(np.size(a)) for a in ints)
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.packed = torch.empty(n, dtype=torch.int32, device=device)
        self.inputs = _unpack(self.packed, ints)
        self.embeds = torch.empty(embeds.shape, dtype=embeds.dtype, device=device)
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None
        self.launches = self.scan_launches = self.gemm_launches = 0
        self.notes: dict = {}

    def fits(self, embeds, ints, baked) -> bool:
        """Whether a call with these inputs, and these tensors to bake in,
        can replay this graph."""
        return self.shapes == _shapes(embeds, ints) \
            and all(a is b for a, b in zip(self.baked, baked))

    def load(self, embeds, ints) -> None:
        """Copy one call's inputs into the static buffers, on the current
        stream, without waiting for the device."""
        self.copied.synchronize()           # the last call's copy has read the host buffer
        self.host.numpy()[:] = _pack(ints)
        self.packed.copy_(self.host, non_blocking=True)
        self.copied.record()
        self.embeds.copy_(embeds)

    def launch(self) -> None:
        """``graph.replay()``, with the interpreter lock held through the
        launch (``cuGraphLaunch`` called through ``ctypes.PyDLL``).  A
        ``torch.profiler`` stopping on another thread holds that lock while
        CUPTI flushes, and a graph launched beside the flush deadlocks both
        threads (H100, torch 2.11: two of five profiled runs of the MoE
        cell hung there); holding the lock puts the one after the other.
        The bodies draw no random numbers, so the launch needs none of
        ``replay``'s generator bookkeeping."""
        rc = _libcuda().cuGraphLaunch(self.graph.raw_cuda_graph_exec(),
                                      torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cuGraphLaunch failed: CUresult {rc}")

    def capture(self, body) -> None:
        with _capture_lock, paged_attention.launches.held() as held, \
                mamba_scan.launches.held() as scans, mixed_gemm.launches.held() as gemms, \
                metrics.held() as notes, \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = body(self.embeds, *self.inputs)
        self.launches, self.scan_launches, self.gemm_launches = held[0], scans[0], gemms[0]
        self.notes = notes

    def replay(self, embeds, ints):
        """Load the inputs, launch, and count what the capture held; the
        outputs are the graph's own, which the next replay overwrites."""
        self.load(embeds, ints)
        self.launch()
        for counter, n in ((paged_attention.launches, self.launches),
                           (mamba_scan.launches, self.scan_launches),
                           (mixed_gemm.launches, self.gemm_launches)):
            if n:
                counter.add(n)
        if self.notes:
            metrics.note(**self.notes)
        return self.outputs


def _shapes(embeds, ints) -> tuple:
    return tuple(embeds.shape), embeds.dtype, tuple(np.shape(a) for a in ints)


class StateRunner:
    """Recurrent-state execution for the ssm (Falcon-Mamba) and hybrid
    (Zamba2: Mamba2 layers and one shared attention block) families; a
    model of interleaved attention and Mamba1 layers (Jamba) is
    PagedRunner's.

    Slots share batched state tensors; prefill is one scan per request
    (an SSM prefill has no chunking: the scan IS the prefill) whose
    batch-1 cache is cast into the slot, and decode is a batched
    one-token step that leaves inactive slots' state and KV untouched.
    """

    whole_prompts = True        # one scan (JAX would restart a split prompt's state)
    pages_carry_state = False   # no pages: the engine shares and ships none

    def __init__(self, cfg: ModelConfig, params, kv: PagedKVConfig, max_batch: int):
        self.cfg = cfg
        self.params = params
        self.kv = kv
        self.max_batch = max_batch
        self.chunk_size = kv.max_seq
        self.device = params["lm_head"].device
        self.cache = T.init_decode_cache(cfg, max_batch, kv.max_seq, self.device)

    def _refuse_state(self, what: str) -> None:
        """Nothing to refuse: no page of this runner's moves."""

    @torch.no_grad()
    def prefill(self, embeds: torch.Tensor, slot: int, block_table=None, start: int = 0):
        """embeds: (1, S, d), the whole prompt (``block_table`` and
        ``start`` are the paged runner's).  Fills ``slot``'s state (and KV)
        and returns (logits (S, V), None)."""
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
        logits, _ = T.forward_decode(self.cfg.replace(modality="audio_frames"), self.params,
                                     self.cache, embeds, pos, rows)
        return logits[:, 0], None


# ---- embed-level wrappers around transformer.py (prompts may be embeds) ----

def _prefill_from_embeds(cfg, params, embeds, max_seq):
    """transformer.forward_prefill starting from embeddings (the inputs
    are treated as precomputed frames, which _embed passes through)."""
    return T.forward_prefill(cfg.replace(modality="audio_frames"), params, embeds, max_seq)
