"""Model runners: the step functions one AR engine executes.

PagedRunner (dense / moe / vlm / audio stages, and the interleaved
attention / Mamba1 / MoE layers of Jamba, ``cfg.interleaved``):
  - ``prefill_chunk``: process C prompt tokens of ONE request, writing their
    K/V into the request's pages and attending over all its history pages
    (chunked prefill, Sarathi-style); a Mamba layer carries the request's
    slot state from the chunk before (zeroed at the prompt's first chunk).
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

The page pools and state caches are updated in place (the JAX package
donates them to its jitted steps instead).  Writes go only to the
positions a request owns: the JAX package routes the rest to page id
``num_pages`` and drops them, or masks inactive slots back; here a
prefill chunk's padding is never written, and a decode batch's inactive
slot writes what its first active slot writes, to the same place.  A
MoE layer routes every row of its input, as the JAX runner does: a
prefill chunk's padding and a decode batch's inactive slots take expert
capacity too, so the same pairs are dropped.  Prefill runs with the f32
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
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import metrics
from repro_torch.engine.kv_cache import (PagedKVConfig, init_kv_pages,
                                         init_kv_scale_pages)
from repro_torch.kernels import build, mamba_scan, ops, paged_attention, ref
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


class PagedRunner:
    """Paged-KV execution for attention architectures, and for interleaved
    attention and Mamba1 layers with a recurrent state per slot beside the
    pages (``max_batch`` slots: the decode batch's rows)."""

    def __init__(self, cfg: ModelConfig, params, kv: PagedKVConfig, max_batch: int = 0):
        if cfg.arch_type not in ("dense", "moe", "vlm", "audio"):
            raise NotImplementedError(
                f"PagedRunner serves attention families, not {cfg.arch_type!r}")
        self.cfg = cfg
        self.params = params
        self.kv = kv
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
        self._layers = T.layer_views(cfg, params)
        self._window = cfg.sliding_window if cfg.attn_variant == "swa" else 0
        self._graph = None          # the decode step's _DecodeGraph, on a CUDA runner
        if self.device.type == "cuda" and ops.get_backend() != "ref":
            # the kernels the steps launch, built together (one nvcc each)
            # rather than one after another at their first launches
            build.build(["paged_attention"]
                        + (["mixed_gemm"] if cfg.dtype == "bfloat16" else [])
                        + (["mamba_scan"] if cfg.has_mamba else []))

    def _refuse_state(self, what: str) -> None:
        if self.ssm_h is not None:
            raise ValueError(f"{what} moves KV pages, which cannot carry the recurrent "
                             f"state of {self.cfg.name}'s Mamba layers")

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
    def prefill_chunk(self, embeds, block_table, start, valid_len, slot=None):
        """embeds: (1, C, d); block_table: (pp,); start, valid_len: ints;
        ``slot``: the request's batch slot, which a model with Mamba layers
        needs: the chunk's valid rows scan on from the slot's state (a zero
        state at start 0, a prompt's first chunk or a preempted request's
        recompute) and leave it for the next chunk or decode.  Returns
        (logits (C, V), hidden (C, d)) on the runner's device."""
        cfg = self.cfg
        page = self.kv.page_size
        h = torch.as_tensor(embeds, device=self.device)
        c = h.shape[1]
        start, valid_len = int(start), int(valid_len)
        if self.ssm_h is not None:
            if slot is None:
                raise ValueError(f"{cfg.name}: a prefill chunk needs its request's slot")
            metrics.note(**{"mamba_resets" if start == 0 else "mamba_carries": 1})
        bt = torch.as_tensor(np.asarray(block_table), dtype=torch.long,
                             device=self.device)
        pos = start + torch.arange(c, device=self.device)
        positions = pos[None]                                   # (1, C)
        written = pos[:valid_len]                               # padding is not written
        pid, wslot = bt[written // page], written % page
        nkv, hd = cfg.num_kv_heads, cfg.head_dim
        for i, lp in enumerate(self._layers):
            hn = L.rmsnorm(lp["ln1"], h, cfg.rmsnorm_eps)
            j = self._pool[i]
            if "mamba" in lp:
                h = h + self._prefill_mamba(j, lp["mamba"], hn, slot, start, valid_len)
            else:
                q, k, v = L._qkv(cfg, lp["attn"], hn)
                if cfg.rope_theta:
                    q = L.rope(q, positions, cfg.rope_theta)
                    k = L.rope(k, positions, cfg.rope_theta)
                self._write_kv(j, k[0, :valid_len], v[0, :valid_len], pid, wslot)
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

    def _prefill_mamba(self, j: int, p: dict, hn, slot: int, start: int, valid: int):
        """Mamba layer j over a chunk's valid rows, from ``slot``'s state
        (none at start 0), which it then holds; the padding rows get
        nothing."""
        hs, cs = self.ssm_h[j, slot], self.ssm_conv[j, slot]
        state = None if start == 0 else (hs[None], cs[None].to(hn.dtype))
        y, (h_last, conv) = M.mamba1_forward(self.cfg, p, hn[:, :valid], state)
        hs.copy_(h_last[0])
        cs.copy_(conv[0])
        return torch.nn.functional.pad(y, (0, 0, 0, hn.shape[1] - valid))

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
        (see ``_DecodeGraph``), replayed on the caller's current stream:
        the returned tensors are then the graph's own outputs, which the
        next call overwrites.  The body runs eagerly on the CPU, under a
        ``DistContext`` (expert parallelism's collectives are not
        captured) and with the plain attention (backend "ref").  Either
        way a MoE step keeps its ``routed_experts`` on its ``model.decode``
        span (``metrics.keep``)."""
        positions = np.asarray(positions).astype(np.int32)
        active = np.asarray(active, bool)
        tables = np.asarray(block_tables, np.int32)
        embeds = torch.as_tensor(embeds)
        if not active.any():
            # every inactive row repeats an active row's K/V write
            raise ValueError("a decode batch needs an active row")
        if self.device.type == "cuda" and ops.get_backend() != "ref" and get_context() is None:
            return self._graph_decode(embeds, tables, positions, active)
        dev = self.device
        logits, hidden, routed, host_s = self._decode_body(
            embeds.to(dev), torch.as_tensor(tables, device=dev),
            torch.as_tensor(positions, device=dev), torch.as_tensor(active, device=dev))
        metrics.note(**host_s)
        if routed is not None:
            metrics.keep(routed_experts=routed)
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
        hidden (B, d), ``_routed_experts`` of the MoE layers' routes, the
        host seconds of the layers' mixer and feed-forward halves,
        enqueueing their kernels)."""
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
        attn_s = ffn_s = 0.0
        t_ffn = time.perf_counter()
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
            t_attn = time.perf_counter()
            attn_s += t_attn - t_ffn
            hn = L.rmsnorm(lp["ln2"], h, cfg.rmsnorm_eps)
            h = h + L.mlp_or_moe(cfg, lp, hn, routes)
            t_ffn = time.perf_counter()
            ffn_s += t_ffn - t_attn
        logits = T._unembed(cfg, self.params, h)[:, 0]
        return (logits, h[:, 0], self._routed_experts(routes, live),
                {"attn_host_s": attn_s, "ffn_host_s": ffn_s})

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

    def _graph_decode(self, embeds, tables, positions, active):
        """``decode`` by a CUDA graph: captured after one eager run of the
        step at the first call, and again whenever what the capture baked
        in changes (the shapes, the pools, ``models/moe.py:
        drop_counter``); replayed at every other call."""
        shapes = (tuple(embeds.shape), embeds.dtype, tables.shape)
        baked = (self.k_pages, self.v_pages, self.k_scales, self.v_scales, self.ssm_h,
                 self.ssm_conv, moe.drop_counter)
        g = self._graph
        if g is not None and g.shapes == shapes \
                and all(a is b for a, b in zip(g.baked, baked)):
            g.load(embeds, tables, positions, active)
            g.launch()
            paged_attention.launches.add(g.launches)
            if g.scan_launches:
                mamba_scan.launches.add(g.scan_launches)
            metrics.note(graph_replays=1)
            if g.routed is not None and metrics.keeping():
                metrics.keep(routed_experts=g.routed.clone())
            return g.logits, g.hidden
        self._graph = None                  # the old graph's memory goes first
        g = _DecodeGraph(self.device, shapes, baked)
        g.load(embeds, tables, positions, active)
        logits, hidden, routed, host_s = self._decode_body(g.embeds, *g.inputs)
        metrics.note(graph_captures=1, **host_s)
        if routed is not None:
            metrics.keep(routed_experts=routed)
        g.capture(self._decode_body)
        self._graph = g
        return logits, hidden


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


class _DecodeGraph:
    """``PagedRunner._decode_body`` captured as one CUDA graph: the static
    buffers its kernels read (the embeddings, and the tables, positions
    and active mask packed in one int32 vector, filled from pinned host
    memory) and write (``logits``, ``hidden``, ``routed``), the paged-
    attention and scan wrapper calls it holds (``launches``,
    ``scan_launches``), the ``shapes`` it was captured at and the tensors
    it ``baked`` in."""

    def __init__(self, device, shapes, baked):
        (b, _, d), dtype, (_, pp) = shapes
        self.shapes, self.baked = shapes, baked
        n = b * pp + 2 * b
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.packed = packed = torch.empty(n, dtype=torch.int32, device=device)
        self.inputs = (packed[:b * pp].view(b, pp), packed[b * pp:b * pp + b],
                       packed[b * pp + b:])
        self.embeds = torch.empty((b, 1, d), dtype=dtype, device=device)
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.logits = self.hidden = self.routed = None
        self.launches = self.scan_launches = 0

    def load(self, embeds, tables, positions, active) -> None:
        """Copy one step's inputs into the static buffers, on the current
        stream, without waiting for the device."""
        self.copied.synchronize()           # the last call's copy has read the host buffer
        host = self.host.numpy()
        n, b = tables.size, len(positions)
        host[:n] = tables.reshape(-1)
        host[n:n + b] = positions
        host[n + b:] = active
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
        The body draws no random numbers, so the launch needs none of
        ``replay``'s generator bookkeeping."""
        rc = _libcuda().cuGraphLaunch(self.graph.raw_cuda_graph_exec(),
                                      torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cuGraphLaunch failed: CUresult {rc}")

    def capture(self, body) -> None:
        with _capture_lock, paged_attention.launches.held() as held, \
                mamba_scan.launches.held() as scans, \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.logits, self.hidden, self.routed, _ = body(self.embeds, *self.inputs)
        self.launches, self.scan_launches = held[0], scans[0]


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
