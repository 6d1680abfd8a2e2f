"""AR stage execution engine: continuous batching + chunked prefill +
paged-KV decode, with per-iteration preprocess hooks (paper §3.3).

One engine serves one stage. Each ``step()`` executes one scheduler plan:
admissions, prefill chunks, one batched decode, sampling, and event
emission (finished outputs and streamed chunks).

On a CUDA device each engine issues its work on a CUDA stream of its own
(``device.engine_stream``), so that a step's host copies (the sampled
tokens, a PD payload) wait for this engine's kernels only, not for those
of another stage's thread in the same process.  Every payload an engine
emits is host data.

Each step runs under a ``core.metrics.StepTrace``: its phases (schedule,
admit, prefill, decode inputs, the model's decode, sampling, emission)
are timed on the host clock, its device->host reads are timed and
counted, and the engine keeps their totals in ``step_totals``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import metrics
from repro_torch.core.request import StageEvent
from repro_torch.device import engine_stream, on_stream
from repro_torch.engine.kv_cache import (PagedKVConfig, embed_prefix_keys,
                                   hash_embed_blocks, hash_token_blocks,
                                   token_prefix_keys)
from repro_torch.engine.runner import embed, make_runner, to_host
from repro_torch.engine.sampling import SamplingParams, sample_tokens
from repro_torch.engine.scheduler import Scheduler


def _ngram_propose(ctx: List[int], m: int, k: int) -> List[int]:
    """Prompt-lookup drafting: continue the most recent earlier occurrence
    of the trailing m-gram."""
    if len(ctx) < m + 1:
        return []
    key = tuple(ctx[-m:])
    for i in range(len(ctx) - m - 1, -1, -1):
        if tuple(ctx[i:i + m]) == key:
            return [int(t) for t in ctx[i + m:i + m + k]]
    return []


@dataclass
class _ReqRuntime:
    prompt_embeds: Optional[np.ndarray] = None   # (S, d) resolved prompt
    prompt_tokens: Optional[List[int]] = None    # for n-gram drafting
    data: Dict[str, Any] = field(default_factory=dict)
    tokens: List[int] = field(default_factory=list)
    hiddens: List[np.ndarray] = field(default_factory=list)
    streamed: int = 0
    chunk_index: int = 0
    kv_seed: Optional[tuple] = None              # (k, v, kv_dtype, prompt_len) — PD


class AREngine:
    def __init__(self, name: str, cfg: ModelConfig, params, *,
                 kv: Optional[PagedKVConfig] = None, max_batch: int = 8,
                 token_budget: int = 256, chunk_size: int = 64,
                 preprocess: Optional[Callable] = None,
                 stream_chunk: int = 0, collect_hidden: bool = False,
                 default_sampling: Optional[SamplingParams] = None,
                 emit_kv: bool = False, enable_prefix_cache: bool = False,
                 prefix_index: str = "radix",
                 spec_ngram: Optional[tuple] = None, seed: int = 0):
        self.name = name
        self.cfg = cfg
        self.kv = kv or PagedKVConfig()
        self.max_batch = max_batch
        self.preprocess = preprocess
        self.stream_chunk = stream_chunk
        self.collect_hidden = collect_hidden
        self.default_sampling = default_sampling
        self.runner = r = make_runner(cfg, params, self.kv, max_batch, chunk_size)
        if spec_ngram or emit_kv:
            r._refuse_state("speculative verification or a PD KV hop")
        # sharing, rewinding or shipping pages needs them to hold a request's
        # whole state (the serving CLI asks every AR stage for prefix caching)
        self.enable_prefix_cache = enable_prefix_cache and r.pages_carry_state
        self.emit_kv = emit_kv and r.pages_carry_state   # prefill stage: ship prompt KV on finish
        # n-gram speculative decoding (greedy only): (match_len m, draft_k).
        # Drafts come from prompt-lookup (most recent m-gram match in the
        # context); verification is one chunk forward; rejected drafts'
        # page writes are masked by seq_lens and overwritten later, so
        # rollback is free.
        self.spec_ngram = spec_ngram if r.pages_carry_state else None
        self.spec_stats = {"proposed": 0, "accepted": 0, "steps": 0}
        if r.whole_prompts:     # a step's budget holds every slot's whole prompt
            token_budget = max(token_budget, max_batch * r.chunk_size)
        self.scheduler = Scheduler(self.kv, max_batch, token_budget, r.chunk_size,
                                   enable_prefix_cache=self.enable_prefix_cache,
                                   prefix_index=prefix_index)
        self.device = r.device
        # after the runner: the stream first waits for the pools' and the
        # weights' initialisation, queued on the creating thread's stream
        self.stream = engine_stream(self.device)
        self._rt: Dict[int, _ReqRuntime] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.busy_time = 0.0                # the steps' seconds (StepTrace)
        self.step_totals = metrics.StepTotals()
        # PD: prompt KV injected, and the host seconds of the admissions
        # that injected it (engine.admit phases: the copies from host memory
        # end in PyTorch's own wait on the stream; the page writes are queued)
        self.kv_injects = 0
        self.kv_inject_time = 0.0

    # ------------------------------------------------------------------
    def enqueue(self, req_id: int, inputs: Dict[str, Any],
                sampling: SamplingParams, data: Dict[str, Any]) -> None:
        if self.default_sampling is not None:
            sampling = self.default_sampling
        rt = _ReqRuntime(data=data)
        if "kv_seed" in inputs:
            # PD disaggregation: prompt KV arrives from a prefill stage
            k, v = inputs["kv_seed"]
            n = int(inputs["prompt_len"])
            rt.kv_seed = (np.asarray(k), np.asarray(v), inputs.get("kv_dtype"), n)
            rt.tokens = [int(inputs["first_token"])]
            if inputs.get("hidden") is not None and self.collect_hidden:
                rt.hiddens = [np.asarray(h) for h in inputs["hidden"]]
            self._rt[req_id] = rt
            self.scheduler.add_prefilled(req_id, n, sampling)
            return
        if "prompt_embeds" in inputs:
            pe = np.asarray(inputs["prompt_embeds"])
        else:
            tokens = np.asarray(inputs["tokens"], np.int32)
            rt.prompt_tokens = [int(t) for t in tokens]
            with metrics.reads_into(self.step_totals.enqueue_reads):
                pe = embed(self.runner.params, tokens)
        if self.preprocess is not None:
            extra = self.preprocess(data, {"phase": "prefill",
                                           "prompt_len": pe.shape[0]})
            if extra and "prompt_extra" in extra:
                pe = pe + np.asarray(extra["prompt_extra"], pe.dtype)
            if extra and "prompt_prepend" in extra:
                # mm_encode hook (paper Fig 4): multimodal embeddings are
                # concatenated ahead of the text prompt
                pe = np.concatenate(
                    [np.asarray(extra["prompt_prepend"], pe.dtype), pe], 0)
        rt.prompt_embeds = pe
        self._rt[req_id] = rt
        hashes, keys = self._prefix_ids(rt, pe)
        self.scheduler.add(req_id, pe.shape[0], sampling,
                           block_hashes=hashes, prefix_keys=keys)

    def _prefix_ids(self, rt: _ReqRuntime, pe: np.ndarray):
        """Content-addressed (block hashes, per-token sub-keys) over the
        prompt: token ids when the stage is tokenized and per-request
        preprocess cannot perturb the prompt; otherwise bytes digests of
        the final prompt embeds (covers hidden-state-fed stages and mm
        prepends).  Hashes cover full pages (tree edges); sub-keys cover
        every position including the partial tail block, enabling
        partial-block radix hits."""
        if not self.enable_prefix_cache:
            return None, None
        if rt.prompt_tokens is not None and self.preprocess is None:
            return (hash_token_blocks(rt.prompt_tokens, self.kv.page_size),
                    token_prefix_keys(rt.prompt_tokens, self.kv.page_size))
        return (hash_embed_blocks(pe, self.kv.page_size),
                embed_prefix_keys(pe, self.kv.page_size))

    def affinity_hints(self, inputs: Dict[str, Any]):
        """Router-side hint for cache-affinity routing: the (block hashes,
        sub-keys) this request WILL carry if routed here.  Must mirror the
        token path of ``_prefix_ids`` exactly — only tokenized stages
        without per-request preprocess are hintable (embeds are hashed
        post-preprocess, which the router cannot reproduce).  Returns None
        when no stable hint exists."""
        if not (self.enable_prefix_cache and self.preprocess is None and inputs is not None
                and "kv_seed" not in inputs and "prompt_embeds" not in inputs
                and "tokens" in inputs):
            return None
        return (hash_token_blocks(inputs["tokens"], self.kv.page_size),
                token_prefix_keys(inputs["tokens"], self.kv.page_size))

    def prefix_hint(self, hint) -> int:
        """Matched tokens of ``hint`` (an ``affinity_hints`` result, or a
        bare hash chain) resident in this replica's radix index — full
        blocks score page_size tokens each, plus the partial-block match
        at the divergence.  Read-only, cross-thread safe (the router
        probes every candidate replica with it)."""
        if not self.enable_prefix_cache or hint is None:
            return 0
        if isinstance(hint, tuple):
            hashes, keys = hint
        else:
            hashes, keys = hint, None
        return self.scheduler.prefix_hint(hashes, keys)

    @property
    def prefix_stats(self) -> Dict[str, int]:
        return dict(self.scheduler.prefix_stats)

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def queue_depth(self) -> int:
        """Admitted-but-unfinished plus waiting requests (StageEngine)."""
        return len(self.scheduler.waiting) + len(self.scheduler.running)

    # ------------------------------------------------------------------
    def _sample(self, req_id: int, logits: torch.Tensor) -> int:
        sp = self.scheduler.running[req_id].sampling
        return int(metrics.to_cpu(sample_tokens(logits[None], sp.temperature,
                                                sp.top_k, self._gen)[0]))

    def _release(self, req_id: int) -> None:
        """Release a finished request, first extending its block-hash chain
        over generated tokens (token stages without per-request decode
        hooks) so the whole context becomes matchable — a multi-turn
        follow-up that re-sends this conversation hits every page."""
        rt = self._rt.pop(req_id)
        if self.enable_prefix_cache and rt.prompt_tokens is not None \
                and self.preprocess is None:
            seq = self.scheduler.running[req_id]
            ctx = rt.prompt_tokens + rt.tokens
            self.scheduler.set_hashes(
                req_id, hash_token_blocks(ctx[:seq.pos], self.kv.page_size),
                token_prefix_keys(ctx[:seq.pos], self.kv.page_size))
        self.scheduler.release(req_id)

    # ---- warm replica scale-up ---------------------------------------
    @property
    def cached_prefix_pages(self) -> int:
        """Published pages in this replica's index (donor-selection
        score for warm scale-up)."""
        if not self.enable_prefix_cache:
            return 0
        return self.scheduler.allocator.indexed_pages

    def prefix_snapshot(self, max_pages: int = 64) -> List[Dict[str, Any]]:
        """Read-only snapshot of this replica's published prefixes for
        seeding a freshly scaled-up sibling: root-to-leaf radix chains
        with their KV contents.  The pages are pinned (extra refcount
        under a negative req-id) while KV is extracted, so the owning
        engine can keep serving concurrently — indexed pages are
        KV-complete and never written by running requests, and the pin
        prevents eviction/reallocation mid-copy."""
        if not self.enable_prefix_cache:
            return []
        alloc = self.scheduler.allocator
        pin, paths = alloc.snapshot_pin(max_pages)
        try:
            out = []
            for hashes, keys, pages in paths:
                bt = np.asarray(pages, np.int32)
                with on_stream(self.stream):    # after the engine's page writes
                    k, v, kv_dtype = self.runner.extract_kv(
                        bt, len(pages) * self.kv.page_size)
                out.append({"hashes": hashes, "keys": keys, "k": k, "v": v,
                            "kv_dtype": kv_dtype})
        finally:
            alloc.release_pin(pin)
        return out

    def seed_prefixes(self, snapshot: List[Dict[str, Any]]) -> int:
        """Warm-seed this replica's cache from a sibling's
        ``prefix_snapshot``: allocate pages, inject the transferred KV,
        publish the chain, and release — the pages park in the LRU exactly
        as if a local request had computed them, so affinity routing has
        somewhere to route from the first request on.  Chains sharing a
        prefix with already-seeded ones are deduplicated via lookup.
        Returns the number of pages seeded."""
        if not self.enable_prefix_cache:
            return 0
        alloc = self.scheduler.allocator
        page = self.kv.page_size
        seeded = 0
        for entry in snapshot:
            hashes, keys = entry["hashes"], entry["keys"]
            hit = alloc.lookup(hashes)
            n_new = len(hashes) - len(hit)
            if n_new <= 0:
                continue
            rid = alloc.temp_rid()
            pages = alloc.allocate(rid, n_new)
            if pages is None:
                break                   # pool exhausted: seed what fits
            lo, hi = len(hit) * page, len(hashes) * page
            with on_stream(self.stream):
                self.runner.inject_kv(np.asarray(entry["k"])[:, lo:hi],
                                      np.asarray(entry["v"])[:, lo:hi],
                                      np.asarray(pages, np.int32), hi - lo,
                                      entry.get("kv_dtype"))
            alloc.publish(hit + pages, hashes, keys)
            alloc.free(rid)             # published pages park in the LRU
            seeded += n_new
        return seeded

    def _emit_progress(self, req_id: int, events: List[StageEvent],
                       finished: bool) -> None:
        rt = self._rt[req_id]
        t_emit = time.perf_counter()
        if self.stream_chunk > 0:
            while (len(rt.tokens) - rt.streamed >= self.stream_chunk
                   or (finished and rt.streamed < len(rt.tokens))):
                end = min(rt.streamed + self.stream_chunk, len(rt.tokens))
                payload = {
                    "tokens": np.array(rt.tokens[rt.streamed:end], np.int32),
                    "hidden": (np.stack(rt.hiddens[rt.streamed:end])
                               if self.collect_hidden else None),
                }
                is_last = finished and end == len(rt.tokens)
                events.append(StageEvent(req_id, "chunk", payload,
                                         stage=self.name,
                                         chunk_index=rt.chunk_index,
                                         is_last=is_last, t_emit=t_emit))
                rt.chunk_index += 1
                rt.streamed = end
                if end == len(rt.tokens):
                    break
        if finished:
            payload = {
                "tokens": np.array(rt.tokens, np.int32),
                "hidden": (np.stack(rt.hiddens) if self.collect_hidden
                           and rt.hiddens else None),
                "n_chunks": rt.chunk_index,
            }
            if self.emit_kv:
                seq = self.scheduler.running[req_id]
                bt = self.scheduler.tables.row(req_id)
                k, v, kv_dtype = self.runner.extract_kv(bt, seq.pos)
                payload.update({"kv_k": k, "kv_v": v, "kv_dtype": kv_dtype,
                                "prompt_len": seq.pos})
            events.append(StageEvent(req_id, "finished", payload,
                                     stage=self.name, t_emit=t_emit))

    # ------------------------------------------------------------------
    def _spec_decode_one(self, rid: int, events: List[StageEvent]) -> bool:
        """One speculative step for one request. Returns True if handled
        (the request must then be excluded from the batched decode)."""
        seq = self.scheduler.running[rid]
        rt = self._rt[rid]
        if (seq.sampling.temperature > 0 or rt.prompt_tokens is None):
            return False
        m, k = self.spec_ngram
        ctx = rt.prompt_tokens + rt.tokens
        draft = _ngram_propose(ctx, m, k)
        if not draft:
            return False
        # dedicated small verification bucket (one compiled shape)
        bucket = max(8, 1 << (k).bit_length())
        draft = draft[:bucket - 1]
        toks = np.array([rt.tokens[-1]] + draft, np.int32)
        emb = embed(self.runner.params, toks)
        embp = np.pad(emb, ((0, bucket - emb.shape[0]), (0, 0)))
        bt = self.scheduler.tables.row(rid)
        logits, hidden = self.runner.prefill_chunk(
            torch.as_tensor(embp, device=self.device).to(
                getattr(torch, self.cfg.dtype))[None], bt, seq.pos, len(toks))
        greedy = metrics.to_cpu(torch.argmax(logits[:len(toks)], dim=-1)).numpy()
        acc = 0
        while acc < len(draft) and draft[acc] == int(greedy[acc]):
            acc += 1
        emitted = [int(t) for t in greedy[:acc + 1]]
        remaining = seq.sampling.max_new_tokens - seq.generated
        emitted = emitted[:max(1, remaining)]
        self.spec_stats["steps"] += 1
        self.spec_stats["proposed"] += len(draft)
        self.spec_stats["accepted"] += len(emitted) - 1
        for _ in range(len(emitted)):       # KV written: last_tok + accepted
            self.scheduler.note_decode_written(rid)
        finished = False
        for i, tok in enumerate(emitted):
            rt.tokens.append(tok)
            if self.collect_hidden:
                rt.hiddens.append(to_host(hidden[i]))
            finished = self.scheduler.note_sampled(rid, tok)
            if finished:
                break
        self._emit_progress(rid, events, finished)
        if finished:
            self._release(rid)
        return True

    def step(self) -> List[StageEvent]:
        with on_stream(self.stream):
            tr = metrics.StepTrace(self.name, self.step_totals, "engine.schedule")
            try:
                return self._step(tr)
            finally:
                self.busy_time += tr.finish()

    def _step(self, tr: metrics.StepTrace) -> List[StageEvent]:
        events: List[StageEvent] = []
        plan = self.scheduler.schedule()
        # preemption (recompute mode): the victim's generated tokens (minus
        # the unwritten last one) join its prompt for re-prefill
        for rid in plan.preempted:
            rt = self._rt.get(rid)
            if rt is None or len(rt.tokens) < 1:
                continue
            # PD-seeded requests have no prompt embeddings to recompute
            # from — never enable preemption on a PD decode stage
            assert rt.prompt_embeds is not None, \
                "preemption is unsupported for KV-seeded (PD) requests"
            gen = np.array(rt.tokens[:-1], np.int32)
            if len(gen):
                rt.prompt_embeds = np.concatenate(
                    [rt.prompt_embeds, embed(self.runner.params, gen)], 0)
        seeded = [rid for rid in plan.admitted
                  if rid in self._rt and self._rt[rid].kv_seed is not None]
        if plan.cow_pairs or seeded:
            tr.phase("engine.admit")
            # prefix cache copy-on-write: a request whose whole page-aligned
            # prompt hit the cache gets a private copy of the final shared
            # page before recomputing (and rewriting) its last token
            if plan.cow_pairs:
                self.runner.copy_pages([s for s, _ in plan.cow_pairs],
                                       [d for _, d in plan.cow_pairs])
            # PD disaggregation: inject transferred KV for newly admitted
            # pre-filled requests before their first decode step
            for rid in seeded:
                rt = self._rt[rid]
                k, v, kv_dtype, n = rt.kv_seed
                self.runner.inject_kv(
                    k, v, self.scheduler.tables.row(rid), n, kv_dtype)
                self.kv_injects += 1
                rt.kv_seed = None
            admit_s = tr.phase(None)
            if seeded:
                self.kv_inject_time += admit_s
        if not plan.prefill_chunks and not plan.decode_req_ids:
            return events
        self.steps += 1
        tr.worked = True

        # ---- prefill chunks (one request-chunk at a time) --------------
        if plan.prefill_chunks:
            one = {ch.req_id for ch in plan.prefill_chunks}
            tr.phase("engine.prefill", one.pop() if len(one) == 1 else None)
            tr.counts["prefill_tokens"] = sum(ch.length for ch in plan.prefill_chunks)
        for ch in plan.prefill_chunks:
            rt = self._rt[ch.req_id]
            seq = self.scheduler.running[ch.req_id]
            emb = rt.prompt_embeds[ch.start:ch.start + ch.length]
            logits, hidden = self.runner.prefill(
                torch.as_tensor(emb, device=self.device)[None], seq.slot,
                self.scheduler.tables.row(ch.req_id), ch.start)
            self.scheduler.note_prefill(ch.req_id, ch.length)
            if not seq.in_prefill and seq.resumed:
                # resumed after preemption: the next token was already
                # sampled before eviction — decode continues from it
                seq.resumed = False
                continue
            if not seq.in_prefill:
                # prompt complete: sample the first token from prefill logits
                tok = self._sample(ch.req_id, logits[-1])
                rt.tokens.append(tok)
                if self.collect_hidden and hidden is not None:
                    rt.hiddens.append(to_host(hidden[-1]))
                finished = self.scheduler.note_sampled(ch.req_id, tok)
                self._emit_progress(ch.req_id, events, finished)
                if finished:
                    self._release(ch.req_id)

        # ---- batched decode --------------------------------------------
        dec_ids = [r for r in plan.decode_req_ids
                   if r in self.scheduler.running
                   and not self.scheduler.running[r].finished]

        # ---- speculative decode (n-gram draft + chunk verify) -----------
        if self.spec_ngram and self.preprocess is None:
            for rid in list(dec_ids):
                if self._spec_decode_one(rid, events):
                    dec_ids.remove(rid)
        if dec_ids:
            tr.phase("engine.decode_inputs")
            tr.counts["rows"] = len(dec_ids)
            B = self.max_batch
            positions = np.zeros((B,), np.int32)
            active = np.zeros((B,), bool)
            tables = np.zeros((B, self.kv.max_pages_per_seq), np.int32)
            slot_of, last, extra = {}, [], {}
            for i, rid in enumerate(dec_ids):
                seq, rt = self.scheduler.running[rid], self._rt[rid]
                s = slot_of[rid] = seq.slot
                last.append(rt.tokens[-1])
                positions[s] = seq.pos
                active[s] = True
                tables[s] = self.scheduler.tables.row(rid)
                hook = self.preprocess and self.preprocess(
                    rt.data, {"phase": "decode", "step": len(rt.tokens) - 1})
                if hook and "extra_embed" in hook:
                    extra[i] = hook["extra_embed"]
            embeds = embed(self.runner.params, last, list(slot_of.values()), B, extra,
                           getattr(torch, self.cfg.dtype))
            tr.phase("model.decode")
            logits, hidden = self.runner.decode(embeds, tables, positions, active)
            tr.phase("engine.sample")
            hidden_np = (to_host(hidden) if self.collect_hidden and hidden is not None
                         else None)
            # batch sampling: one call per (temperature, top_k) group
            groups: Dict[tuple, List[int]] = {}
            for rid in dec_ids:
                sp = self.scheduler.running[rid].sampling
                groups.setdefault((sp.temperature, sp.top_k), []).append(rid)
            tr.counts["sample_groups"] = len(groups)
            sampled: Dict[int, int] = {}
            for (temp, tk), rids in groups.items():
                rows = torch.as_tensor([slot_of[r] for r in rids],
                                       device=self.device)
                toks = metrics.to_cpu(sample_tokens(logits[rows], temp, tk, self._gen))
                sampled.update(zip(rids, toks.tolist()))
            tr.phase("engine.emit")
            for rid in dec_ids:
                s = slot_of[rid]
                self.scheduler.note_decode_written(rid)
                tok = int(sampled[rid])
                rt = self._rt[rid]
                rt.tokens.append(tok)
                if self.collect_hidden and hidden_np is not None:
                    rt.hiddens.append(hidden_np[s])
                finished = self.scheduler.note_sampled(rid, tok)
                self._emit_progress(rid, events, finished)
                if finished:
                    self._release(rid)
        return events
