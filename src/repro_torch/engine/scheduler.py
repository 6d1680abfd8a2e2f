"""Per-stage scheduler: continuous batching with chunked prefill.

Sarathi-style: every engine step has a token budget shared between decode
tokens (one per running decode sequence) and prefill chunks; new requests
are admitted whenever a batch slot and enough KV pages are available.
Invariants (property-tested in tests/test_scheduler.py and
tests/test_kv_prefix_cache.py):
  - a slot is owned by at most one request;
  - page accounting conserves the pool (refcount-aware with prefix cache);
  - FIFO admission (no starvation): waiting requests admit in arrival order
    and a cache hit never lets a later request jump the queue;
  - per-step scheduled tokens <= token_budget (unless a single decode set
    already exceeds it — decodes are never dropped);
  - a request never writes KV into a page another request can read: shared
    cached pages sit strictly before a sequence's write position, and a
    fully-cached final prompt page is replaced by a copy-on-write copy.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.engine.kv_cache import (BlockHash, BlockKey, BlockTableStore,
                                   PageAllocator, PagedKVConfig, pages_for)
from repro_torch.engine.sampling import SamplingParams


@dataclass
class SeqState:
    req_id: int
    prompt_len: int
    sampling: SamplingParams
    slot: int = -1
    prefill_done: int = 0              # prompt tokens already processed
    generated: int = 0
    pos: int = 0                       # next position to write
    finished: bool = False
    resumed: bool = False              # re-prefilling after preemption
    block_hashes: List[BlockHash] = field(default_factory=list)
    # per-token sub-keys per block (incl. the partial tail block) — the
    # radix index compares these at the diverging block for partial hits
    prefix_keys: List[BlockKey] = field(default_factory=list)
    cached_tokens: int = 0             # prompt tokens served from the cache

    @property
    def in_prefill(self) -> bool:
        return self.prefill_done < self.prompt_len


@dataclass
class ScheduledChunk:
    req_id: int
    start: int                         # first prompt position in this chunk
    length: int                        # real tokens in the chunk


@dataclass
class StepPlan:
    prefill_chunks: List[ScheduledChunk] = field(default_factory=list)
    decode_req_ids: List[int] = field(default_factory=list)
    admitted: List[int] = field(default_factory=list)
    preempted: List[int] = field(default_factory=list)
    # (src, dst) device page copies the engine must apply before prefill:
    # dst is a private copy of shared cached page src (copy-on-write)
    cow_pairs: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return (sum(c.length for c in self.prefill_chunks)
                + len(self.decode_req_ids))


class Scheduler:
    def __init__(self, kv: PagedKVConfig, max_batch: int,
                 token_budget: int = 256, chunk_size: int = 64,
                 enable_preemption: bool = False,
                 enable_prefix_cache: bool = False,
                 prefix_index: str = "radix",
                 min_partial_tokens: int = 1):
        self.kv = kv
        self.max_batch = max_batch
        self.token_budget = token_budget
        self.chunk_size = chunk_size
        self.enable_preemption = enable_preemption
        self.enable_prefix_cache = enable_prefix_cache
        self.min_partial_tokens = min_partial_tokens
        self.allocator = PageAllocator(
            kv.num_pages, enable_prefix_cache=enable_prefix_cache,
            index_kind=prefix_index, page_size=kv.page_size)
        self.tables = BlockTableStore(kv)
        self.waiting: Deque[SeqState] = deque()
        self.running: Dict[int, SeqState] = {}
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self.preemptions = 0
        # per-stage prefix-cache hit accounting (surfaced by the engine).
        # cached_tokens = full_block_tokens + partial_tokens; partial
        # tokens are served through a copy-on-write page (a partial-block
        # radix hit, or the final page of a fully-cached aligned prompt)
        self.prefix_stats = {"lookups": 0, "hits": 0,
                             "cached_tokens": 0, "computed_tokens": 0,
                             "full_block_tokens": 0, "partial_tokens": 0,
                             "partial_hits": 0}

    # ------------------------------------------------------------------
    def add(self, req_id: int, prompt_len: int, sampling: SamplingParams,
            block_hashes: Optional[List[BlockHash]] = None,
            prefix_keys: Optional[List[BlockKey]] = None) -> None:
        self.waiting.append(SeqState(req_id, prompt_len, sampling,
                                     block_hashes=block_hashes or [],
                                     prefix_keys=prefix_keys or []))

    def set_hashes(self, req_id: int, hashes: List[BlockHash],
                   keys: Optional[List[BlockKey]] = None) -> None:
        """Replace a running request's block-hash chain (the engine extends
        it over generated tokens just before release, so whole finished
        contexts become matchable by later multi-turn requests)."""
        seq = self.running[req_id]
        seq.block_hashes = hashes
        if keys is not None:
            seq.prefix_keys = keys

    def add_prefilled(self, req_id: int, prompt_len: int,
                      sampling: SamplingParams) -> None:
        """Admit a request whose prompt KV was computed by a remote prefill
        stage (PD disaggregation): no prefill chunks are scheduled; the
        engine injects the transferred KV on admission."""
        self.waiting.append(SeqState(req_id, prompt_len, sampling,
                                     prefill_done=prompt_len,
                                     generated=1, pos=prompt_len))

    def _admission_pages(self, seq: SeqState) -> int:
        """Pages reserved at admission. With preemption the pool grows
        incrementally during decode (vLLM-style); without it, the full
        prompt+max_new worth is reserved upfront so admission can't
        deadlock mid-decode."""
        if self.enable_preemption:
            tokens = seq.prompt_len
        else:
            tokens = seq.prompt_len + seq.sampling.max_new_tokens
        return min(pages_for(tokens, self.kv.page_size),
                   self.kv.max_pages_per_seq)

    def prefix_hint(self, block_hashes: Optional[List[BlockHash]],
                    prefix_keys: Optional[List[BlockKey]] = None) -> int:
        """Cache-affinity probe: matched *tokens* of ``block_hashes`` (+
        partial-block sub-keys) resident in this replica's radix index.
        Read-only and cross-thread safe — the router scores replicas with
        it."""
        if not (self.enable_prefix_cache and block_hashes):
            return 0
        return self.allocator.prefix_hint(block_hashes, prefix_keys)

    def _match_prefix(self, seq: SeqState, total: int):
        """Longest cached prefix usable by ``seq``: (pages, cow).

        Full pages strictly before the last prompt token are reused as-is.
        ``cow`` is ``None`` or ``(src_page, m)``: the next block partially
        matches a cached page for m leading tokens, which the engine
        materializes by copying src into a private page and recomputing
        only positions >= m.  Two cases collapse into one mechanism:

          - radix partial-block hit: the diverging block shares its first
            m tokens with a cached sibling block (m < page, or m < the
            request's tail length for the final block);
          - fully-cached page-aligned prompt: every block matched, but at
            least one token must be recomputed to produce logits, so the
            final page is reused via CoW with m = page - 1.

        Both clamp m so cached_tokens <= prompt_len - 1."""
        page = self.kv.page_size
        matched, partial = self.allocator.match(seq.block_hashes,
                                                seq.prefix_keys)
        k_full = min((seq.prompt_len - 1) // page, total - 1)
        cow = None
        if len(matched) > k_full:
            # fully-cached aligned prompt: recompute only the last token
            cow = (matched[k_full], page - 1)
        elif partial is not None:
            j = len(matched)
            m = min(partial[1], seq.prompt_len - 1 - j * page)
            if m >= self.min_partial_tokens:
                cow = (partial[0], m)
        return matched[:k_full], cow

    def _admit_one(self, seq: SeqState, plan: StepPlan) -> bool:
        page = self.kv.page_size
        total = self._admission_pages(seq)
        cached: List[int] = []
        cow = None
        looked_up = (self.enable_prefix_cache and seq.block_hashes
                     and seq.prefill_done == 0)
        if looked_up:
            cached, cow = self._match_prefix(seq, total)
            self.prefix_stats["lookups"] += 1
        # take refs on the hit pages (and pin the CoW source so it cannot
        # be evicted before the engine copies it) BEFORE allocating fresh
        # pages: allocation may evict refcount-0 cached pages
        pins = cached + ([cow[0]] if cow is not None else [])
        self.allocator.acquire(seq.req_id, pins)
        fresh = self.allocator.allocate(seq.req_id, total - len(cached))
        if fresh is None:
            self.allocator.free(seq.req_id)    # roll back the acquisitions
            return False                       # FIFO: head waits, no skips
        full_tokens = len(cached) * page
        part_tokens = 0
        if cow is not None:
            plan.cow_pairs.append((cow[0], fresh[0]))
            part_tokens = cow[1]
        seq.cached_tokens = full_tokens + part_tokens
        if seq.cached_tokens:
            self.prefix_stats["hits"] += 1
            seq.prefill_done = seq.cached_tokens
            seq.pos = seq.cached_tokens
        if part_tokens:
            self.prefix_stats["partial_hits"] += 1
        if looked_up:
            self.prefix_stats["cached_tokens"] += seq.cached_tokens
            self.prefix_stats["full_block_tokens"] += full_tokens
            self.prefix_stats["partial_tokens"] += part_tokens
            self.prefix_stats["computed_tokens"] += (seq.prompt_len
                                                     - seq.cached_tokens)
        seq.slot = self._free_slots.pop()
        self.tables.set(seq.req_id, cached + fresh)
        self.running[seq.req_id] = seq
        plan.admitted.append(seq.req_id)
        return True

    def _try_admit(self, plan: StepPlan) -> None:
        while self.waiting and self._free_slots:
            if not self._admit_one(self.waiting[0], plan):
                break                   # FIFO: don't skip ahead of the head
            self.waiting.popleft()

    def _preempt(self, victim: SeqState, plan: StepPlan) -> None:
        """Recompute-mode preemption: free the victim's pages + slot and
        push it to the front of the waiting queue for re-prefill."""
        rid = victim.req_id
        self.running.pop(rid)
        if self.enable_prefix_cache and victim.block_hashes:
            # publish the victim's full, KV-complete pages before freeing
            # them: free() then parks them in the LRU instead of the free
            # list, so the re-admission's _match_prefix re-acquires the
            # victim's own prefix instead of recomputing it (and any other
            # request sharing the prefix hits too)
            n_full = min(len(victim.block_hashes),
                         victim.pos // self.kv.page_size)
            table = self.tables.tables.get(rid, [])
            self.allocator.publish(table[:n_full],
                                   victim.block_hashes[:n_full],
                                   victim.prefix_keys[:n_full] or None)
        self.allocator.free(rid)
        self.tables.drop(rid)
        self._free_slots.append(victim.slot)
        plan.preempted.append(rid)
        # reset for recompute: generated tokens (minus the last sampled one,
        # whose KV was never written) join the prompt; the engine extends
        # the prompt embeddings and skips the prefill-completion sample
        victim.slot = -1
        victim.prefill_done = 0
        victim.pos = 0
        if victim.generated >= 1:
            victim.prompt_len += victim.generated - 1
            victim.resumed = True
        self.waiting.appendleft(victim)
        self.preemptions += 1

    def _ensure_decode_capacity(self, plan: StepPlan) -> None:
        """Incremental page growth for running decodes; on OOM, preempt the
        youngest running request so the oldest always makes progress
        (age-ordered eviction can't thrash)."""
        for seq in sorted(self.running.values(), key=lambda s: s.req_id):
            if seq.req_id not in self.running or seq.finished \
                    or seq.in_prefill:
                continue
            # grow against the block TABLE length: owned pages can include
            # a CoW pin that is not addressable through the table
            while (pages_for(seq.pos + 1, self.kv.page_size)
                   > len(self.tables.tables.get(seq.req_id, []))):
                got = self.allocator.allocate(seq.req_id, 1)
                if got is not None:
                    self.tables.extend(seq.req_id, got)
                    continue
                victims = [s for s in self.running.values()
                           if not s.finished and s.req_id > seq.req_id]
                if victims:
                    self._preempt(max(victims, key=lambda s: s.req_id), plan)
                else:
                    self._preempt(seq, plan)     # evict itself; retry later
                    break

    def schedule(self) -> StepPlan:
        """Plan one engine step."""
        plan = StepPlan()
        self._try_admit(plan)
        if self.enable_preemption:
            self._ensure_decode_capacity(plan)
        budget = self.token_budget
        # decodes first (latency-critical; never dropped)
        for seq in self.running.values():
            if not seq.in_prefill and not seq.finished:
                plan.decode_req_ids.append(seq.req_id)
        budget -= len(plan.decode_req_ids)
        # prefill chunks with the remaining budget
        for seq in self.running.values():
            if budget <= 0:
                break
            if seq.in_prefill:
                n = min(self.chunk_size, seq.prompt_len - seq.prefill_done,
                        max(budget, 0))
                if n > 0:
                    plan.prefill_chunks.append(
                        ScheduledChunk(seq.req_id, seq.prefill_done, n))
                    budget -= n
        return plan

    # ------------------------------------------------------------------
    def note_prefill(self, req_id: int, n: int) -> None:
        seq = self.running[req_id]
        seq.prefill_done += n
        seq.pos = seq.prefill_done      # pos = #tokens whose KV is written

    def note_decode_written(self, req_id: int) -> None:
        """One decode step wrote this request's current token KV at seq.pos."""
        self.running[req_id].pos += 1

    def note_sampled(self, req_id: int, token: int) -> bool:
        """Record one sampled token; returns True if the request finished."""
        seq = self.running[req_id]
        seq.generated += 1
        sp = seq.sampling
        if (seq.generated >= sp.max_new_tokens
                or (sp.eos_token >= 0 and token == sp.eos_token)
                or seq.pos + 1 >= self.kv.max_seq):
            seq.finished = True
        return seq.finished

    def release(self, req_id: int) -> None:
        seq = self.running.pop(req_id)
        if self.enable_prefix_cache and seq.block_hashes:
            # publish the finished request's full, KV-complete pages into
            # the index; free() then parks refcount-0 hashed pages in the
            # LRU instead of the free list, so later arrivals can hit them
            n_full = min(len(seq.block_hashes),
                         seq.pos // self.kv.page_size)
            table = self.tables.tables.get(req_id, [])
            self.allocator.publish(table[:n_full],
                                   seq.block_hashes[:n_full],
                                   seq.prefix_keys[:n_full] or None)
        self.allocator.free(req_id)
        self.tables.drop(req_id)
        self._free_slots.append(seq.slot)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)
