"""Paged KV cache manager (vLLM-style) + SSM state cache.

The page pool is a pair of arrays (L, P, page, nkv, hd); sequences own
pages through int32 block tables. Allocation is a host-side free list; the
device tensors are only touched by the runner's step functions.

Automatic prefix caching (vLLM-style): the allocator is refcounted and
keeps a content-hash -> page index over *full* pages.  A page is always in
exactly one of three states:

  - **free**: on the free list, content meaningless;
  - **cached**: refcount 0 but content-indexed; parked in an LRU from
    which it can be re-acquired by hash (prefix hit) or evicted;
  - **referenced**: refcount >= 1, held by one or more requests (the same
    physical page backs every request whose prompt shares the prefix).

Block hashes form a chain — hash_i = H(hash_{i-1}, page_i contents) — so a
hit on block i implies the whole prefix up to i matches.  Contents are
token ids for tokenized stages and a bytes digest of the prompt *embeds*
for stages fed hidden states (Thinker -> Talker), so every AR stage of an
any-to-any pipeline can prefix-cache.

The index itself is a radix tree over the hash chain
(``engine/radix_index.py``): longest-prefix walks, *partial-block* hits
via per-token sub-keys, leaf-ordered LRU eviction, and snapshot paths a
sibling replica can warm-seed a scale-up from.  ``index_kind="flat"``
keeps the PR-6 flat map as the ablation baseline.

SSM stages have no KV: their cache is a constant-size recurrent state per
slot, managed by ``SlotStateCache`` (DESIGN.md §4 — per-stage cache kind).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.radix_index import (BlockKey, PartialHit,  # noqa: F401
                                      make_index)

BlockHash = Tuple[str, bytes]


def _digest(parent: bytes, payload: bytes) -> bytes:
    return hashlib.blake2b(parent + payload, digest_size=16).digest()


def hash_token_blocks(tokens, page_size: int,
                      parent: bytes = b"") -> List[BlockHash]:
    """Chained content hashes over the FULL pages of a token sequence."""
    arr = np.asarray(tokens, np.int64)
    out: List[BlockHash] = []
    h = parent
    for i in range(len(arr) // page_size):
        h = _digest(h, arr[i * page_size:(i + 1) * page_size].tobytes())
        out.append(("tok", h))
    return out


def hash_embed_blocks(embeds, page_size: int,
                      parent: bytes = b"") -> List[BlockHash]:
    """Chained bytes-digests over the FULL pages of a prompt-embeds matrix
    (stages whose prompts are hidden states rather than token ids)."""
    e = np.ascontiguousarray(np.asarray(embeds, np.float32))
    out: List[BlockHash] = []
    h = parent
    for i in range(e.shape[0] // page_size):
        h = _digest(h, e[i * page_size:(i + 1) * page_size].tobytes())
        out.append(("emb", h))
    return out


def token_prefix_keys(tokens, page_size: int) -> List[BlockKey]:
    """Per-token sub-keys, one tuple per block *including* the partial
    tail block: the radix index compares these at the diverging block to
    find partial-page hits.  For token stages the sub-key of a position is
    the token id itself — equal sub-keys literally mean equal tokens, so a
    partial match's copied KV rows are exactly what a fresh prefill would
    write."""
    arr = np.asarray(tokens, np.int64)
    return [tuple(int(t) for t in arr[i:i + page_size])
            for i in range(0, len(arr), page_size)]


def embed_prefix_keys(embeds, page_size: int) -> List[BlockKey]:
    """Per-row digests for embed-fed stages: two rows with equal digests
    have byte-identical embeddings, so prefix-matching digests is as sound
    as matching token ids."""
    e = np.ascontiguousarray(np.asarray(embeds, np.float32))
    digests = [hashlib.blake2b(e[i].tobytes(), digest_size=8).digest()
               for i in range(e.shape[0])]
    return [tuple(digests[i:i + page_size])
            for i in range(0, len(digests), page_size)]


class PageAllocator:
    """Refcounted page allocator with an optional content-addressed
    prefix cache (``enable_prefix_cache``).  With the cache disabled the
    behavior is exactly the old free-list allocator (no page is ever
    indexed, so every released page returns straight to the free list).

    The index is a ``RadixIndex`` by default (``index_kind="flat"`` keeps
    the PR-6 map as the ablation baseline).  Mutators take ``_lock`` so a
    sibling replica can pin a consistent snapshot cross-thread
    (``snapshot_pin``/``release_pin``) while the owning engine keeps
    serving; the read-only ``prefix_hint`` router probe stays lock-free.
    """

    def __init__(self, num_pages: int, enable_prefix_cache: bool = False,
                 index_kind: str = "radix", page_size: int = 16):
        self.num_pages = num_pages
        self.enable_prefix_cache = enable_prefix_cache
        self.page_size = page_size
        self.index_kind = index_kind
        self._index = make_index(index_kind)
        # guarded-by-writes: _lock (mutation locked; advisory lock-free
        # reads are the documented contract of the stats properties)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        # pages held per request, WITH multiplicity: the total multiplicity
        # of a page across requests equals its refcount
        self._owned: Dict[int, List[int]] = {}   # guarded-by-writes: _lock
        self._refcount: Dict[int, int] = {}      # guarded-by-writes: _lock
        # cached pages with refcount 0, oldest first (eviction order);
        # eviction takes the first *leaf* in this order
        self._lru: "OrderedDict[int, None]" = (
            OrderedDict())                       # guarded-by-writes: _lock
        self.evictions = 0                       # guarded-by-writes: _lock
        self._lock = threading.RLock()
        self._pin_rid = -1              # negative req-ids for snapshot pins

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages retained only for their cached content."""
        return len(self._lru)

    @property
    def reusable_pages(self) -> int:
        return len(self._free) + len(self._lru)

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    def pages_owned(self, req_id: int) -> List[int]:
        return self._owned.get(req_id, [])

    @property
    def indexed_pages(self) -> int:
        return len(self._index)

    # -- allocation ---------------------------------------------------------
    def _evict_one(self) -> bool:  # requires-lock: _lock
        """Evict the coldest *evictable* cached page: oldest-first in LRU
        order, skipping interior radix nodes with live descendants.  A
        skipped interior page becomes evictable once its subtree is gone
        (children are always parked no earlier than their parents only if
        acquired together; regardless, removing leaves peels the tree
        bottom-up so repeated calls make progress)."""
        page = self._index.pick_evictable(self._lru)
        if page is None:
            return False
        del self._lru[page]
        self._index.remove(page)
        self._free.append(page)
        self.evictions += 1
        return True

    def allocate(self, req_id: int, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh (private, refcount-1) pages, evicting
        cached pages as needed.  Referenced pages are never evicted."""
        with self._lock:
            if len(self._free) + len(self._lru) < n:
                return None
            while len(self._free) < n:
                if not self._evict_one():
                    return None       # no evictable leaf (treat as OOM)
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refcount[p] = 1
            self._owned.setdefault(req_id, []).extend(pages)
            return pages

    # -- prefix cache -------------------------------------------------------
    def lookup(self, hashes: Sequence[BlockHash]) -> List[int]:
        """Longest cached full-block prefix (no refcounts taken).  An
        O(match length) walk down the radix tree — the scan stops at the
        first miss and never touches the rest of the index."""
        return self._index.lookup(hashes)

    def match(self, hashes: Sequence[BlockHash],
              keys: Optional[Sequence[Optional[BlockKey]]] = None,
              ) -> Tuple[List[int], Optional[PartialHit]]:
        """Longest cached full-block prefix plus the best partial-block
        hit ``(page, matched_tokens)`` at the diverging block (None for
        the flat index)."""
        return self._index.match(hashes, keys)

    def prefix_hint(self, hashes: Sequence[BlockHash],
                    keys: Optional[Sequence[Optional[BlockKey]]] = None,
                    ) -> int:
        """Matched-token count (full blocks * page_size + partial-block
        tokens) of the longest indexed prefix of ``hashes``.  The cheap
        read-only probe behind cache-affinity routing: the router calls it
        cross-thread on every candidate replica, so it must not touch
        refcounts, the LRU, or any allocator state."""
        return self._index.hint(hashes, keys, self.page_size)

    def acquire(self, req_id: int, pages: Iterable[int]) -> None:
        """Take a reference on already-resident pages (a prefix hit, or an
        extra share).  Refcount-0 cached pages leave the eviction LRU."""
        with self._lock:
            owned = self._owned.setdefault(req_id, [])
            for p in pages:
                rc = self._refcount.get(p, 0)
                if rc == 0:
                    self._lru.pop(p)          # must be a cached page
                self._refcount[p] = rc + 1
                owned.append(p)

    def publish(self, pages: Sequence[int], hashes: Sequence[BlockHash],
                keys: Optional[Sequence[Optional[BlockKey]]] = None,
                ) -> None:
        """Insert the chain of full, KV-complete pages into the index so
        future requests can reuse them.  Chains are root-anchored (the
        caller passes the *whole* prefix from block 0, not a suffix).
        First writer wins per block: an existing node keeps its page (the
        duplicate page stays unindexed and returns to the free list on
        release).  ``keys`` carries per-token sub-keys enabling partial
        hits against these blocks."""
        if not self.enable_prefix_cache:
            return
        with self._lock:
            self._index.insert(hashes, pages, keys)

    def cow(self, req_id: int, page: int) -> Optional[int]:
        """Copy-on-write: give ``req_id`` a private writable page standing
        in for shared/cached ``page`` (which it must already hold).  The
        reference on the source is retained until ``free(req_id)`` so it
        cannot be evicted before the caller copies its contents.  Returns
        the private page, or None if the pool is exhausted."""
        assert page in self._owned.get(req_id, ()), "CoW of an unheld page"
        got = self.allocate(req_id, 1)
        return got[0] if got else None

    # -- snapshot (warm replica scale-up) -----------------------------------
    def temp_rid(self) -> int:
        """A fresh negative req-id for internal holds (snapshot pins,
        warm-seed injections) — real requests are non-negative, so these
        can never collide."""
        with self._lock:
            rid = self._pin_rid
            self._pin_rid -= 1
            return rid

    def snapshot_pin(self, max_pages: int = 0):
        """Pin a consistent read-only snapshot of the published prefixes:
        returns ``(pin_id, paths)`` where paths are root-to-leaf
        ``(hashes, keys, pages)`` chains and every covered page holds an
        extra reference under ``pin_id`` (a negative req-id, so it can
        never collide with real requests).  The caller extracts KV from
        the pinned pages *outside* the lock — pinned pages cannot be
        evicted or reallocated, and indexed pages are KV-complete so no
        running request writes into them — then calls ``release_pin``."""
        with self._lock:
            paths = self._index.paths(max_pages)
            pin = self.temp_rid()
            seen = set()
            pages = [p for _, _, pp in paths for p in pp
                     if not (p in seen or seen.add(p))]
            self.acquire(pin, pages)
            return pin, paths

    def release_pin(self, pin_id: int) -> None:
        self.free(pin_id)

    # -- release ------------------------------------------------------------
    def _decref(self, page: int) -> None:  # requires-lock: _lock
        rc = self._refcount[page] - 1
        if rc > 0:
            self._refcount[page] = rc
            return
        del self._refcount[page]
        if self._index.has_page(page):
            self._lru[page] = None            # park: reusable via its hash
            self._lru.move_to_end(page)
        else:
            self._free.append(page)

    def free(self, req_id: int) -> None:
        """Drop every reference ``req_id`` holds.  Shared pages survive for
        their other holders; cached pages park in the LRU."""
        with self._lock:
            for p in self._owned.pop(req_id, []):
                self._decref(p)

    def check_invariant(self) -> bool:
        with self._lock:
            ref_pages = set(self._refcount)
            free_set = set(self._free)
            lru_set = set(self._lru)
            idx_pages = set(self._index.pages())
            # free / cached / referenced partition the pool
            ok = (len(self._free) == len(free_set)
                  and not (free_set & lru_set)
                  and not (free_set & ref_pages)
                  and not (lru_set & ref_pages)
                  and len(free_set) + len(lru_set) + len(ref_pages)
                  == self.num_pages)
            # refcount conservation: refcount == ownership multiplicity >= 1
            mult: Dict[int, int] = {}
            for pages in self._owned.values():
                for p in pages:
                    mult[p] = mult.get(p, 0) + 1
            ok = ok and mult == self._refcount
            # index structure: hash/page bijection, parent/child link
            # consistency, every node reachable from the root (radix:
            # prefix closure — an indexed block implies its whole chain)
            ok = ok and self._index.check()
            # tree shape and page states agree: every indexed page is
            # resident — parked in the LRU (cached) or held by a request
            # (referenced); never on the free list.  A page the index
            # points at but neither state owns would be silently
            # resurrectable garbage
            ok = ok and not (idx_pages & free_set)
            ok = ok and idx_pages <= (lru_set | ref_pages)
            # every refcount-0 cached page is re-acquirable by hash
            ok = ok and lru_set <= idx_pages
            return ok


@dataclass
class PagedKVConfig:
    num_pages: int = 128
    page_size: int = 16
    max_pages_per_seq: int = 16

    @property
    def max_seq(self) -> int:
        return self.page_size * self.max_pages_per_seq


def init_kv_pages(cfg: ModelConfig, kv: PagedKVConfig, num_layers: int,
                  device="cpu"):
    dtype = (torch.int8 if cfg.kv_cache_dtype == "int8"
             else getattr(torch, cfg.dtype))
    shape = (num_layers, kv.num_pages, kv.page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_scale_pages(cfg: ModelConfig, kv: PagedKVConfig,
                        num_layers: int, device="cpu"):
    shape = (num_layers, kv.num_pages, kv.page_size, cfg.num_kv_heads)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def pages_for(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


class BlockTableStore:
    """Host-side block tables, padded to max_pages_per_seq with 0."""

    def __init__(self, kv: PagedKVConfig):
        self.kv = kv
        self.tables: Dict[int, List[int]] = {}

    def set(self, req_id: int, pages: List[int]) -> None:
        assert len(pages) <= self.kv.max_pages_per_seq, \
            f"request needs {len(pages)} pages > max_pages_per_seq"
        self.tables[req_id] = list(pages)

    def extend(self, req_id: int, pages: List[int]) -> None:
        self.tables.setdefault(req_id, []).extend(pages)

    def row(self, req_id: int) -> np.ndarray:
        t = self.tables.get(req_id, [])
        row = np.zeros(self.kv.max_pages_per_seq, np.int32)
        row[:len(t)] = t
        return row

    def drop(self, req_id: int) -> None:
        self.tables.pop(req_id, None)
