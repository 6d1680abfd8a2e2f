"""Radix-tree prefix index over chained block hashes (SGLang-style).

The tree replaces the flat content-hash -> page map of the page allocator.
Each node owns one physical KV page; an edge is one *block* (page_size
tokens) keyed by its chained hash ``hash_i = H(hash_{i-1}, contents_i)``.
Because hashes chain, a node's hash uniquely identifies the entire prefix
ending at it, so the tree is also probeable as a flat dict (``_by_hash``)
— one O(1) probe per block, O(match length) per walk — while the tree
structure adds what the flat map cannot do:

  - **partial-block hits**: every node may carry per-token sub-keys (token
    ids for tokenized stages, per-row digests for embed-fed stages).  At
    the first diverging block the walk compares the request's sub-keys
    against each *child* of the deepest matched node and returns the child
    with the longest common token prefix.  Soundness: KV at position p
    depends only on tokens 0..p, and the chained hash match guarantees the
    contexts before the block are identical, so the first m rows of that
    child's page are exactly the KV a fresh prefill would compute — the
    scheduler materializes them through copy-on-write and recomputes only
    the tail.
  - **leaf-ordered eviction**: eviction scans the allocator's LRU oldest
    first but only takes a page whose node is a *leaf*, never an interior
    node with live descendants (removing an interior page would orphan its
    subtree and break prefix closure).  Because requests always acquire
    contiguous prefixes from the root, refcounts are monotone
    non-increasing along any root-to-leaf path; hence whenever the LRU is
    non-empty some leaf is in it and eviction always makes progress.
  - **prefix closure**: an indexed block implies every ancestor block is
    indexed (leaf-only eviction preserves this), which is what makes the
    dict-probe walk and the cross-thread ``hint`` sound.
  - **snapshot paths**: root-to-leaf chains (hashes, sub-keys, pages) that
    a sibling replica can pin, extract KV from, and seed into a freshly
    scaled-up engine (warm scale-up).

``FlatIndex`` keeps the PR-6 flat-map behavior behind the same interface
as the ablation baseline (full-block hits only, pure-LRU eviction, no
snapshot) for the differential tests and ``benchmarks/bench_radix.py``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BlockHash = Tuple[str, bytes]
# per-token sub-keys within one block: a tuple of hashables (ints for token
# stages, bytes row-digests for embed stages); the final block of a prompt
# may carry fewer than page_size entries
BlockKey = Tuple
# a partial-block hit: (page holding the partially matching block, number
# of leading tokens of that block that match the request)
PartialHit = Tuple[int, int]


def _common_prefix(a: Sequence, b: Sequence) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixNode:
    __slots__ = ("hash", "page", "key", "parent", "children")

    def __init__(self, h: Optional[BlockHash], page: int,
                 key: Optional[BlockKey], parent: Optional["RadixNode"]):
        self.hash = h
        self.page = page
        self.key = key
        self.parent = parent
        self.children: Dict[BlockHash, "RadixNode"] = {}


class RadixIndex:
    """Radix tree mapping chained block-hash prefixes to KV pages."""

    def __init__(self) -> None:
        self._root = RadixNode(None, -1, None, None)
        self._by_hash: Dict[BlockHash, RadixNode] = {}
        self._by_page: Dict[int, RadixNode] = {}

    def __len__(self) -> int:
        return len(self._by_page)

    def __contains__(self, h: BlockHash) -> bool:
        return h in self._by_hash

    def has_page(self, page: int) -> bool:
        return page in self._by_page

    def pages(self) -> Iterable[int]:
        return self._by_page.keys()

    # -- insert ---------------------------------------------------------
    def insert(self, hashes: Sequence[BlockHash], pages: Sequence[int],
               keys: Optional[Sequence[Optional[BlockKey]]] = None) -> int:
        """Insert a full root-anchored chain.  First writer wins per node:
        an existing node keeps its page (the caller's duplicate page stays
        unindexed).  The walk stops if a *new* node would need a page that
        is already indexed elsewhere (it cannot back two nodes).  Returns
        the number of nodes created."""
        cur = self._root
        created = 0
        for i, (h, p) in enumerate(zip(hashes, pages)):
            key = keys[i] if keys is not None and i < len(keys) else None
            node = cur.children.get(h)
            if node is None:
                if h in self._by_hash or p in self._by_page:
                    break                      # conflicting registration
                node = RadixNode(h, p, key, cur)
                cur.children[h] = node
                self._by_hash[h] = node
                self._by_page[p] = node
                created += 1
            elif node.key is None and key is not None:
                node.key = key                 # backfill sub-keys
            cur = node
        return created

    # -- lookup ---------------------------------------------------------
    def lookup(self, hashes: Iterable[BlockHash]) -> List[int]:
        """Pages of the longest indexed full-block prefix (walk from the
        root, O(match length))."""
        out: List[int] = []
        cur = self._root
        for h in hashes:
            node = cur.children.get(h)
            if node is None:
                break
            out.append(node.page)
            cur = node
        return out

    def match(self, hashes: Sequence[BlockHash],
              keys: Optional[Sequence[Optional[BlockKey]]] = None,
              ) -> Tuple[List[int], Optional[PartialHit]]:
        """Longest full-block prefix plus the best partial hit at the
        diverging block.

        ``keys`` aligns with the request's blocks (``keys[j]`` are the
        per-token sub-keys of block j; the final entry may cover a partial
        tail block, so ``len(keys)`` may exceed ``len(hashes)``).  At the
        first miss at depth j the children of the deepest matched node are
        scored by common sub-key prefix against ``keys[j]``; ties prefer
        the smallest page id (deterministic).  The chained-hash match up
        to j guarantees both contexts agree before the block, so the first
        m rows of the winning child's page are byte-identical to a fresh
        prefill's KV."""
        out: List[int] = []
        cur = self._root
        depth = 0
        for h in hashes:
            node = cur.children.get(h)
            if node is None:
                break
            out.append(node.page)
            cur = node
            depth += 1
        partial: Optional[PartialHit] = None
        target = keys[depth] if keys and depth < len(keys) else None
        if target:
            for child in cur.children.values():
                if not child.key:
                    continue
                m = _common_prefix(child.key, target)
                if m > 0 and (partial is None or m > partial[1]
                              or (m == partial[1]
                                  and child.page < partial[0])):
                    partial = (child.page, m)
        return out, partial

    def hint(self, hashes: Sequence[BlockHash],
             keys: Optional[Sequence[Optional[BlockKey]]],
             page_size: int) -> int:
        """Matched-token count for cache-affinity routing.  Read-only and
        cross-thread tolerant: the full-block walk is one dict probe per
        block (sound because leaf-only eviction keeps the index
        prefix-closed), and the partial-block probe is advisory — if the
        owning engine mutates the tree mid-iteration we keep the
        full-block score."""
        n = 0
        for h in hashes:
            if h not in self._by_hash:
                break
            n += 1
        score = n * page_size
        try:
            _, partial = self.match(hashes[:n], keys)
            if partial is not None:
                score += partial[1]
        except RuntimeError:            # children mutated during iteration
            pass
        return score

    # -- eviction -------------------------------------------------------
    def pick_evictable(self, lru: Iterable[int]) -> Optional[int]:
        """Coldest evictable page: the first page in LRU order whose node
        is a leaf.  Interior nodes with live descendants are skipped —
        evicting one would orphan its subtree."""
        for p in lru:
            node = self._by_page.get(p)
            if node is None or not node.children:
                return p
        return None

    def remove(self, page: int) -> None:
        node = self._by_page.pop(page)
        assert not node.children, "evicting an interior radix node"
        del self._by_hash[node.hash]
        del node.parent.children[node.hash]

    # -- snapshot (warm scale-up) ---------------------------------------
    def paths(self, max_pages: int = 0,
              ) -> List[Tuple[List[BlockHash], List[Optional[BlockKey]],
                              List[int]]]:
        """Root-to-leaf chains as (hashes, keys, pages), deepest first,
        greedily truncated once ``max_pages`` distinct pages are covered
        (0 = no cap).  Shared prefixes repeat across paths; the consumer
        deduplicates via its own lookup before seeding."""
        out = []
        stack: List[Tuple[RadixNode, List[RadixNode]]] = [(self._root, [])]
        while stack:
            node, trail = stack.pop()
            kids = list(node.children.values())
            if node is not self._root:
                trail = trail + [node]
                if not kids:
                    out.append(trail)
            stack.extend((c, trail) for c in kids)
        out.sort(key=len, reverse=True)
        paths, seen = [], set()
        for trail in out:
            if max_pages and len(seen) >= max_pages:
                break
            seen.update(n.page for n in trail)
            paths.append(([n.hash for n in trail],
                          [n.key for n in trail],
                          [n.page for n in trail]))
        return paths

    # -- invariants -----------------------------------------------------
    def check(self) -> bool:
        """Structural invariants: hash/page bijection through the same
        nodes, parent/child link consistency, and every node reachable
        from the root (prefix closure)."""
        if len(self._by_hash) != len(self._by_page):
            return False
        seen = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            seen += 1
            if self._by_hash.get(node.hash) is not node:
                return False
            if self._by_page.get(node.page) is not node:
                return False
            if node.parent.children.get(node.hash) is not node:
                return False
            stack.extend(node.children.values())
        return seen == len(self._by_hash)


class FlatIndex:
    """PR-6 flat content-hash -> page map behind the RadixIndex interface:
    full-block hits only, strict-LRU eviction order, no partial matches,
    no snapshot paths.  Kept as the ablation baseline."""

    def __init__(self) -> None:
        self._hash_to_page: Dict[BlockHash, int] = {}
        self._page_hash: Dict[int, BlockHash] = {}

    def __len__(self) -> int:
        return len(self._page_hash)

    def __contains__(self, h: BlockHash) -> bool:
        return h in self._hash_to_page

    def has_page(self, page: int) -> bool:
        return page in self._page_hash

    def pages(self) -> Iterable[int]:
        return self._page_hash.keys()

    def insert(self, hashes: Sequence[BlockHash], pages: Sequence[int],
               keys: Optional[Sequence[Optional[BlockKey]]] = None) -> int:
        created = 0
        for h, p in zip(hashes, pages):
            if h in self._hash_to_page or p in self._page_hash:
                continue
            self._hash_to_page[h] = p
            self._page_hash[p] = h
            created += 1
        return created

    def lookup(self, hashes: Iterable[BlockHash]) -> List[int]:
        out: List[int] = []
        for h in hashes:
            p = self._hash_to_page.get(h)
            if p is None:
                break
            out.append(p)
        return out

    def match(self, hashes: Sequence[BlockHash],
              keys: Optional[Sequence[Optional[BlockKey]]] = None,
              ) -> Tuple[List[int], Optional[PartialHit]]:
        return self.lookup(hashes), None

    def hint(self, hashes: Sequence[BlockHash],
             keys: Optional[Sequence[Optional[BlockKey]]],
             page_size: int) -> int:
        n = 0
        for h in hashes:
            if h not in self._hash_to_page:
                break
            n += 1
        return n * page_size

    def pick_evictable(self, lru: Iterable[int]) -> Optional[int]:
        for p in lru:
            return p
        return None

    def remove(self, page: int) -> None:
        h = self._page_hash.pop(page)
        del self._hash_to_page[h]

    def paths(self, max_pages: int = 0):
        return []                      # no chain structure to snapshot

    def check(self) -> bool:
        return (len(self._hash_to_page) == len(self._page_hash)
                and all(self._hash_to_page.get(h) == p
                        for p, h in self._page_hash.items()))


def make_index(kind: str):
    if kind == "radix":
        return RadixIndex()
    if kind == "flat":
        return FlatIndex()
    raise ValueError(f"unknown prefix index kind: {kind!r}")
