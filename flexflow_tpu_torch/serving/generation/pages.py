"""KV page pool and shared-prefix trie, the host-side memory manager of
the paged generation engine: the JAX package's
``serving/generation/pages.py``, whose pool and trie are pure Python and
are copied here unchanged.

The pool hands out page ids, refcounts them and tracks the in-use
high-water mark; the trie maps token-id chains (one node per full page
of tokens) to pooled pages, so a prompt that extends a cached prefix
skips recomputing the shared pages.  Only the engine's dispatcher
thread touches either.  The device sees page ids only as gather and
scatter indices (``ops/attention.py``'s ``forward_paged`` and
``decode_paged``).

A shared page is immutable by construction: a lookup matches only
complete pages strictly inside the prompt's first ``len - 1``
positions, so the prefill recomputes at least the last prompt position
and every write lands in the slot's private pages.

:func:`alloc_pool_arrays` is the one place the pool tensors are
allocated, from ``analysis.kv_memory.kv_cache_layout``, so the bytes
allocated are the bytes ``kv_page_plan`` accounts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ...analysis.kv_memory import DEFAULT_PAGE_SIZE
from ...ops.common import torch_dtype


class KVPagePool:
    """Fixed-size pool of interchangeable KV pages (one id spans every
    attention op's K/V pools — allocation is in lockstep across ops).
    Single-threaded by design: only the engine's dispatcher thread
    allocates/frees (the same single-writer discipline as the slot
    table)."""

    def __init__(self, num_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size) or DEFAULT_PAGE_SIZE
        # the sentinel: gathers clamp it (its columns are masked) and
        # writes through it are dropped — "no page" on the device
        self.no_page = self.num_pages
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self.high_water = 0
        self.allocs = 0

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """One fresh page at refcount 1, or None when exhausted (the
        caller evicts from the prefix cache and retries, then fails the
        stream — never blocks: this runs on the dispatcher thread)."""
        if not self._free:
            return None
        page = self._free.pop()
        self._refs[page] = 1
        self.allocs += 1
        self.high_water = max(self.high_water, self.pages_in_use)
        return page

    def ref(self, page: int) -> None:
        self._refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True when the page returned to the free
        list (refcount hit zero)."""
        n = self._refs[page] - 1
        if n > 0:
            self._refs[page] = n
            return False
        del self._refs[page]
        self._free.append(page)
        return True

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)


class _TrieNode:
    __slots__ = ("page", "children", "parent", "key", "last_used")

    def __init__(self, page: int, parent: Optional["_TrieNode"],
                 key: Tuple[int, ...]):
        self.page = page
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.key = key
        self.last_used = 0


class PrefixCache:
    """Ref-counted prefix trie over FULL pages of prompt token ids.

    One node per page: the path root -> node spells the token prefix
    the node's page holds the K/V for.  Children are keyed on the exact
    page token tuple (a hash chain with exact-match confirmation — two
    different prefixes can never alias, so a hit is always
    bit-identical history).  The trie holds ONE pool reference per
    node; lookups take an extra reference per matched page for the
    joining slot.  Eviction is LRU over leaf nodes nobody else
    references — interior nodes and pages still held by live slots are
    never evicted."""

    def __init__(self, pool: KVPagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root: Dict[Tuple[int, ...], _TrieNode] = {}
        self._nodes = 0
        self._clock = 0  # LRU tick (monotonic counter, no wall time)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _pages_of(tokens, page_size: int) -> List[Tuple[int, ...]]:
        """Complete-page token tuples strictly covering positions
        [0, len-1): the last prompt position is always recomputed (it
        yields the stream's first token), so the page holding it is
        only shareable once COMPLETE — see the immutability note in
        the module docstring."""
        n = len(tokens)
        full = max(0, (n - 1)) // page_size
        return [tuple(int(t) for t in tokens[i * page_size:
                                             (i + 1) * page_size])
                for i in range(full)]

    def lookup(self, tokens) -> List[int]:
        """Walk the trie along the prompt's full pages; returns the
        matched page ids IN ORDER with one pool reference taken per
        page for the caller (the joining slot).  The caller's prefill
        starts at ``len(result) * page_size``."""
        out: List[int] = []
        level = self._root
        now = self._tick()
        for key in self._pages_of(tokens, self.page_size):
            node = level.get(key)
            if node is None:
                break
            node.last_used = now
            self.pool.ref(node.page)
            out.append(node.page)
            level = node.children
        if out:
            self.hits += 1
        else:
            self.misses += 1
        return out

    def insert(self, tokens, pages: List[int]) -> int:
        """Promote a slot's freshly-computed full-page prefix into the
        trie: ``pages[i]`` holds the K/V of the prompt's i-th full
        page.  Pages already cached (the slot's own lookup hits) are
        skipped; new nodes take one extra pool reference (the trie's).
        Returns the number of nodes added."""
        added = 0
        level = self._root
        parent: Optional[_TrieNode] = None
        now = self._tick()
        keys = self._pages_of(tokens, self.page_size)
        for key, page in zip(keys, pages):
            node = level.get(key)
            if node is None:
                node = _TrieNode(page, parent, key)
                node.last_used = now
                self.pool.ref(page)
                level[key] = node
                self._nodes += 1
                added += 1
            else:
                node.last_used = now
            parent = node
            level = node.children
        return added

    def _evictable(self) -> List[_TrieNode]:
        out: List[_TrieNode] = []
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.pool.refcount(node.page) == 1:
                # a leaf only the trie references: safe to drop
                out.append(node)
        return out

    def _evict_node(self, node: _TrieNode) -> None:
        level = (node.parent.children if node.parent is not None
                 else self._root)
        del level[node.key]
        self._nodes -= 1
        self.pool.release(node.page)
        self.evictions += 1

    def evict(self, count: int) -> int:
        """Free up to ``count`` least-recently-used unreferenced LEAF
        pages back to the pool (page-pool pressure).  ONE evictability
        walk covers a whole batch — evicting a leaf can only ever
        EXPOSE its parent as a new leaf, never invalidate another
        collected victim, so the sorted victim list stays valid while
        it drains; only when it runs dry mid-batch (freed leaves'
        parents now evictable) does another walk happen.  Returns the
        number of pages freed — 0 means every cached page backs a
        live slot."""
        freed = 0
        while freed < count:
            victims = sorted(self._evictable(),
                             key=lambda n: n.last_used)
            if not victims:
                break
            for node in victims:
                if freed >= count:
                    break
                self._evict_node(node)
                freed += 1
        return freed

    def evict_one(self) -> bool:
        """Single-page :meth:`evict` (the unit-test surface)."""
        return self.evict(1) == 1

    def clear(self) -> None:
        """Release every cached page (engine shutdown)."""
        stack = list(self._root.values())
        self._root = {}
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.release(node.page)
        self._nodes = 0


def alloc_pool_arrays(layout: Dict[str, Dict], device,
                      compute_dtype: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The ``kv_cache_layout`` as zeroed tensors on ``device``: attention
    K/V page pools in the compute dtype and float32 LSTM state pairs.
    Zeroed, not empty: a masked column multiplies probability 0 by the
    pool's contents, and 0 x NaN is NaN."""
    compute_dt = torch_dtype(compute_dtype)
    caches: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, ent in layout.items():
        dt = compute_dt if ent["dtype"] == "compute" else torch.float32
        caches[name] = {leaf: torch.zeros(shape, dtype=dt, device=device)
                        for leaf, shape in ent["shapes"].items()}
    return caches


__all__ = ["KVPagePool", "PrefixCache", "alloc_pool_arrays"]
