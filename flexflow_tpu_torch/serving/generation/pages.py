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

:func:`export_pages` and :func:`import_pages` move a slot's page chain
between two engines' pools (disaggregated prefill/decode): one packed
device-to-host copy on the source, one host-to-device copy
(:func:`pages_to_device`) and one in-place row scatter per leaf on the
destination.
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
                      compute_dtype: str,
                      mesh_sizes: Optional[Dict[str, int]] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The ``kv_cache_layout`` as zeroed tensors on ``device``: attention
    K/V page pools in the compute dtype and float32 LSTM state pairs.
    With ``mesh_sizes`` each leaf is this rank's shard: a dim whose
    layout entry names ``c`` holds ``1/c`` of it (the page dim is
    replicated), the one allocation under the layout's entries.  Zeroed,
    not empty: a masked column multiplies probability 0 by the pool's
    contents, and 0 x NaN is NaN."""
    compute_dt = torch_dtype(compute_dtype)
    c = int((mesh_sizes or {}).get("c", 1))
    caches: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, ent in layout.items():
        dt = compute_dt if ent["dtype"] == "compute" else torch.float32
        caches[name] = {}
        for leaf, shape in ent["shapes"].items():
            local = [int(d) // c if e == "c" else int(d)
                     for d, e in zip(shape, ent["entries"][leaf])]
            caches[name][leaf] = torch.zeros(local, dtype=dt, device=device)
    return caches


# segment alignment inside a packed migration buffer: every leaf starts
# on a 16-byte boundary, so its bytes view back as any element type
_ALIGN = 16


def _nbytes(dtype: torch.dtype, shape) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return n


def _packed_layout(metas) -> Tuple[List[int], int]:
    """Byte offsets of the leaves ``metas`` (dtype, shape) in one packed
    buffer, each aligned to ``_ALIGN``, and the buffer's size."""
    offs, off = [], 0
    for dtype, shape in metas:
        offs.append(off)
        off += -(-_nbytes(dtype, shape) // _ALIGN) * _ALIGN
    return offs, off


def _unpack(buf: torch.Tensor, metas, offs):
    """Views of the uint8 ``buf`` as the leaves ``metas`` (dtype, shape)
    describe, at ``offs``."""
    return [buf[off:off + _nbytes(dtype, shape)].view(dtype).view(shape)
            for (dtype, shape), off in zip(metas, offs)]


def _tree_leaves(tree) -> List[Tuple[str, str, torch.Tensor]]:
    return [(name, leaf, t) for name, sub in tree.items()
            for leaf, t in sub.items()]


def _tree_from(names, values) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for (name, leaf), v in zip(names, values):
        out.setdefault(name, {})[leaf] = v
    return out


def export_pages(caches, pages: List[int], num_pages: int,
                 pad_to: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """Gather a slot's page rows out of every pool leaf and bring them to
    the host in one copy: the export half of KV page migration.  ``pages``
    is the slot's page-id chain in order.  Every leaf must be page-major
    (``shape[0] == num_pages``), which holds exactly for the attention
    K/V pools; an LSTM ``state`` leaf is slot-major and raises
    ValueError before anything is gathered.

    ``pad_to`` pads the chain to that many rows by repeating the last
    page id (the JAX package pads to one shape per pool geometry for its
    compile cache); :func:`import_pages` pads its destination ids the
    same way, and the real length travels beside the payload.

    The rows are gathered on the device straight into one packed buffer
    (one ``index_select`` per leaf), and that buffer is copied to the
    host once: one device-to-host copy and one wait a migration, however
    many layers.  Returns ``{op: {leaf: CPU tensor (rows, ...)}}``, views
    of one host buffer that the payload owns (nothing reuses it)."""
    for name, leaf, arr in _tree_leaves(caches):
        if arr.shape[0] != num_pages:
            raise ValueError(
                f"cache leaf {name}.{leaf} is not page-major "
                f"(shape {tuple(arr.shape)}, pool has {num_pages} "
                f"pages): this graph's state cannot migrate")
    ids = [int(p) for p in pages]
    if not ids:
        raise ValueError("export_pages needs at least one page")
    if pad_to > len(ids):
        ids += [ids[-1]] * (pad_to - len(ids))
    items = _tree_leaves(caches)
    device = items[0][2].device
    idx = torch.tensor(ids, dtype=torch.long, device=device)
    metas = [(arr.dtype, (len(ids),) + tuple(arr.shape[1:]))
             for _, _, arr in items]
    offs, total = _packed_layout(metas)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    for (_, _, arr), dst in zip(items, _unpack(buf, metas, offs)):
        torch.index_select(arr, 0, idx, out=dst)
    host = buf.cpu()  # THE device-to-host copy of the migration
    return _tree_from([(n, lf) for n, lf, _ in items],
                      _unpack(host, metas, offs))


def pages_to_device(payload, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """An :func:`export_pages` payload on ``device`` in one host-to-device
    copy: the leaves are packed into one host buffer (pinned for a card),
    copied on a side stream, and the copy has completed when this
    returns, so the caller may hand the result to another thread.  A
    payload already on ``device`` comes back as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    items = _tree_leaves(payload)
    if all(t.device == device for _, _, t in items):
        return payload
    metas = [(t.dtype, tuple(t.shape)) for _, _, t in items]
    offs, total = _packed_layout(metas)
    cuda = device.type == "cuda"
    host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    for (_, _, t), dst in zip(items, _unpack(host, metas, offs)):
        dst.copy_(t)
    if cuda:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            dev = host.to(device, non_blocking=True)
        stream.synchronize()
    else:
        dev = host.to(device)
    return _tree_from([(n, lf) for n, lf, _ in items],
                      _unpack(dev, metas, offs))


def import_pages(caches, payload, pages: List[int]):
    """Write an :func:`export_pages` payload into ``pages`` (freshly
    allocated destination ids, one per exported page, in order) of the
    destination pools, in place: the import half of KV page migration.
    Returns ``caches``.

    A payload with more rows than ``pages`` was padded at export: the
    destination ids are padded the same way (repeating the last real id),
    so the duplicate positions rewrite the last real page with its own
    row.  Every leaf is validated before the first write, so a payload
    of another graph or page geometry leaves the pools untouched.  Leaves
    not yet on the pools' device go there in one copy
    (:func:`pages_to_device`); leaves already there are used as they
    are."""
    ids = [int(p) for p in pages]
    if not ids:
        raise ValueError("import_pages needs at least one page")
    items = _tree_leaves(payload)
    rows0 = int(items[0][2].shape[0]) if items else len(ids)
    if rows0 > len(ids):
        ids += [ids[-1]] * (rows0 - len(ids))
    for name, sub in caches.items():
        rows = payload.get(name) if isinstance(payload, dict) else None
        if rows is None or set(rows) != set(sub):
            raise ValueError(
                f"migration payload does not cover cache op {name!r}: "
                f"source and destination graphs differ")
        for leaf, arr in sub.items():
            val = rows[leaf]
            if tuple(val.shape[1:]) != tuple(arr.shape[1:]) \
                    or val.shape[0] != len(ids):
                raise ValueError(
                    f"migration payload {name}.{leaf} shape "
                    f"{tuple(val.shape)} does not fit destination pool "
                    f"leaf {tuple(arr.shape)} over {len(ids)} page(s): "
                    f"page geometry must match across engines")
    if not caches:
        return caches
    device = next(iter(next(iter(caches.values())).values())).device
    dev = pages_to_device({n: payload[n] for n in caches}, device)
    idx = torch.tensor(ids, dtype=torch.long, device=device)
    for name, sub in caches.items():
        for leaf, arr in sub.items():
            val = dev[name][leaf]
            arr.index_copy_(0, idx, val.to(arr.dtype))
            if device.type == "cuda":
                # the rows may come from a side stream's allocation:
                # keep its block alive until this stream has read it
                val.record_stream(torch.cuda.current_stream(device))
    return caches


__all__ = ["KVPagePool", "PrefixCache", "alloc_pool_arrays",
           "export_pages", "import_pages", "pages_to_device"]
