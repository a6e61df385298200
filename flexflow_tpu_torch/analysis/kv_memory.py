"""KV-cache memory accounting for paged token generation, the JAX
package's ``analysis/kv_memory.py`` without its device-sharded cases.

The decode state is a paged pool: each causal attention op holds a K
and a V pool of ``(num_pages, page_size, heads, head_dim)`` in the
compute dtype, and a per-slot page table maps logical positions onto
pages.  LSTM ops keep a float32 ``(h, c)`` pair of ``(slots, hidden)``:
cell state is a carry, not a sequence that pages.

One layout decides both what ``serving/generation/pages.py`` allocates
(:func:`kv_cache_layout`) and what the static memory gate charges
(:func:`kv_page_plan`, :func:`kv_cache_bytes`, the ``extra_state_bytes``
of ``analysis/strategy_passes.memory_diagnostics``), so the two cannot
disagree.  The port runs on one device: ``mesh_sizes`` is None or a
``{axis: size}`` dict, and the sharding rules of the JAX module (heads
over ``c``, the LSTM state over ``n``) are kept so the byte counts of a
device-free plan match the JAX package's for the same mesh.

Device-free: nothing here imports torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..op import Op, OpType

# the LSTM carry stays float32 whatever the compute dtype
STATE_DTYPE_BYTES = 4

# tokens per KV page (FFConfig.serve_kv_page's default)
DEFAULT_PAGE_SIZE = 16


def _axis(mesh_sizes: Optional[Dict[str, int]], axis: str) -> int:
    return max(1, int((mesh_sizes or {}).get(axis, 1)))


def slot_shard_degree(slots: int, mesh_sizes: Optional[Dict[str, int]]
                      ) -> int:
    """How many ways the slot dim of the LSTM state shards over ``n``:
    never below 2 slots a shard, replicated where ``n`` does not
    divide.  The attention pools never slot-shard (pages are
    interchangeable across slots)."""
    n = _axis(mesh_sizes, "n")
    if n > 1 and slots % n == 0 and slots >= 2 * n:
        return n
    return 1


def _check_page_args(page_size: int, num_pages: int = 0) -> None:
    """Refuse negative page knobs: 0 is the default/auto sentinel, and a
    negative geometry would give a negative byte charge."""
    if page_size < 0 or num_pages < 0:
        raise ValueError(
            f"page_size/num_pages must be >= 0 (0 = default/auto), "
            f"got {page_size}/{num_pages}")


def pages_per_slot(max_seq: int, page_size: int = DEFAULT_PAGE_SIZE
                   ) -> int:
    """Page-table width: pages needed to hold one ``max_seq`` stream."""
    _check_page_args(page_size)
    page_size = int(page_size) or DEFAULT_PAGE_SIZE
    return -(-int(max_seq) // page_size)


def default_num_pages(slots: int, max_seq: int,
                      page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """The auto pool size (``serve_kv_pages=0``): every slot holding a
    full private ``max_seq`` stream."""
    return int(slots) * pages_per_slot(max_seq, page_size)


def kv_cache_layout(layers: List[Op],
                    mesh_sizes: Optional[Dict[str, int]],
                    slots: int, max_seq: int,
                    page_size: int = DEFAULT_PAGE_SIZE,
                    num_pages: int = 0) -> Dict[str, Dict]:
    """Per-op decode-state geometry: ``{op_name: {"kind": "kv"|"state",
    "shapes": {leaf: shape}, "entries": {leaf: mesh-axis entries},
    "dtype": "compute"|"f32"}}``, the one place the layout is decided."""
    _check_page_args(page_size, num_pages)
    page_size = int(page_size) or DEFAULT_PAGE_SIZE
    pool = int(num_pages) or default_num_pages(slots, max_seq, page_size)
    n_deg = slot_shard_degree(slots, mesh_sizes)
    c = _axis(mesh_sizes, "c")
    out: Dict[str, Dict] = {}
    for op in layers:
        if op.op_type == OpType.ATTENTION and hasattr(op, "num_heads"):
            h, hd = op.num_heads, op.head_dim
            c_entry = "c" if (c > 1 and h % c == 0) else None
            shape = (pool, page_size, h, hd)
            entries = (None, None, c_entry, None)
            out[op.name] = {
                "kind": "kv",
                "shapes": {"k": shape, "v": shape},
                "entries": {"k": entries, "v": entries},
                "dtype": "compute",
            }
        elif op.op_type == OpType.LSTM and hasattr(op, "hidden_size"):
            hsz = op.hidden_size
            c_entry = "c" if (c > 1 and hsz % c == 0) else None
            n_entry = "n" if n_deg > 1 else None
            shape = (int(slots), hsz)
            entries = (n_entry, c_entry)
            out[op.name] = {
                "kind": "state",
                "shapes": {"h": shape, "c": shape},
                "entries": {"h": entries, "c": entries},
                "dtype": "f32",
            }
    return out


def kv_page_plan(layers: List[Op],
                 mesh_sizes: Optional[Dict[str, int]],
                 slots: int, max_seq: int,
                 kv_dtype_bytes: int = 2,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 num_pages: int = 0) -> Dict:
    """Per-device bytes of the paged decode state: ``{"page_size",
    "pages_per_slot", "num_pages", "page_bytes", "pool_bytes",
    "state_bytes", "total_bytes"}``.  ``page_bytes`` is one page summed
    over every attention op's K and V pools (``kv_dtype_bytes`` an
    element); ``state_bytes`` the float32 LSTM carry.  It integrates
    :func:`kv_cache_layout` leaf by leaf."""
    _check_page_args(page_size, num_pages)
    page_size = int(page_size) or DEFAULT_PAGE_SIZE
    pool = int(num_pages) or default_num_pages(slots, max_seq, page_size)
    layout = kv_cache_layout(layers, mesh_sizes, slots, max_seq,
                             page_size=page_size, num_pages=pool)
    n_deg = slot_shard_degree(slots, mesh_sizes)
    c = _axis(mesh_sizes, "c")
    page_bytes = 0.0
    state_bytes = 0.0
    for entry in layout.values():
        bytes_per = (kv_dtype_bytes if entry["dtype"] == "compute"
                     else STATE_DTYPE_BYTES)
        for leaf, shape in entry["shapes"].items():
            vol = 1
            for s in shape:
                vol *= int(s)
            parts = 1
            for e in entry["entries"][leaf]:
                if e == "n":
                    parts *= n_deg
                elif e == "c":
                    parts *= c
            if entry["kind"] == "kv":
                page_bytes += vol * bytes_per / parts / pool
            else:
                state_bytes += vol * bytes_per / parts
    return {
        "page_size": page_size,
        "pages_per_slot": pages_per_slot(max_seq, page_size),
        "num_pages": pool,
        "page_bytes": page_bytes,
        "pool_bytes": page_bytes * pool,
        "state_bytes": state_bytes,
        "total_bytes": page_bytes * pool + state_bytes,
    }


def kv_cache_bytes(layers: List[Op],
                   mesh_sizes: Optional[Dict[str, int]],
                   slots: int, max_seq: int,
                   kv_dtype_bytes: int = 2,
                   page_size: int = DEFAULT_PAGE_SIZE,
                   num_pages: int = 0) -> float:
    """Per-device bytes of the preallocated paged decode state (the
    ``total_bytes`` of :func:`kv_page_plan`): the scalar the memory
    gate's ``extra_state_bytes`` takes."""
    return kv_page_plan(layers, mesh_sizes, slots, max_seq,
                        kv_dtype_bytes=kv_dtype_bytes,
                        page_size=page_size,
                        num_pages=num_pages)["total_bytes"]


def default_serve_seq(input_tensors) -> Optional[int]:
    """The model's sequence length when its first input is
    sequence-shaped, else None."""
    tins = list(input_tensors or [])
    if tins and len(tins[0].shape) > 1:
        return int(tins[0].shape[1])
    return None


def dtype_bytes(dtype_name: str) -> int:
    """Byte width of a compute dtype name ('bfloat16' -> 2, 'float32'
    -> 4)."""
    import numpy as np
    try:
        return int(np.dtype(dtype_name).itemsize)
    except TypeError:
        # numpy has no bfloat16; it is 2 bytes
        return 2 if "bfloat16" in str(dtype_name) else 4


__all__ = ["kv_cache_layout", "kv_cache_bytes", "kv_page_plan",
           "slot_shard_degree", "pages_per_slot", "default_num_pages",
           "dtype_bytes", "default_serve_seq", "STATE_DTYPE_BYTES",
           "DEFAULT_PAGE_SIZE"]
