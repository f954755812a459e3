"""Serving cache substrate: dense slot caches and paged KV pools (torch port
of ``repro.serve.cache``).

Two layouts share one interface (``serve/decode.py`` branches on the
``"k_pages"`` leaf of a layer):

* **dense** — every attention layer holds ``(batch_slots, max_len,
  kv_heads, head_dim)`` K/V tensors in ``cfg.dtype``.
* **paged** — every attention layer holds ``(num_pages, page_size,
  kv_heads, head_dim)`` pools, and the cache holds one page table
  ``ptab (batch_slots, ⌈max_len/page_size⌉)`` int32 that maps each slot's
  logical page to a pool row, for every layer at once. A host-side
  :class:`PageAllocator` hands rows out and takes them back. Pool row 0 is
  the **trash page**: idle slots keep all-zero table rows, so their writes
  land there and never in a live page.

``step`` (B,) is each slot's own position. The JAX cache stacks layers into
groups; here ``cache["layers"]`` is a list with one entry per layer, so the
slot reset of the JAX package (``slot_axes`` and ``reset_slot``, which tag
each leaf's slot axis) becomes :func:`reset_slot`, which zeroes the slot of
every dense leaf, its step and its table row directly. The port updates
the cache in place where the JAX package returns new arrays.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = [
    "init_cache", "init_layer_cache", "init_paged_cache", "logical_pages",
    "pages_needed", "gather_pages", "identity_ptab", "reset_slot", "copy_page",
    "PageAllocator", "PrefixCache", "PAGED_KINDS", "TRASH_PAGE",
]

# attention kinds whose KV history grows with the sequence; only these get
# paged pools
PAGED_KINDS = ("attn", "moe_attn")
# pool row 0 is never allocated: it absorbs the writes of idle slots
TRASH_PAGE = 0


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"cache for layer kind {kind!r} is not ported yet")
    shp = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    from repro_torch.models.transformer import layer_kinds
    dev = resolve_device(device)
    return {
        "layers": [init_layer_cache(cfg, kind, batch, max_len, dev)
                   for kind in layer_kinds(cfg)],
        "step": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# Paged layout
# ---------------------------------------------------------------------------

def logical_pages(max_len: int, page_size: int) -> int:
    """Page-table width: logical pages covering one slot's max_len tokens."""
    return -(-max_len // page_size)


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Physical pages a request of n_tokens total (prompt + budget) needs."""
    return -(-n_tokens // page_size)


def init_paged_layer_cache(cfg: ModelConfig, kind: str, num_pages: int,
                           page_size: int, device) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"paged cache for layer kind {kind!r} is not ported yet")
    shp = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k_pages": torch.zeros(shp, dtype=cfg.dtype, device=device),
            "v_pages": torch.zeros(shp, dtype=cfg.dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     num_pages: int, page_size: int | None = None,
                     device="cuda") -> dict:
    """Paged cache: a pool pair per attention layer, ``step`` and the shared
    page table ``ptab``. ``ptab[b, j]`` is the pool row backing slot b's
    logical page j (tokens ``j·page_size .. (j+1)·page_size``); 0
    (TRASH_PAGE) marks unmapped. ``num_pages`` counts the trash page."""
    from repro_torch.models.transformer import layer_kinds
    dev = resolve_device(device)
    ps = page_size or cfg.page_size
    return {
        "layers": [init_paged_layer_cache(cfg, kind, num_pages, ps, dev)
                   for kind in layer_kinds(cfg)],
        "step": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "ptab": torch.zeros((batch, logical_pages(max_len, ps)), dtype=torch.int32,
                            device=dev),
    }


def identity_ptab(cache: dict, batch: int) -> dict:
    """Allocator-free page table for direct-step harnesses (the launcher,
    tests): slot b owns pool rows b·NP+1 .. (b+1)·NP; row 0 stays the trash
    page. Updates ``cache["ptab"]`` in place and returns the cache."""
    ptab = cache["ptab"]
    NP = ptab.shape[1]
    ptab.copy_(1 + torch.arange(batch * NP, dtype=torch.int32,
                                device=ptab.device).reshape(batch, NP))
    return cache


def gather_pages(pool: torch.Tensor, ptab: torch.Tensor) -> torch.Tensor:
    """The logical per-slot view of a pool: pool (P, ps, ...), ptab (B, NP)
    -> (B, NP·ps, ...). Unmapped pages gather the trash page (masked by the
    callers' lengths)."""
    g = pool[ptab.long()]  # (B, NP, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def reset_slot(cache: dict, s: int) -> dict:
    """Zero slot ``s`` in every dense leaf, its step and its page-table row,
    in place; pools are left alone (the zeroed table row is their
    isolation)."""
    for layer in cache["layers"]:
        for name, leaf in layer.items():
            if not name.endswith("_pages"):
                leaf[s] = 0
    cache["step"][s] = 0
    if "ptab" in cache:
        cache["ptab"][s] = 0
    return cache


def copy_page(cache: dict, src: int, dst: int) -> dict:
    """Copy pool row ``src`` to ``dst`` in every layer's pools, in place: the
    device half of copy-on-write (serve/engine.py ``_grow``)."""
    for layer in cache["layers"]:
        for name, leaf in layer.items():
            if name.endswith("_pages"):
                leaf[dst] = leaf[src]
    return cache


# ---------------------------------------------------------------------------
# Host-side page allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Refcounted free-list allocator over pool rows 1..num_pages-1 (row 0 =
    trash).

    Pages come out of ``alloc`` with refcount 1. Sharing a page — a prefix
    cache entry, a second slot mapping the same physical prefix page —
    takes an extra reference via :meth:`acquire`; :meth:`release` drops one
    reference per page and only returns the page to the free list when its
    count reaches zero (``free`` is the same operation under its older
    name). Releasing a page that is not outstanding raises.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (row 0 is the trash page)")
        self.capacity = num_pages - 1
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> low ids first
        self._outstanding: set[int] = set()
        self._refs: dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> frozenset[int]:
        """Snapshot of the allocated page ids."""
        return frozenset(self._outstanding)

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 for free/foreign pages)."""
        return self._refs.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._outstanding.update(pages)
        for p in pages:
            self._refs[p] = 1
        return pages

    def acquire(self, page: int) -> None:
        """Take one more reference on an already-outstanding page."""
        if page not in self._outstanding:
            raise ValueError(f"acquire on non-outstanding page {page}")
        self._refs[page] += 1

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page; a page whose count reaches zero
        returns to the free list."""
        for p in pages:
            if p not in self._outstanding:
                raise ValueError(f"double-free / foreign page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._outstanding.remove(p)
                self._free.append(p)

    free = release

    def check(self) -> None:
        """Invariant: every page is exactly one of {free, outstanding}, and
        every outstanding page carries a positive refcount."""
        assert len(self._free) + len(self._outstanding) == self.capacity, \
            (len(self._free), len(self._outstanding), self.capacity)
        assert not (set(self._free) & self._outstanding)
        assert set(self._refs) == self._outstanding, \
            (set(self._refs), self._outstanding)
        assert all(c >= 1 for c in self._refs.values()), self._refs


# ---------------------------------------------------------------------------
# Content-addressed prefix cache
# ---------------------------------------------------------------------------

class PrefixCache:
    """Content-addressed map from chained page hashes to pool rows.

    A prompt is hashed one *full page* at a time: page j's key chains page
    j-1's key with page j's token ids (:meth:`chain_key`, blake2b over the
    raw ids), so a hit on page j implies every earlier page hit too, and two
    prompts share a cached page iff they share the whole page-aligned
    prefix. The cache holds one allocator reference per cached page; every
    slot that maps a cached page holds its own on top. :meth:`evict` drops
    LRU entries whose page nobody else references.
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        self._alloc = allocator
        self.page_size = page_size
        self._map: OrderedDict[bytes, int] = OrderedDict()  # key -> page, LRU
        self._by_page: dict[int, bytes] = {}
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._map)

    @property
    def pages(self) -> frozenset[int]:
        """Pages the cache itself holds a reference on."""
        return frozenset(self._by_page)

    @staticmethod
    def chain_key(prev: bytes | None, tokens) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(prev if prev is not None else b"\x00root")
        h.update(np.asarray(list(tokens), np.int64).tobytes())
        return h.digest()

    def page_keys(self, tokens) -> list[bytes]:
        """Chained keys for every full page of ``tokens`` (the ragged tail is
        never cached)."""
        keys: list[bytes] = []
        prev = None
        ps = self.page_size
        for j in range(len(tokens) // ps):
            prev = self.chain_key(prev, tokens[j * ps:(j + 1) * ps])
            keys.append(prev)
        return keys

    def lookup(self, keys: list[bytes]) -> list[int]:
        """Longest leading run of cached pages for ``keys``; acquires one
        reference per returned page (the caller owns them until release)."""
        out: list[int] = []
        for k in keys:
            p = self._map.get(k)
            if p is None:
                break
            self._map.move_to_end(k)
            self._alloc.acquire(p)
            out.append(p)
        self.hits += len(out)
        self.misses += len(keys) - len(out)
        return out

    def insert(self, key: bytes, page: int) -> bool:
        """Cache ``page`` under ``key`` (acquiring a reference). No-op if the
        key is already cached: the first producer wins."""
        if key in self._map:
            return False
        self._alloc.acquire(page)
        self._map[key] = page
        self._by_page[page] = key
        self.inserts += 1
        return True

    def invalidate(self, key: bytes) -> bool:
        """Drop one entry (a page produced by a slot whose model state went
        non-finite). Releases the cache's reference; sharers keep theirs."""
        p = self._map.pop(key, None)
        if p is None:
            return False
        del self._by_page[p]
        self._alloc.release([p])
        self.invalidations += 1
        return True

    def evict(self, n: int) -> int:
        """Release up to ``n`` LRU pages referenced *only* by the cache.
        Returns how many pages went back to the free list."""
        freed = 0
        for k, p in list(self._map.items()):
            if freed >= n:
                break
            if self._alloc.refcount(p) == 1:  # nobody else: safe to drop
                del self._map[k]
                del self._by_page[p]
                self._alloc.release([p])
                self.evictions += 1
                freed += 1
        return freed

    def stats(self) -> dict:
        return {"prefix_cache_pages": len(self._map),
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_inserts": self.inserts,
                "prefix_evictions": self.evictions,
                "prefix_invalidations": self.invalidations}
