"""Paged KV cache in device memory.

Port of `ray_tpu/serve/llm/kv_cache.py` with the same accounting. The
arena is ONE device tensor [2, num_pages, n_layer, block_size,
n_kv_head, head_dim] (index 0 is K, 1 is V), cut into fixed-size pages.
The engine hands the decode forward the whole arena plus per-sequence
page tables (gather indices): growing a sequence never moves bytes, it
only appends a page id. `append` and `write_prefill` are device
index-copies into the arena.

Pages are REFCOUNTED: a page can be held by several sequences at once
(copy-on-write shared-prefix reuse, `PrefixCache`), and it returns to
the free list only when its last holder releases it. Accounting is
strict: every page is either free or held, `free()` by a non-holder
raises, and `assert_quiesced()` proves zero sequence-live pages. Pages
held only by the prefix cache count as quiesced (reusable state, not
leaks); draining the cache returns them.

Copy-on-write discipline: only FULL pages are ever shared (a partial
page's tail is still being appended to), so a shared page is immutable
by construction — aliasing is a page-table edit plus a refcount, never a
byte copy.

On a dead replica the arena is reclaimed store-side by id
(`reclaim_arena`), as in the JAX package: with `store=` the arena's id
names a sealed object in the node's shared-memory store, so peers on the
node see it via `contains` and force-delete it even though the dead
process never released its creator reference. On the CPU that object IS
the arena (a tensor view over the store's bytes, as the JAX arena is a
numpy view). On the card the arena stays device memory, read in place
by the captured decode graphs, and the CUDA driver frees it when the
process exits; the store object is then a small arena RECORD (shape,
dtype, device index, bytes, pid, as JSON), so the controller's reclaim
and its counter behave as in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch import resolve_device

# torch is imported where a cache touches tensors, not with the module:
# Serve's controller imports `reclaim_arena` and never needs torch


class KVCacheError(RuntimeError):
    pass


class OutOfPagesError(KVCacheError):
    """Allocation would exceed the arena; caller should queue, not crash."""


class PagedKVCache:
    """Fixed-size K/V page allocator over one device arena.

    `k_pages`/`v_pages` are views [num_pages, n_layer, block_size,
    n_kv_head, head_dim] of the arena, handed to the decode forward with
    per-sequence page-table rows.

    `store=None` keeps the arena process-local; with the node's
    `ObjectStore` it is published there under `arena_id_hex` (the arena
    itself on the CPU, the arena record on the card; module docstring).
    """

    def __init__(self, num_pages: int, n_layer: int, block_size: int,
                 n_kv_head: int, head_dim: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 store=None):
        import torch

        dtype = dtype or torch.float32
        if num_pages <= 0 or block_size <= 0:
            raise KVCacheError("num_pages and block_size must be positive")
        self.num_pages = num_pages
        self.n_layer = n_layer
        self.block_size = block_size
        self.n_kv_head = n_kv_head
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self._store = store
        self._arena_id = None
        self._lock = threading.Lock()
        shape = (2, num_pages, n_layer, block_size, n_kv_head, head_dim)
        nbytes = math.prod(shape) * dtype.itemsize
        if store is not None:
            from ray_tpu_torch._private.ids import ObjectID
            self._arena_id = ObjectID.from_random()
            if self.device.type == "cpu":
                buf = store.create_buffer(self._arena_id, nbytes)
                self._arena = torch.frombuffer(buf, dtype=dtype).view(shape)
            else:
                self._arena = torch.empty(shape, dtype=dtype,
                                          device=self.device)
                record = json.dumps({
                    "shape": list(shape), "dtype": str(dtype),
                    "device": str(self._arena.device), "nbytes": nbytes,
                    "pid": os.getpid()}).encode()
                buf = store.create_buffer(self._arena_id, len(record))
                buf[:] = record
            # Seal immediately (the arena stays mutable through our view;
            # seal only publishes the id so `contains`/`delete` work from
            # peer processes for dead-replica reclaim). The creator
            # reference is kept until close().
            store.seal(self._arena_id)
            self._arena.zero_()
        else:
            self._arena = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_pages = self._arena[0]
        self.v_pages = self._arena[1]
        # LIFO free list: recently-freed pages are re-used first (warm)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        # page -> holder list (refcount == len). A holder is a request/
        # sequence object, or a _PrefixEntry when the prefix cache
        # pinned the page for reuse.
        self._holders: Dict[int, List[object]] = {}
        self._prefix_cache: Optional["PrefixCache"] = None
        self._closed = False

    # -- allocation -------------------------------------------------------

    @property
    def arena_id_hex(self) -> Optional[str]:
        return self._arena_id.hex() if self._arena_id is not None else None

    @property
    def arena_nbytes(self) -> int:
        return int(self._arena.nbytes)

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages held by at least one sequence (prefix-cache-only pages
        are reusable state, not live work — see `cached_pages`)."""
        with self._lock:
            return sum(1 for hs in self._holders.values()
                       if any(not isinstance(h, _PrefixEntry) for h in hs))

    @property
    def cached_pages(self) -> int:
        """Pages held ONLY by the prefix cache (reusable on hit,
        evictable under pressure)."""
        with self._lock:
            return sum(1 for hs in self._holders.values()
                       if all(isinstance(h, _PrefixEntry) for h in hs))

    def utilization(self) -> float:
        with self._lock:
            return len(self._holders) / self.num_pages

    def page_refcount(self, page: int) -> int:
        with self._lock:
            return len(self._holders.get(page, ()))

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)  # ceil div

    def alloc(self, n: int, owner) -> List[int]:
        """Take `n` pages for `owner`; raises OutOfPagesError when the
        arena can't satisfy the request (nothing is partially taken).
        On shortfall, cold prefix-cache entries are evicted LRU-first
        before giving up — cached prefixes never crowd out live work."""
        with self._lock:
            return self._alloc_locked(n, owner)

    def _alloc_locked(self, n: int, owner) -> List[int]:
        self._check_open()
        if n > len(self._free) and self._prefix_cache is not None:
            self._prefix_cache._evict_for_locked(n - len(self._free))
        if n > len(self._free):
            raise OutOfPagesError(
                f"need {n} pages, {len(self._free)} free "
                f"of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._holders[p] = [owner]
        return pages

    def share(self, pages: List[int], owner) -> None:
        """Alias already-allocated pages into `owner`'s page table
        (incref). The pages must be live; the same owner may not hold a
        page twice (accounting bugs fail loudly)."""
        with self._lock:
            self._share_locked(pages, owner)

    def _share_locked(self, pages: List[int], owner) -> None:
        self._check_open()
        for p in pages:
            hs = self._holders.get(p)
            if hs is None:
                raise KVCacheError(f"share of free page {p}")
            if any(h is owner for h in hs):
                raise KVCacheError(
                    f"share of page {p} already held by this owner")
        for p in pages:
            self._holders[p].append(owner)

    def free(self, pages: List[int], owner) -> None:
        """Release `owner`'s hold on each page; a page returns to the
        free list only at refcount zero. Raises on double-free or a page
        the owner doesn't hold."""
        with self._lock:
            self._free_locked(pages, owner)

    def _free_locked(self, pages: List[int], owner) -> None:
        self._check_open()
        for p in pages:
            hs = self._holders.get(p)
            if hs is None or not any(h is owner for h in hs):
                held = "free" if hs is None else f"held by {hs!r}"
                raise KVCacheError(
                    f"free of page {p} not held by owner ({held})")
        for p in pages:
            hs = self._holders[p]
            for i, h in enumerate(hs):
                if h is owner:
                    del hs[i]
                    break
            if not hs:
                del self._holders[p]
                self._free.append(p)

    # -- data plane -------------------------------------------------------
    # Writes are lock-free by design: the engine's step thread is the
    # single writer, and an appendable (tail) page belongs to exactly one
    # sequence — shared prefix pages are always full, so no write lands
    # on an aliased page (the lock guards only the allocator maps).

    def append(self, pages: List[int], pos: int, k, v) -> None:
        """Write one token's K/V ([n_layer, n_kv_head, head_dim]) at
        logical position `pos` of a sequence holding `pages`."""
        page = pages[pos // self.block_size]
        off = pos % self.block_size
        self.k_pages[page, :, off] = self._on_arena(k)
        self.v_pages[page, :, off] = self._on_arena(v)

    def write_prefill(self, pages: List[int], k_seq, v_seq, n: int,
                      start: int = 0) -> None:
        """Bulk-write a prefill's K/V ([>= n, n_layer, n_kv_head,
        head_dim]) for positions [start, start+n) across the sequence's
        pages (chunked prefill passes start > 0, which need not be
        page-aligned). One index-copy each for K and V."""
        import torch

        pos = torch.arange(start, start + n)
        page_of = torch.as_tensor(pages, dtype=torch.long)[
            pos // self.block_size]
        page_of = page_of.to(self.device)
        off = (pos % self.block_size).to(self.device)
        # advanced indices split by the layer slice go first: the target
        # is [n, n_layer, kvh, hd], the prefill slab's own layout
        self.k_pages[page_of, :, off] = self._on_arena(k_seq[:n])
        self.v_pages[page_of, :, off] = self._on_arena(v_seq[:n])

    def _on_arena(self, x):
        # tensors already on the arena's device and dtype pass unchanged
        import torch

        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- lifecycle --------------------------------------------------------

    def assert_quiesced(self) -> None:
        """Prove zero sequence-live pages. Pages held only by the
        prefix cache are quiesced state (drain the cache to release
        them); any other holder is a leak."""
        with self._lock:
            live = {p: hs for p, hs in self._holders.items()
                    if any(not isinstance(h, _PrefixEntry) for h in hs)}
            if live:
                owners = sorted({repr(h) for hs in live.values()
                                 for h in hs
                                 if not isinstance(h, _PrefixEntry)})
                raise KVCacheError(
                    f"KV page leak: {len(live)} live pages at "
                    f"quiesce (owners: {owners[:4]})")
            if len(self._free) + len(self._holders) != self.num_pages:
                raise KVCacheError(
                    f"free-list corrupt: {len(self._free)} free + "
                    f"{len(self._holders)} held != {self.num_pages}")

    def close(self) -> int:
        """Drop the arena. Returns the number of pages still
        sequence-live (0 when the engine quiesced cleanly; prefix-cache
        holds are not leaks — `PrefixCache.drain()` first for a strict
        zero-held close)."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            leaked = sum(1 for hs in self._holders.values()
                         if any(not isinstance(h, _PrefixEntry)
                                for h in hs))
            self.k_pages = self.v_pages = None
            self._arena = None
            if self._store is not None and self._arena_id is not None:
                try:
                    self._store.release(self._arena_id)
                    self._store.delete(self._arena_id)
                except Exception:
                    pass  # store already torn down
            return leaked

    def _check_open(self):
        if self._closed:
            raise KVCacheError("KV cache is closed")


class _PrefixEntry:
    """One cached full-page-aligned prompt prefix: the holder token for
    its pages' prefix-cache refs."""

    __slots__ = ("key", "pages", "hits")

    def __init__(self, key: Tuple[int, ...], pages: List[int]):
        self.key = key
        self.pages = pages
        self.hits = 0

    def __repr__(self):
        return f"PrefixEntry({len(self.pages)}p, hits={self.hits})"


class PrefixCache:
    """Copy-on-write shared-prefix page cache over a `PagedKVCache`.

    Maps full-page-aligned prompt prefixes (keyed by the exact token
    tuple — no hash collisions) to the page ids that hold their K/V.
    Admission (`acquire`) aliases the longest matching cached prefix
    into the new sequence's page table (incref, zero bytes copied) and
    allocates only the pages the uncached suffix needs, so prefill runs
    only past the cached boundary. The last prompt token is never
    aliased (the engine needs its forward pass for next-token logits),
    and a partial page is never cached (its tail is still appended to).

    The lookup, the alias (incref) and the remainder allocation happen
    under ONE lock hold — check-then-alias across a lock release would
    race eviction. Eviction is LRU and only triggered by arena pressure:
    `PagedKVCache._alloc_locked` calls back into `_evict_for_locked` on
    shortfall, releasing cold entries until the allocation fits — pages
    another sequence still holds survive their entry's eviction.
    """

    def __init__(self, kv: PagedKVCache):
        self.kv = kv
        # ONE lock with the allocator: atomic lookup+alias+alloc
        self._lock = kv._lock
        self._entries: "OrderedDict[Tuple[int, ...], _PrefixEntry]" = \
            OrderedDict()
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "hit_tokens": 0, "miss_tokens": 0,
            "inserted": 0, "evicted": 0,
        }
        kv._prefix_cache = self

    # -- admission --------------------------------------------------------

    def acquire(self, prompt: List[int], owner,
                total_pages: int) -> Tuple[List[int], int]:
        """Atomically: find the longest cached full-page prefix of
        `prompt`, alias its pages to `owner`, and allocate the
        remaining `total_pages - cached` fresh pages (evicting cold
        entries on shortfall). Returns (page list, cached token count).
        Raises OutOfPagesError leaving no partial state."""
        block = self.kv.block_size
        with self._lock:
            # never alias the page holding the last prompt token: at
            # least one suffix token must run prefill for next-logits
            kmax = (len(prompt) - 1) // block
            entry = None
            k = 0
            for kk in range(kmax, 0, -1):
                e = self._entries.get(tuple(prompt[:kk * block]))
                if e is not None:
                    entry, k = e, kk
                    break
            cached = list(entry.pages) if entry is not None else []
            self.kv._share_locked(cached, owner)
            try:
                fresh = self.kv._alloc_locked(total_pages - k, owner)
            except OutOfPagesError:
                self.kv._free_locked(cached, owner)
                raise
            if entry is not None:
                entry.hits += 1
                self._entries.move_to_end(entry.key)
                self.counters["hits"] += 1
                self.counters["hit_tokens"] += k * block
            else:
                self.counters["misses"] += 1
            self.counters["miss_tokens"] += len(prompt) - k * block
            return cached + fresh, k * block

    def insert(self, prompt: List[int], pages: List[int]) -> None:
        """Register every full-page-aligned prefix of a just-prefilled
        prompt (each becomes independently hittable/evictable). Only
        FULL pages are cached — they are immutable from here on."""
        block = self.kv.block_size
        with self._lock:
            if self.kv._closed:
                return
            kfull = len(prompt) // block
            for kk in range(1, kfull + 1):
                key = tuple(prompt[:kk * block])
                if key in self._entries:
                    continue
                e = _PrefixEntry(key, list(pages[:kk]))
                self.kv._share_locked(e.pages, e)
                self._entries[key] = e
                self.counters["inserted"] += 1

    # -- eviction / lifecycle ---------------------------------------------

    def _evict_for_locked(self, shortfall: int) -> None:
        """Release cold entries LRU-first until `shortfall` pages came
        free or nothing evictable remains (caller holds kv lock)."""
        freed = 0
        for key in list(self._entries):
            if freed >= shortfall:
                break
            e = self._entries.pop(key)
            before = len(self.kv._free)
            self.kv._free_locked(e.pages, e)
            freed += len(self.kv._free) - before
            self.counters["evicted"] += 1

    def drain(self) -> None:
        """Release every cached prefix (shutdown path: after drain, a
        quiesced cache closes with zero held pages)."""
        with self._lock:
            for key in list(self._entries):
                e = self._entries.pop(key)
                self.kv._free_locked(e.pages, e)

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counters)
            out["entries"] = len(self._entries)
            return out


def reclaim_arena(arena_id_hex: str, store=None) -> bool:
    """Force-delete a (possibly dead) replica's KV arena by id from any
    process attached to the same node store. Returns True when the arena
    was present and is now gone."""
    if store is None:
        from ray_tpu_torch._private.object_ref import get_core_worker
        cw = get_core_worker()
        if cw is None or cw.store is None:
            return False
        store = cw.store
    from ray_tpu_torch._private.ids import ObjectID
    oid = ObjectID.from_hex(arena_id_hex)
    if not store.contains(oid):
        return False
    store.delete(oid)
    return not store.contains(oid)
