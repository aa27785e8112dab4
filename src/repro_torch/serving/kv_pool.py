"""Page pool for the paged KV cache: fixed-size pages, free list, ref counts.

A numpy-only copy of ``repro/serving/kv_pool.py`` (the port imports nothing
of the JAX package), without its metrics binding.

The contiguous serving cache reserves ``batch_slots × max_len`` KV rows —
memory scales with the *worst case* length of every slot. This module is
the allocator side of the paged subsystem (docs/serving.md): the cache is a
pool of fixed-size pages (``page_size`` tokens each, sized to the paged
attention kernel's key-block — ``kernels/paged_attention.py``), requests
own pages through per-request :class:`BlockTable`\\ s, and memory scales
with the tokens actually resident. Admission becomes **page-bound** instead
of slot-bound, and when the pool runs dry the engine spills the lowest-
priority request back to its wait queue (``serving/engine.py`` owns that
scheduling decision; the pool owns the accounting it relies on).

Everything here is host-side bookkeeping (plain ints/numpy) — the device
only ever sees the resulting ``(B, n_blocks)`` int32 block-table array and
the page-pool tensors it indexes.

With the prefix cache (``serving/prefix_cache.py``) pages ARE shared:
a cached prompt-prefix page carries one reference per holding request
plus one for the cache itself, and a request that must write into a
shared page first **forks** it — :meth:`PagePool.fork` allocates the
copy-target, the engine copies the device contents, and the writer's
block table swaps in the private page (copy-on-write).

Invariants (property-tested in tests/test_kv_pool.py):

  * a page is either on the free list or referenced, never both;
    ``free_pages + pages_in_use == n_pages`` at all times;
  * a page referenced by more than one holder is never *written* — the
    engine only writes pages it allocated or forked (refcount-1 at write
    time); releasing one holder of a shared span leaves it resident;
  * release is idempotent-safe only through ownership: double-free raises.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["PagePool", "BlockTable", "PoolExhausted", "pages_needed"]


class PoolExhausted(RuntimeError):
    """Raised by :meth:`PagePool.alloc` when the free list cannot cover a
    request — the engine's cue to preempt or defer."""


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` cache slots (ceil division; 0 → 0)."""
    return -(-n_tokens // page_size)


class PagePool:
    """A pool of ``n_pages`` KV pages of ``page_size`` tokens each.

    ``alloc`` pops from the free list and sets the page's ref count to 1;
    ``release`` decrements and returns count-0 pages to the free list.
    ``retain`` adds a reference for sharing — the prefix cache
    (serving/prefix_cache.py) retains every page it indexes and each
    hitting request retains the pages it borrows. ``fork`` is the
    allocation half of copy-on-write: it hands out the private target a
    shared page's contents are copied into before the first write.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"PagePool needs n_pages >= 1 and page_size >= 1, got "
                f"n_pages={n_pages}, page_size={page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # popped from the tail → ascending page ids first (determinism)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refcount = np.zeros(n_pages, np.int64)
        # peak pages simultaneously referenced, for capacity reporting
        # (ServingEngine.stats(), benchmarks/serving_sweep.py)
        self.high_water = 0
        # called with the page id whenever a page returns to the free list
        # (eviction hooks: per-shard TP pools assert lockstep, tests audit
        # reclamation without polling)
        self._free_hooks: List[Callable[[int], None]] = []

    # -- accounting ---------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    def add_free_hook(self, hook: Callable[[int], None]) -> None:
        """Register ``hook(page_id)`` to run whenever a page's last
        reference drops and it rejoins the free list."""
        self._free_hooks.append(hook)

    def pages_needed(self, n_tokens: int) -> int:
        return pages_needed(n_tokens, self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_pages

    # -- alloc / free -------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` pages off the free list (ref count 1 each); raises
        :class:`PoolExhausted` without side effects when short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.free_pages:
            raise PoolExhausted(
                f"need {n} pages, {self.free_pages} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] += 1
        self.high_water = max(self.high_water, self.pages_in_use)
        return pages

    def fork(self, src: int) -> int:
        """Copy-on-write allocation: hand out a private page to receive a
        copy of shared page ``src``. The pool only does the accounting —
        the engine owns the device-side content copy (the (page_size, Hkv,
        dh) slab per layer) and the block-table swap. Raises PoolExhausted
        when no page is free, ValueError when ``src`` isn't allocated."""
        if self.refcount[src] <= 0:
            raise ValueError(f"fork of unallocated page {src}")
        return self.alloc(1)[0]

    def retain(self, pages: Sequence[int]) -> None:
        """Add a reference to already-allocated pages (sharing)."""
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(f"retain of unallocated page {p}")
        self.refcount[list(pages)] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; count-0 pages rejoin the free list.

        All-or-nothing, like :meth:`alloc`: the whole sequence is validated
        (counting duplicates — releasing a page twice in one call needs two
        references) before any ref count moves, so a double free raises with
        the pool untouched."""
        drops = collections.Counter(int(p) for p in pages)
        for p, n in drops.items():
            if not 0 <= p < self.n_pages:
                raise ValueError(f"release of unknown page {p}")
            if self.refcount[p] < n:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            p = int(p)
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                for hook in self._free_hooks:
                    hook(p)

    def check(self) -> None:
        """Assert the free-list/ref-count invariants (tests, debugging)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entries"
        used = {int(p) for p in np.nonzero(self.refcount > 0)[0]}
        assert not (free & used), f"pages both free and referenced: {free & used}"
        assert len(free) + len(used) == self.n_pages, (
            f"page leak: {len(free)} free + {len(used)} used != {self.n_pages}")
        assert (self.refcount >= 0).all()


@dataclasses.dataclass
class BlockTable:
    """One request's logical-block → physical-page map.

    ``pages[j]`` backs logical key positions ``[j*ps, (j+1)*ps)``. The
    engine grows it one page at a time during decode (:meth:`ensure`) and
    renders it into the fixed-width device array with :meth:`as_row`
    (unallocated entries are 0 — any *valid* page id works, the kernel's
    length mask gives those keys zero weight).
    """

    pool: PagePool
    pages: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def capacity(self) -> int:
        """Token positions currently backed by pages."""
        return len(self.pages) * self.pool.page_size

    def ensure(self, n_tokens: int) -> List[int]:
        """Allocate pages until ``n_tokens`` positions are backed; returns
        the newly allocated pages. Raises PoolExhausted (allocating nothing)
        when the pool cannot cover the growth."""
        need = self.pool.pages_needed(n_tokens) - len(self.pages)
        if need <= 0:
            return []
        fresh = self.pool.alloc(need)
        self.pages.extend(fresh)
        return fresh

    def free(self) -> None:
        """Return every page to the pool (request retirement/preemption).
        ``pages`` is cleared only after the release succeeds — a failed
        (double-free) release leaves the table's ownership intact."""
        self.pool.release(self.pages)
        self.pages = []

    def truncate(self, n_tokens: int) -> List[int]:
        """Shrink the table to back only ``n_tokens`` positions, dropping
        this table's reference on every page past them; returns the
        dropped pages. The speculative-decoding rollback primitive
        (docs/serving.md#speculative-decoding): rejected drafted tokens
        live past the accepted length, so their *wholly-rejected* tail
        pages go back to the pool while the final partial page stays —
        its leading rows are still logical content, and stale rows beyond
        ``n_tokens`` are masked by the cache's valid length.

        Refcount/COW-safe by construction: only one *reference* per
        dropped page is released, so a page still held by the prefix
        cache (or any other sharer) stays resident for its other holders.
        Like :meth:`free`, the release is all-or-nothing — a failed
        release leaves the table's ownership record intact. Truncating to
        a count the table already fits (including repeat truncates to the
        same length) is a no-op returning ``[]``."""
        if n_tokens < 0:
            raise ValueError(f"truncate({n_tokens})")
        keep = self.pool.pages_needed(n_tokens)
        if keep >= len(self.pages):
            return []
        dropped = self.pages[keep:]
        self.pool.release(dropped)
        self.pages = self.pages[:keep]
        return dropped

    def as_row(self, n_blocks: int, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """The (n_blocks,) int32 device row; unallocated entries are 0."""
        if len(self.pages) > n_blocks:
            raise ValueError(
                f"block table holds {len(self.pages)} pages > n_blocks="
                f"{n_blocks}")
        if out is not None:
            if out.shape != (n_blocks,):
                raise ValueError(
                    f"as_row out buffer has shape {out.shape}, expected "
                    f"({n_blocks},)")
            if out.dtype != np.int32:
                raise ValueError(
                    f"as_row out buffer has dtype {out.dtype}, expected "
                    f"int32")
        row = out if out is not None else np.zeros(n_blocks, np.int32)
        row[:] = 0
        row[:len(self.pages)] = self.pages
        return row
