"""Prefix cache: copy-on-write sharing of prompt-prefix KV pages.

A copy of ``repro/serving/prefix_cache.py`` (the port imports nothing of
the JAX package).

At production traffic shapes the same system prompt / few-shot template
heads almost every request, yet the paged engine without it re-prefills each
one from scratch — pure wasted HBM traffic and compute, exactly the
memory-overhead class the MatrixFlow dataflow exists to remove. This
module makes the ``PagePool``'s ref counts earn their keep:

* **Index** — a radix tree over *page-granular* token spans. Every node
  covers one full page (``page_size`` prompt tokens) and is keyed by a
  chained content hash ``h_j = hash((h_{j-1}, tokens_j))`` (a rolling
  hash over page spans, so a prefix's identity folds in everything before
  it); the node also stores its raw token span, which is compared exactly
  on every walk — a hash collision degrades to a miss, never to sharing
  the wrong KV.
* **Lookup** (:meth:`PrefixCache.lookup`) walks the tree over a prompt
  and returns the longest cached chain of full pages, each **retained**
  on behalf of the requester, plus — when the walk dies *inside* a cached
  page — the copy-on-write candidate: the first divergent page and how
  many of its leading rows match. The engine forks that page
  (``PagePool.fork`` + a device copy), so even a partially-matching page
  skips prefill for its matching rows while writes only ever touch the
  private copy.
* **Insert** (:meth:`PrefixCache.insert`) registers a finished prefill's
  full prompt pages. The cache itself retains each page — a retired
  request's prefix stays resident (a *cold* entry, refcount 1) until
  evicted.
* **Eviction** (:meth:`PrefixCache.evict`) walks leaves in LRU order and
  drops the cache's reference when the pool runs low (the engine calls it
  when ``free_pages`` falls under its watermark and on-demand before
  giving up on an admission). Evicting an entry other requests still hold
  merely makes it undiscoverable; their references keep the page alive.

At most ``len(prompt) - 1`` tokens are ever served from cache: the last
prompt token must run through the model so its logits can seed sampling.

Everything here is host-side bookkeeping over token ids and page ids; the
device only ever sees the block tables the engine assembles from it
(serving/engine.py) — which is also why tensor-parallel serving needs no
changes: one host-side cache drives every shard's identical page slice
(docs/serving.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Counter
from repro_torch.serving.kv_pool import PagePool

__all__ = ["PrefixCache", "PrefixHit"]


class _Node:
    """One cached page span: ``tokens`` (exactly ``page_size`` ids), the
    physical ``page`` holding its K/V, and the chained content hash that
    indexes it among its parent's children."""

    __slots__ = ("tokens", "page", "chain_hash", "parent", "children",
                 "tick")

    def __init__(self, tokens: Tuple[int, ...], page: int, chain_hash: int,
                 parent: "_Node"):
        self.tokens = tokens
        self.page = page
        self.chain_hash = chain_hash
        self.parent = parent
        self.children: Dict[int, _Node] = {}
        self.tick = 0


@dataclasses.dataclass
class PrefixHit:
    """What :meth:`PrefixCache.lookup` hands the engine.

    ``pages`` are fully-matching pages, already retained for this holder
    (the engine appends them to the request's block table verbatim).
    ``cow_page``/``cow_tokens`` describe the first divergent page: its
    leading ``cow_tokens`` rows match the prompt, so the engine may fork
    it — copy the device contents into a private page — and start prefill
    at ``n_tokens + cow_tokens`` instead of ``n_tokens``. The COW source
    is retained too (eviction between lookup and copy must not free it);
    the engine releases it after the copy, or via :meth:`release` when
    admission falls through.
    """

    pages: List[int]
    n_tokens: int
    cow_page: Optional[int] = None
    cow_tokens: int = 0

    @property
    def tokens_reusable(self) -> int:
        return self.n_tokens + self.cow_tokens

    def release(self, pool: PagePool) -> None:
        """Drop the holder references lookup took (admission failed)."""
        if self.pages:
            pool.release(self.pages)
            self.pages = []
        if self.cow_page is not None:
            pool.release([self.cow_page])
            self.cow_page = None
            self.cow_tokens = 0


class PrefixCache:
    """Radix tree of cached prompt-prefix pages over one :class:`PagePool`.

    The cache holds one pool reference per indexed page; requests that hit
    add their own. LRU recency is a logical ``tick`` bumped on every
    lookup/insert touch — leaves with the stalest tick evict first (a
    parent is only evictable once its children are gone, keeping every
    cached chain walkable from the root).
    """

    def __init__(self, pool: PagePool, page_size: Optional[int] = None,
                 metrics=None):
        self.pool = pool
        self.page_size = int(page_size or pool.page_size)
        if self.page_size != pool.page_size:
            raise ValueError(
                f"prefix cache page_size={page_size} must equal the pool's "
                f"page_size={pool.page_size} (pages are shared verbatim)")
        self._root = _Node((), -1, hash(("prefix-root",)), None)
        self._tick = 0
        self.n_nodes = 0
        # Counters (surfaced by ServingEngine.stats() and, with ``metrics``
        # — a repro_torch.obs.Metrics registry — in its snapshot()). First-class
        # Counter instruments either way; the int-valued properties below
        # keep the historical ``cache.hits == 1`` comparisons working.
        reg = metrics.counter if metrics is not None \
            else (lambda name: Counter(name))
        self._hits = reg("prefix_hits_total")
        self._misses = reg("prefix_misses_total")
        self._evictions = reg("prefix_evictions_total")
        self._cow_forks = reg("prefix_cow_forks_total")
        self._hit_tokens = reg("prefix_hit_tokens_total")
        self._lookup_tokens = reg("prefix_lookup_tokens_total")

    # -- internals ----------------------------------------------------------
    def _child_matching(self, node: _Node, span: Tuple[int, ...]
                        ) -> Optional[_Node]:
        """The child holding exactly ``span``, found via the chained hash
        and verified token-exact (collision → miss)."""
        child = node.children.get(hash((node.chain_hash, span)))
        if child is not None and child.tokens == span:
            return child
        return None

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        while node is not None and node is not self._root:
            node.tick = self._tick
            node = node.parent

    # -- queries ------------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest cached prefix of ``tokens``, capped at ``len - 1`` (the
        final token always prefills — its logits seed the first sample).
        Full-page matches come back retained in ``pages``; a partial match
        of the next page comes back as the COW candidate."""
        tokens = [int(t) for t in tokens]
        limit = len(tokens) - 1
        ps = self.page_size
        node, m = self._root, 0
        pages: List[int] = []
        while m + ps <= limit:
            child = self._child_matching(node, tuple(tokens[m:m + ps]))
            if child is None:
                break
            pages.append(child.page)
            node = child
            m += ps
        # first divergent page: the child sharing the longest leading run
        # with what remains of the prompt (< one page) is worth forking
        cow_node, cow_len = None, 0
        rem = tokens[m:limit]
        if rem:
            for child in node.children.values():
                r = 0
                for a, b in zip(child.tokens, rem):
                    if a != b:
                        break
                    r += 1
                if r > cow_len:
                    cow_node, cow_len = child, r
        if pages:
            self.pool.retain(pages)
        if cow_node is not None:
            self.pool.retain([cow_node.page])
            self._touch(cow_node)
        elif node is not self._root:
            self._touch(node)
        return PrefixHit(pages=pages, n_tokens=m,
                         cow_page=None if cow_node is None
                         else cow_node.page,
                         cow_tokens=cow_len)

    def record(self, hit: PrefixHit, n_tokens: int) -> None:
        """Fold one *committed* admission into the hit-rate counters. The
        engine calls this once per successful admit; lookups whose admission
        falls through (pool full, preempt-retry loops) count nothing, so
        the reported rate reflects tokens actually served from cache."""
        self._lookup_tokens.inc(n_tokens)
        self._hit_tokens.inc(hit.tokens_reusable)
        if hit.tokens_reusable:
            self._hits.inc()
        else:
            self._misses.inc()

    def note_cow_fork(self) -> None:
        """Count one committed copy-on-write fork. The engine calls this
        after the fork + device copy succeed (the pool's own fork counter
        fires at allocation; this one counts prefix-cache-driven forks)."""
        self._cow_forks.inc()

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index every *full* page of ``tokens`` (``pages[j]`` backing
        span ``[j*ps, (j+1)*ps)`` — the head of a request's block table
        after its prompt prefill completes). Spans already cached keep
        their existing page; new spans retain theirs on behalf of the
        cache. Returns the number of newly indexed pages."""
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        node, added = self._root, 0
        for j in range(len(tokens) // ps):
            span = tuple(tokens[j * ps:(j + 1) * ps])
            child = self._child_matching(node, span)
            if child is None:
                key = hash((node.chain_hash, span))
                if key in node.children:
                    # hash collision with a different span: leave the
                    # incumbent indexed; deeper spans of this prompt would
                    # dangle off an unshareable chain, so stop here
                    break
                child = _Node(span, int(pages[j]), key, node)
                node.children[key] = child
                self.pool.retain([child.page])
                self.n_nodes += 1
                added += 1
            node = child
        if node is not self._root:
            self._touch(node)
        return added

    # -- eviction -----------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def reclaimable(self) -> int:
        """Pages eviction could return to the free list *right now*: cached
        pages no live request holds (refcount exactly 1 — the cache's)."""
        stack = list(self._root.children.values())
        n = 0
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if self.pool.refcount[node.page] == 1:
                n += 1
        return n

    def evict(self, n_pages: int) -> int:
        """Drop cache references, coldest leaves first, until ``n_pages``
        have actually been freed (refcount hit 0) or nothing evictable
        remains. Returns the number of pages freed to the pool. Entries
        whose pages live requests still hold are uncached too when their
        turn comes — they stop being discoverable but free nothing yet."""
        freed = 0
        while freed < n_pages:
            leaves = self._leaves()
            if not leaves:
                break
            # coldest first; among equals prefer deeper nodes (suffix pages
            # are less shareable than the system-prompt head)
            victim = min(leaves, key=lambda n: (n.tick, -self._depth(n)))
            freed += self._drop(victim)
        return freed

    def _depth(self, node: _Node) -> int:
        d = 0
        while node.parent is not None:
            d += 1
            node = node.parent
        return d

    def _drop(self, node: _Node) -> int:
        """Unlink one leaf and release the cache's reference; returns 1 if
        the page actually went free (no other holders)."""
        assert not node.children, "evict only detaches leaves"
        del node.parent.children[node.chain_hash]
        self.n_nodes -= 1
        self._evictions.inc()
        was_last = self.pool.refcount[node.page] == 1
        self.pool.release([node.page])
        return int(was_last)

    def clear(self) -> int:
        """Release every cached page (engine reset, e.g. batched
        generate() taking over the whole pool). Returns pages freed."""
        freed = 0
        while self._root.children:
            freed += self.evict(self.n_nodes)
        return freed

    # -- stats / invariants -------------------------------------------------
    @property
    def hits(self) -> int:
        """Committed admissions reusing >= 1 cached token."""
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def cow_forks(self) -> int:
        return self._cow_forks.value

    @property
    def hit_tokens(self) -> int:
        """Tokens served from cache across committed admissions."""
        return self._hit_tokens.value

    @property
    def lookup_tokens(self) -> int:
        """Tokens presented across committed admissions."""
        return self._lookup_tokens.value

    @property
    def cached_pages(self) -> int:
        return self.n_nodes

    def hit_rate(self) -> float:
        """Fraction of looked-up tokens served from cache."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_hits": self.hits, "prefix_misses": self.misses,
            "prefix_evictions": self.evictions,
            "prefix_cow_forks": self.cow_forks,
            "prefix_cached_pages": self.n_nodes,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_lookup_tokens": self.lookup_tokens,
            "prefix_hit_rate": round(self.hit_rate(), 4),
        }

    def check(self) -> None:
        """Structural invariants (tests): every node's page is allocated,
        chain hashes match their recomputation, node count agrees."""
        n, stack = 0, [(self._root, self._root.chain_hash)]
        while stack:
            node, h = stack.pop()
            for child in node.children.values():
                assert child.parent is node
                assert len(child.tokens) == self.page_size
                assert child.chain_hash == hash((h, child.tokens))
                assert self.pool.refcount[child.page] >= 1, \
                    f"cached page {child.page} not allocated"
                n += 1
                stack.append((child, child.chain_hash))
        assert n == self.n_nodes, (n, self.n_nodes)
