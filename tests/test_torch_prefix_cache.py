"""The port's prefix cache (repro_torch/serving/prefix_cache.py) and the
paged engine's prefix admission, against the JAX package.

The radix-cache unit tests (tests/test_prefix_cache.py's thirteen) run the
same operations through the reference's ``PagePool``/``PrefixCache`` and
the port's copies: every assertion of the reference test holds on both,
and the two sides' observations (pages, ref counts, hits, evictions,
stats) are equal. The engine tests (tests/test_serving.py's prefix tests)
serve the same prompts through the JAX engine and the port's engine
(``serving_pair``): greedy streams token-identical, the same hits, forks
and evictions, and the pool invariants on the port.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import numpy as np
import pytest
import serving_pair as SP

from repro.serving import kv_pool as jkv
from repro.serving import prefix_cache as jpc
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import kv_pool as tkv
from repro_torch.serving import prefix_cache as tpc

PS = 4  # page size of the unit tests, as the reference's


class _Side:
    """One package's pool and cache classes."""

    def __init__(self, kv, pc):
        self.PagePool, self.PrefixCache = kv.PagePool, pc.PrefixCache


REF, PORT = _Side(jkv, jpc), _Side(tkv, tpc)


def both(scenario):
    """Run ``scenario(side, log)`` on the reference and on the port; each
    side asserts the reference test's claims, and their logs must be
    equal."""
    logs = []
    for side in (REF, PORT):
        log = []
        scenario(side, log)
        logs.append(log)
    assert logs[0] == logs[1]
    return logs[1]


def make(side, n_pages=16):
    pool = side.PagePool(n_pages, PS)
    return pool, side.PrefixCache(pool)


def prefill(pool, cache, tokens):
    """A finished prefill + insert: allocate the prompt's pages and index
    the full ones; returns the request's pages."""
    pages = pool.alloc(pool.pages_needed(len(tokens)))
    cache.insert(tokens, pages[:len(tokens) // PS])
    return pages


def snap(pool, cache):
    return (pool.refcount.tolist(), pool.free_pages, cache.stats())


# -- the radix cache, unit by unit (tests/test_prefix_cache.py) ---------------

def test_page_size_must_match_pool():
    def s(side, log):
        pool = side.PagePool(4, 8)
        with pytest.raises(ValueError, match="page_size") as e:
            side.PrefixCache(pool, page_size=4)
        log.append(str(e.value))
    both(s)


def test_empty_cache_misses_cleanly():
    def s(side, log):
        pool, cache = make(side)
        hit = cache.lookup([1, 2, 3, 4, 5])
        assert hit.pages == [] and hit.cow_page is None
        assert hit.tokens_reusable == 0
        assert pool.pages_in_use == 0
        cache.record(hit, 5)
        assert cache.misses == 1 and cache.hits == 0
        assert cache.hit_rate() == 0.0
        log.append(snap(pool, cache))
    both(s)


def test_insert_then_lookup_shares_full_pages():
    def s(side, log):
        pool, cache = make(side)
        prompt = list(range(10))
        mine = prefill(pool, cache, prompt)
        assert cache.cached_pages == 2
        assert (pool.refcount[mine[:2]] == 2).all()
        hit = cache.lookup(prompt[:8] + [40, 41])
        assert hit.pages == mine[:2] and hit.n_tokens == 8
        assert (pool.refcount[mine[:2]] == 3).all()
        cache.record(hit, 10)
        assert cache.hits == 1 and cache.hit_tokens == 8
        log.append((mine, hit.pages, snap(pool, cache)))
        hit.release(pool)
        assert (pool.refcount[mine[:2]] == 2).all()
        log.append(snap(pool, cache))
    both(s)


def test_last_token_never_served_from_cache():
    def s(side, log):
        pool, cache = make(side)
        prompt = list(range(8))
        mine = prefill(pool, cache, prompt)
        hit = cache.lookup(prompt)
        assert hit.pages == mine[:1]
        assert hit.cow_page == mine[1] and hit.cow_tokens == 3
        assert hit.tokens_reusable == 7
        log.append((hit.pages, hit.cow_page, hit.cow_tokens))
        hit.release(pool)
        log.append(snap(pool, cache))
    both(s)


def test_cow_candidate_on_partial_page_match():
    def s(side, log):
        pool, cache = make(side)
        prompt = list(range(12))
        mine = prefill(pool, cache, prompt)
        hit = cache.lookup(prompt[:10] + [90, 91, 92])
        assert hit.pages == mine[:2] and hit.n_tokens == 8
        assert hit.cow_page == mine[2] and hit.cow_tokens == 2
        assert hit.tokens_reusable == 10
        assert pool.refcount[mine[2]] == 3
        log.append((hit.pages, hit.cow_page, snap(pool, cache)))
        hit.release(pool)
        assert pool.refcount[mine[2]] == 2
        log.append(snap(pool, cache))
    both(s)


def test_divergent_tokens_do_not_share():
    def s(side, log):
        pool, cache = make(side)
        a = prefill(pool, cache, [1, 2, 3, 4, 5, 6, 7, 8, 9])
        hit = cache.lookup([9, 9, 9, 9, 5, 6, 7, 8, 1])
        assert hit.pages == [] and hit.cow_page is None
        log.append((a, snap(pool, cache)))
    both(s)


def test_reinsert_keeps_incumbent_pages():
    def s(side, log):
        pool, cache = make(side)
        prompt = list(range(9))
        first = prefill(pool, cache, prompt)
        second = pool.alloc(3)
        added = cache.insert(prompt, second[:2])
        assert added == 0 and cache.cached_pages == 2
        hit = cache.lookup(prompt + [50])
        assert hit.pages == first[:2]
        log.append((first, second, hit.pages, snap(pool, cache)))
        hit.release(pool)
        pool.release(second)
        log.append(snap(pool, cache))
    both(s)


def test_lru_eviction_prefers_cold_chains():
    def s(side, log):
        pool, cache = make(side)
        cold = prefill(pool, cache, [1, 2, 3, 4, 5])
        hot = prefill(pool, cache, [6, 7, 8, 9, 10])
        pool.release(cold)
        pool.release(hot)
        cache.lookup([6, 7, 8, 9, 99]).release(pool)
        assert cache.evict(1) == 1
        assert cache.evictions == 1
        hit = cache.lookup([6, 7, 8, 9, 99])
        assert hit.pages == hot[:1]
        hit.release(pool)
        miss = cache.lookup([1, 2, 3, 4, 99])
        assert miss.pages == [] and miss.cow_page is None
        log.append((cold, hot, snap(pool, cache)))
    both(s)


def test_evicting_held_pages_frees_nothing_but_uncaches():
    def s(side, log):
        pool, cache = make(side, n_pages=4)
        mine = prefill(pool, cache, list(range(9)))
        assert cache.reclaimable() == 0
        freed = cache.evict(4)
        assert freed == 0
        assert cache.cached_pages == 0
        assert (pool.refcount[mine[:2]] == 1).all()
        log.append(snap(pool, cache))
        pool.release(mine)
        pool.check()
        assert pool.free_pages == 4
        log.append(snap(pool, cache))
    both(s)


def test_reclaimable_counts_only_cache_held_pages():
    def s(side, log):
        pool, cache = make(side)
        mine = prefill(pool, cache, list(range(9)))
        assert cache.reclaimable() == 0
        pool.release(mine)
        assert cache.reclaimable() == 2
        assert cache.evict(2) == 2
        pool.check()
        assert pool.free_pages == pool.n_pages
        log.append(snap(pool, cache))
    both(s)


def test_clear_releases_everything():
    def s(side, log):
        pool, cache = make(side)
        for base in (0, 100, 200):
            pool.release(prefill(pool, cache, [base + i for i in range(9)]))
        assert cache.cached_pages == 6
        assert cache.clear() == 6
        assert cache.cached_pages == 0
        pool.check()
        assert pool.free_pages == pool.n_pages
        log.append(snap(pool, cache))
    both(s)


def test_record_only_counts_committed_admissions():
    def s(side, log):
        pool, cache = make(side)
        mine = prefill(pool, cache, list(range(9)))
        for _ in range(5):
            cache.lookup(list(range(9)) + [77]).release(pool)
        assert cache.hits == 0 and cache.lookup_tokens == 0
        hit = cache.lookup(list(range(9)) + [77])
        cache.record(hit, 10)
        hit.release(pool)
        assert cache.hits == 1 and cache.hit_tokens == 8
        assert cache.lookup_tokens == 10
        assert cache.hit_rate() == 0.8
        stats = cache.stats()
        assert stats["prefix_hits"] == 1 and stats["prefix_hit_rate"] == 0.8
        log.append(snap(pool, cache))
        pool.release(mine)
    both(s)


def test_check_validates_structure():
    def s(side, log):
        pool, cache = make(side)
        mine = prefill(pool, cache, list(range(13)))
        cache.check()
        pool.release(mine)
        cache.check()
        log.append(snap(pool, cache))
        cache.clear()
        cache.check()
        log.append(snap(pool, cache))
    both(s)


# -- the engine's prefix admission (tests/test_serving.py) --------------------

@pytest.fixture(scope="module")
def setup():
    return SP.make_setup()


def _stepped(eng, hs, n):
    for _ in range(n):
        eng.step()
    return [list(eng.request_out[h]) for h in hs]


def test_prefix_cache_streams_identical(setup):
    """Prefix cache on: the port's streams equal the JAX engine's with the
    cache on and its own with the cache off, with the same hits, and fewer
    pages resident than without sharing."""
    shared = list(range(1, 17))
    prompts = [shared + [40 + i, 50 + i] for i in range(3)]
    base = dict(batch_slots=4, max_len=32, cache_pages=16)
    res = {}
    for pc in (False, True):
        jeng, eng = SP.pair(setup, prefix_cache=pc, **base)
        hs = [eng.submit(p) for p in prompts]
        jhs = [jeng.submit(p) for p in prompts]
        assert all(h is not None for h in hs)
        res[pc] = (_stepped(eng, hs, 5), _stepped(jeng, jhs, 5), eng, jeng)
    (off, joff, e0, _), (on, jon, e1, j1) = res[False], res[True]
    assert on == jon == off == joff
    st, jst = e1.stats(), j1.stats()
    assert st["prefix_hits"] == jst["prefix_hits"] == 2
    assert st["prefix_hit_tokens"] == jst["prefix_hit_tokens"] >= 2 * 16
    assert e1.pool.pages_in_use == j1.pool.pages_in_use \
        < e0.pool.pages_in_use
    e1.pool.check()
    e1.prefix.check()


def test_prefix_cache_cow_divergence_isolated(setup):
    """A request diverging inside a cached page forks it copy-on-write;
    both streams equal the JAX engine's and their solo runs."""
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    b = a[:6] + [60, 61, 62, 63]
    kw = dict(batch_slots=2, max_len=32, cache_pages=16)
    jeng, eng = SP.pair(setup, prefix_cache=True, **kw)
    hs = [eng.submit(a), eng.submit(b)]
    jhs = [jeng.submit(a), jeng.submit(b)]
    assert eng.prefix.cow_forks == jeng.prefix.cow_forks >= 1
    got, want = _stepped(eng, hs, 5), _stepped(jeng, jhs, 5)
    assert got == want
    for prompt, stream in zip((a, b), got):
        solo = SP.port_engine(setup, **kw)
        r = solo.submit(prompt)
        assert stream == [solo.step()[r] for _ in range(5)], prompt
    eng.pool.check()


def test_prefix_preempt_resume_streams_identical(setup):
    """Preempt/resume under prefix sharing and watermark eviction: streams
    equal the JAX engine's and the solo runs; the pool drains to exactly
    the cache-held pages."""
    kw = dict(batch_slots=2, max_len=24, cache_pages=4)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 11]]
    outs = []
    for eng in SP.pair(setup, prefix_cache=True, prefix_watermark=1, **kw):
        rids = [eng.submit(p) for p in prompts]
        assert all(r is not None for r in rids)
        for _ in range(80):
            eng.step()
            if not eng.slot_live.any() and not eng.wait:
                break
        assert eng.n_preemptions > 0
        assert not eng.slot_live.any() and not eng.wait
        eng.pool.check()
        eng.prefix.check()
        assert eng.pool.pages_in_use == eng.prefix.reclaimable()
        outs.append(([eng.request_out[r] for r in rids], eng.n_preemptions,
                     eng.prefix.stats()))
    assert outs[0] == outs[1]
    for p, stream in zip(prompts, outs[1][0]):
        solo = SP.port_engine(setup, **kw)
        r = solo.submit(p)
        want = []
        while solo.slot_live.any():
            st = solo.step()
            if r in st:
                want.append(st[r])
        assert stream == want, p


def test_prefix_watermark_restores_free_pages(setup):
    """ServeConfig.prefix_watermark: step() evicts cold entries until that
    many pages are free, as the JAX engine does."""
    got = []
    for eng in SP.pair(setup, batch_slots=2, max_len=32, cache_pages=8,
                       prefix_cache=True, prefix_watermark=7):
        r = eng.submit(list(range(1, 18)))
        eng.cancel(r)
        assert eng.pool.free_pages == 6
        eng.step()
        assert eng.pool.free_pages >= 7
        assert eng.stats()["prefix_evictions"] >= 1
        got.append((eng.pool.free_pages, eng.prefix.stats()))
    assert got[0] == got[1]


def test_prefix_cache_requires_paged_backend(setup):
    """Both refuse the prefix cache over contiguous caches (the port's
    default policy pages, so the port's test names ``fused``)."""
    for make in (SP.jax_engine, SP.port_engine):
        with pytest.raises(ValueError, match="prefix_cache"):
            make(setup, "default" if make is SP.jax_engine else "fused",
                 batch_slots=2, max_len=32, prefix_cache=True)


def test_kv_int8_prefix_cow_streams_identical(setup):
    """COW over int8 pages: _copy_page carries the scale rows, so the fork
    is bitwise its donor and both streams equal the JAX engine's and the
    solo runs."""
    kw = dict(batch_slots=2, max_len=32, cache_pages=16, kv_dtype="int8")
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    b = a[:6] + [60, 61, 62, 63]
    jeng, eng = SP.pair(setup, prefix_cache=True, **kw)
    ha = eng.submit(a)
    donor = eng.slot_tables[0].pages[0]
    before = {n: eng.caches[0][n][donor].clone()
              for n in ("kp", "vp", "k_scale", "v_scale")}
    hb = eng.submit(b)
    fork = eng.slot_tables[1].pages[0]
    assert fork != donor and eng.prefix.cow_forks == 1
    for c in eng.caches:                    # the fork's first 6 rows and
        for n in ("k_scale", "v_scale"):    # its scales are the donor's
            assert np.array_equal(c[n][fork].numpy(), c[n][donor].numpy())
        for n in ("kp", "vp"):
            assert np.array_equal(c[n][fork][:6].numpy(),
                                  c[n][donor][:6].numpy())
    for n, t in before.items():             # the borrower left it alone
        assert np.array_equal(eng.caches[0][n][donor].numpy(), t.numpy())
    jhs = [jeng.submit(a), jeng.submit(b)]
    assert jeng.prefix.cow_forks == 1
    got, want = _stepped(eng, [ha, hb], 5), _stepped(jeng, jhs, 5)
    assert got == want
    for prompt, stream in zip((a, b), got):
        solo = SP.port_engine(setup, **kw)
        r = solo.submit(prompt)
        assert stream == [solo.step()[r] for _ in range(5)], prompt
    eng.pool.check()
    eng.prefix.check()


# -- the launcher's flags ------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--prefix-cache", "--shared-prefix-len", "16"],
    ["--prefix-cache", "--shared-prefix-len", "16", "--prefix-watermark",
     "6"]], ids=["prefix-cache", "prefix-watermark"])
def test_cli_prefix_flags(capsys, flags):
    assert serve_cli.main(
        ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
         "--max-len", "48", "--batch-slots", "2", "--n-requests", "4",
         "--prompt-len", "8", "--gen-len", "6", "--page-size", "8",
         "--cache-pages", "8"] + flags) == 0
    out = capsys.readouterr().out
    assert "prefix_cache=True" in out
    stats = eval(out.split("[serve] stats: ")[1].splitlines()[0])
    assert stats["prefix_hits"] >= 1 and stats["prefix_hit_tokens"] >= 16
    if "--prefix-watermark" in flags:
        assert stats["pool_free_pages"] >= 6
