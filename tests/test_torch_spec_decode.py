"""The port's speculative decoding (repro_torch/serving/spec_decode.py and
the engine's verify/accept/rollback step) against the JAX package.

One counterpart for each of tests/test_spec_decode.py's sixteen tests. The
drafter units run the same contexts through the reference's drafters and
the port's and compare the proposals. The engine tests serve the same
prompts through the JAX engine and the port's (``serving_pair``): with
speculation on, the port's greedy streams equal the JAX engine's, on paged
and contiguous (``fused``) caches, int8 KV pages, under the prefix cache
and under preemption, with the same accepted, rejected and rolled-back
counts; and they equal the port's own streams with speculation off.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import asyncio

import pytest
import serving_pair as SP

from repro.serving import spec_decode as J
from repro.serving.frontend import AsyncServingEngine as JAsync
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import spec_decode as P
from repro_torch.serving.frontend import AsyncServingEngine

NGRAM4 = (lambda m: m.NGramDrafter(k=4))


def spec_counts(eng):
    return (eng.spec_accepted, eng.spec_rejected, eng.spec_rollback_pages)


# -- NGramDrafter units --------------------------------------------------------

def test_ngram_proposes_most_recent_continuation():
    ctx = [1, 2, 9, 9, 9, 1, 2, 7, 8, 1, 2]
    got = [m.NGramDrafter(k=3, ngram=2).draft(ctx, 3) for m in (J, P)]
    assert got[0] == got[1] == [7, 8, 1]


def test_ngram_falls_back_to_shorter_ngram():
    got = [m.NGramDrafter(k=2, ngram=3, min_ngram=1).draft([2, 5, 1, 3, 2], 2)
           for m in (J, P)]
    assert got[0] == got[1] == [5, 1]


def test_ngram_no_match_proposes_nothing():
    for m in (J, P):
        d = m.NGramDrafter(k=4)
        assert d.draft([1, 2, 3, 4, 5], 4) == []
        assert d.draft([7], 4) == []
        assert d.draft([3, 3, 3], 0) == []
    # and on streams with matches, cycles and runs, the same proposals
    rng = SP.prompts(20, seed=9, lo=2, hi=30)
    for ctx in rng + [[5] * 7, [1, 2, 3] * 4]:
        for k in (1, 4, 8):
            assert J.NGramDrafter(k=k).draft(ctx, k) == \
                P.NGramDrafter(k=k).draft(ctx, k), (ctx, k)


def test_ngram_respects_draft_budget():
    ctx = [5, 1, 2, 3, 4, 5]
    for m in (J, P):
        assert m.NGramDrafter(k=8, ngram=1).draft(ctx, 2) == [1, 2]
        assert m.NGramDrafter(k=2, ngram=1).draft(ctx, 8) == [1, 2]


def test_ngram_validates_arguments():
    for m in (J, P):
        with pytest.raises(ValueError, match="ngram"):
            m.NGramDrafter(k=0)
        with pytest.raises(ValueError, match="ngram"):
            m.NGramDrafter(ngram=1, min_ngram=2)


def test_make_drafter_rejects_unknown_spec():
    for m in (J, P):
        with pytest.raises(ValueError, match="unknown drafter"):
            m.make_drafter("nope")
    d = P.make_drafter("ngram", k=3)
    assert isinstance(d, P.NGramDrafter) and d.k == 3


# -- engine validation ---------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    return SP.make_setup()


def test_spec_requires_greedy(setup):
    for make in (SP.jax_engine, SP.port_engine):
        with pytest.raises(ValueError, match="greedy"):
            make(setup, batch_slots=2, max_len=32, temperature=0.7,
                 spec=NGRAM4)


def test_spec_rejects_bad_k(setup):
    class BadDrafter:
        k = 0

    for make in (SP.jax_engine, SP.port_engine):
        with pytest.raises(ValueError, match="k >= 1"):
            make(setup, batch_slots=2, max_len=32,
                 spec=lambda m: BadDrafter())


# -- token-identity gates --------------------------------------------------------

@pytest.mark.parametrize("attn", ["paged", "fused"])
def test_spec_streams_token_identical(setup, attn):
    """Speculative greedy streams, run through the max_len drain, equal
    the JAX engine's (with the same counts) and the port's own without
    speculation, on paged and contiguous caches."""
    prompts = SP.prompts(3, seed=2)
    base = dict(batch_slots=3, max_len=32)
    want = SP.run_to_retirement(SP.port_engine(setup, attn, **base), prompts)
    jeng, eng = SP.pair(setup, attn, spec=NGRAM4, **base)
    got = SP.run_to_retirement(eng, prompts)
    assert got == want == SP.run_to_retirement(jeng, prompts)
    assert spec_counts(eng) == spec_counts(jeng)
    assert eng.spec_accepted > 0
    if eng.paged:
        eng.pool.check()
        assert eng.pool.free_pages == eng.pool.n_pages


def test_spec_rollback_returns_pages(setup):
    prompts = SP.prompts(4, seed=3)
    jeng, eng = SP.pair(setup, batch_slots=4, max_len=64, spec=NGRAM4)
    assert SP.run_to_retirement(eng, prompts) == \
        SP.run_to_retirement(jeng, prompts)
    assert spec_counts(eng) == spec_counts(jeng)
    assert eng.spec_rejected > 0
    assert eng.spec_rollback_pages > 0
    eng.pool.check()
    assert eng.pool.free_pages == eng.pool.n_pages
    st = eng.stats()
    assert st["spec_rollback_pages"] == eng.spec_rollback_pages
    assert 0.0 <= st["spec_acceptance_rate"] <= 1.0
    assert st["spec_acceptance_rate"] == jeng.stats()["spec_acceptance_rate"]


def test_spec_preempt_resume_streams_identical(setup):
    kw = dict(batch_slots=2, max_len=16, cache_pages=2)
    prompts = [[1, 2, 3], [4, 5, 6]]
    jeng, eng = SP.pair(setup, spec=NGRAM4, **kw)
    got = SP.run_to_retirement(eng, prompts)
    assert got == SP.run_to_retirement(jeng, prompts)
    assert eng.n_preemptions == jeng.n_preemptions > 0
    eng.pool.check()
    assert eng.pool.free_pages == eng.pool.n_pages
    for i, p in enumerate(prompts):
        solo = SP.run_to_retirement(SP.port_engine(setup, **kw), [p])
        assert got[i] == solo[0], (i, p)


def test_spec_prefix_cow_streams_identical(setup):
    shared = list(range(1, 13))
    prompts = [shared + [20 + i] for i in range(3)]
    base = dict(batch_slots=3, max_len=32)
    want = SP.run_to_retirement(SP.port_engine(setup, **base), prompts)
    jeng, eng = SP.pair(setup, prefix_cache=True, spec=NGRAM4, **base)
    got = SP.run_to_retirement(eng, prompts)
    assert got == want == SP.run_to_retirement(jeng, prompts)
    assert eng.prefix.stats() == jeng.prefix.stats()
    assert eng.prefix.stats()["prefix_hits"] > 0
    eng.prefix.clear()
    eng.pool.check()
    assert eng.pool.free_pages == eng.pool.n_pages


def test_spec_kv_int8_streams_self_consistent(setup):
    prompts = SP.prompts(2, seed=4)
    base = dict(batch_slots=2, max_len=32, kv_dtype="int8")
    want = SP.run_to_retirement(SP.port_engine(setup, **base), prompts)
    jeng, eng = SP.pair(setup, spec=NGRAM4, **base)
    got = SP.run_to_retirement(eng, prompts)
    assert got == want == SP.run_to_retirement(jeng, prompts)
    eng.pool.check()


def test_draft_model_self_draft_accepts_everything(setup):
    """The port's DraftModelDrafter over the target itself accepts every
    draft; streams equal the JAX engine's under its own self-drafter.
    (The reference's draft engine keeps its default bf16 cache under fp32
    weights, so its acceptance counts are not the port's to match.)"""
    cfg, params = setup[2:]
    jcfg, jparams = setup[:2]
    prompts = SP.prompts(2, seed=5, lo=3, hi=8)
    base = dict(batch_slots=2, max_len=24)
    want = SP.run_to_retirement(SP.port_engine(setup, **base), prompts)
    eng = SP.port_engine(setup, spec=lambda m: m.DraftModelDrafter(
        cfg, params, k=3, max_len=32, attention=SP.ATTN["paged"],
        device="cpu"), **base)
    jeng = SP.jax_engine(setup, spec=lambda m: m.DraftModelDrafter(
        jcfg, jparams, k=3, max_len=32, attention=SP.JATTN["paged"]), **base)
    got = SP.run_to_retirement(eng, prompts)
    assert got == want
    assert eng.spec_rejected == 0 and eng.spec_accepted > 0
    jgot = SP.run_to_retirement(jeng, prompts)
    assert jgot == got


def test_spec_step_emits_bursts(setup):
    bursts = []
    for eng in SP.pair(setup, batch_slots=1, max_len=64, spec=NGRAM4):
        h = eng.submit([7, 7, 7, 7, 7, 7])
        total, got = 0, []
        for _ in range(30):
            stepped = eng.step()
            if h in stepped:
                assert isinstance(stepped[h], list)
                got.append(list(stepped[h]))
                total += len(stepped[h])
            if total >= 10:
                break
        assert total >= 10
        eng.cancel(h)
        bursts.append(got)
    assert bursts[0] == bursts[1]
    assert max(len(b) for b in bursts[1]) > 1


def test_spec_async_frontend_streams(setup):
    kw = dict(batch_slots=2, max_len=32)
    solo = SP.run_to_retirement(SP.port_engine(setup, **kw),
                                [[1, 2, 3, 1, 2]])
    outs = []
    for eng, Front in zip(SP.pair(setup, spec=NGRAM4, **kw),
                          (JAsync, AsyncServingEngine)):
        aeng = Front(eng)

        async def demo():
            return await asyncio.gather(aeng.complete([1, 2, 3, 1, 2], 8),
                                        aeng.complete([9, 8, 7], 8))

        got = asyncio.run(demo())
        assert [len(g) for g in got] == [8, 8]
        eng.pool.check()
        assert eng.pool.free_pages == eng.pool.n_pages
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][0] == solo[0][:8]


# -- the launcher's flags ------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--spec", "ngram"], ["--spec", "ngram", "--spec-k", "8"],
    ["--spec", "draft:smollm-135m", "--spec-k", "2"]],
    ids=["spec-ngram", "spec-k", "spec-draft"])
def test_cli_spec_flags(capsys, flags):
    assert serve_cli.main(
        ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
         "--max-len", "32", "--batch-slots", "2", "--n-requests", "3",
         "--prompt-len", "8", "--gen-len", "8", "--page-size", "8"]
        + flags) == 0
    out = capsys.readouterr().out
    assert f"speculative decoding: {flags[1]}" in out
    stats = eval(out.split("[serve] stats: ")[1].splitlines()[0])
    assert stats["spec_accepted_tokens"] + stats["spec_rejected_tokens"] > 0
    assert stats["pool_free_pages"] == stats["pool_pages"]
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                        "--temperature", "0.5"] + flags)


def test_cli_spec_refused_for_ssd_families(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "mamba2-1.3b", "--smoke", "--device",
                        "cpu", "--batch-slots", "1", "--spec", "ngram"])
    assert "ssm/hybrid" in capsys.readouterr().err
