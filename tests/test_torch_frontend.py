"""The port's AsyncServingEngine (repro_torch/serving/frontend.py) against
the JAX package's: one counterpart for each of tests/test_frontend.py's
six tests. The same requests go through the reference's frontend over the
JAX engine and the port's over its engine (``serving_pair``, plain
``asyncio.run`` as the reference tests use); every stream must be equal,
and equal to the engine's own submit()/step() stream.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import asyncio

import pytest
import serving_pair as SP

from repro.serving.frontend import AsyncServingEngine as JAsync
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.frontend import AsyncServingEngine

PAGED_KW = dict(batch_slots=2, max_len=32, cache_pages=8)


@pytest.fixture(scope="module")
def setup():
    return SP.make_setup()


def fronts(setup, attn="default", **kw):
    """(reference frontend over the JAX engine, the port's over its)."""
    jeng, eng = SP.pair(setup, attn, **kw)
    return JAsync(jeng), AsyncServingEngine(eng)


def sync_stream(eng, prompt, n):
    h = eng.submit(prompt)
    out = []
    while len(out) < n and (eng.slot_live.any() or eng.wait):
        for hh, t in eng.step().items():
            if hh == h:
                out.append(t)
    return out[:n]


def test_stream_matches_engine(setup):
    kw = dict(batch_slots=2, max_len=32)
    want = sync_stream(SP.port_engine(setup, "default", **kw),
                       [3, 1, 4, 1, 5], 6)
    got = []
    for aeng in fronts(setup, **kw):
        got.append(asyncio.run(aeng.complete([3, 1, 4, 1, 5], 6)))
        assert aeng.in_flight == 0
    assert got[0] == got[1] == want


def test_concurrent_streams_match_solo_runs(setup):
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4]]

    async def run_all(aeng):
        return await asyncio.gather(
            *(aeng.complete(p, 5, priority=i % 2)
              for i, p in enumerate(prompts)))

    got = [asyncio.run(run_all(a))
           for a in fronts(setup, "paged", **PAGED_KW)]
    assert got[0] == got[1]
    for p, stream in zip(prompts, got[1]):
        assert stream == sync_stream(
            SP.port_engine(setup, "paged", **PAGED_KW), p, 5), p


def test_breaking_out_cancels_request(setup):
    for aeng in fronts(setup, "paged", batch_slots=1, max_len=32):
        async def take_two():
            got = []
            async for tok in aeng.stream([1, 2, 3], 10):
                got.append(tok)
                if len(got) == 2:
                    break
            return got

        assert len(asyncio.run(take_two())) == 2
        assert aeng.in_flight == 0
        pool = aeng.engine.pool
        assert pool.free_pages == pool.n_pages


def test_stream_closes_at_engine_horizon(setup):
    got = []
    for aeng in fronts(setup, batch_slots=2, max_len=8):
        async def run():
            return await asyncio.gather(aeng.complete([1, 2, 3], 50),
                                        aeng.complete([4, 5, 6], 4))

        long, short = asyncio.run(run())
        assert len(short) == 4
        assert 0 < len(long) < 50
        assert aeng.in_flight == 0
        got.append((long, short))
    assert got[0] == got[1]


def test_queued_overflow_is_served_after_capacity_frees(setup):
    got = []
    for aeng in fronts(setup, "paged", **PAGED_KW):
        async def run():
            return await asyncio.gather(
                *(aeng.complete([10 + i, 20 + i], 3) for i in range(5)))

        streams = asyncio.run(run())
        assert all(len(s) == 3 for s in streams)
        assert aeng.in_flight == 0
        got.append(streams)
    assert got[0] == got[1]


def test_stream_rejects_nonpositive_budget(setup):
    for aeng in fronts(setup, batch_slots=1, max_len=16):
        with pytest.raises(ValueError, match="n_tokens"):
            asyncio.run(aeng.complete([1, 2], 0))


def test_cli_async_demo(capsys):
    assert serve_cli.main(
        ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
         "--max-len", "32", "--batch-slots", "2", "--n-requests", "2",
         "--prompt-len", "8", "--gen-len", "5", "--page-size", "8",
         "--async-demo", "5"]) == 0
    out = capsys.readouterr().out
    assert "async streaming: 5 concurrent requests, 25 tokens" in out
    assert '"n_completed": 5' in out
