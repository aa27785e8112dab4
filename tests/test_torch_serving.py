"""The port's paged ServingEngine (repro_torch/serving/engine.py) against
the JAX package's engine: greedy streams must be token-identical.

Both engines serve the fp32 smollm-135m smoke config (n_layers=2, vocab=64,
as tests/test_serving.py) with the same weights (JAX init, converted). The
JAX side runs the paged kernel in interpret mode with the xla GEMM backend;
the port runs on the CPU, where its kernel wrappers run their plain
versions. Covered: batched generate(), submit/step with more requests than
slots, and a pool small enough to force preemption and resume.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.plan import AttentionPolicy, GemmPolicy
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import Scheduler

PS = 8


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg = jget_smoke_config("smollm-135m", **kw)
    cfg = get_smoke_config("smollm-135m", **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _engines(setup, *, pack=False, **kw):
    jcfg, jparams, cfg, params = setup
    jsc = JServeConfig(cache_dtype="float32", gemm=JGemmPolicy(backend="xla"),
                       attention=JAttentionPolicy(backend="paged_interpret",
                                                  page_size=PS, block_q=8),
                       **kw)
    sc = ServeConfig(cache_dtype="float32", device="cpu",
                     pack_weights=pack,
                     attention=AttentionPolicy(backend="paged", page_size=PS),
                     **kw)
    return JServingEngine(jcfg, jparams, jsc), ServingEngine(cfg, params, sc)


def _drain(eng, prompts, max_steps=200):
    """Submit every prompt as slots/pages allow and step until all finish
    (retirement at max_len); returns {request id: stream}, submit order."""
    pending, rids = list(prompts), []
    for _ in range(max_steps):
        while pending:
            rid = eng.submit(pending[0])
            if rid is None:
                break
            rids.append(rid)
            pending.pop(0)
        eng.step()
        if not pending and not eng.slot_live.any() and not eng.wait:
            break
    assert not pending and not eng.slot_live.any() and not eng.wait
    return [eng.request_out[r] for r in rids]


def test_generate_streams_identical(setup):
    jeng, eng = _engines(setup, batch_slots=2, max_len=32)
    prompts = np.random.default_rng(5).integers(0, 64, (2, 6)).astype(np.int32)
    want = jeng.generate(prompts, 7)
    got = eng.generate(prompts, 7)
    np.testing.assert_array_equal(got, want)
    assert eng.pool.free_pages == eng.pool.n_pages      # horizon pages freed


@pytest.mark.parametrize("pack", [False, True])
def test_submit_step_more_requests_than_slots(setup, pack):
    """Five requests of mixed lengths through two slots: every stream equal
    to the JAX engine's, token for token, up to retirement at max_len."""
    jeng, eng = _engines(setup, pack=pack, batch_slots=2, max_len=16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 64, n).tolist() for n in (3, 9, 1, 6, 12)]
    assert _drain(eng, prompts) == _drain(jeng, prompts)


def test_preempt_resume_streams_identical(setup):
    """A pool of half the padded need forces preemption; resumed streams
    equal the JAX engine's, and equal an uninterrupted solo run."""
    jeng, eng = _engines(setup, batch_slots=2, max_len=16, cache_pages=2)
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8]]
    got = _drain(eng, prompts)
    assert eng.n_preemptions > 0 and jeng.n_preemptions == 0
    assert got == _drain(jeng, prompts)
    assert jeng.n_preemptions == eng.n_preemptions
    eng.pool.check()
    assert eng.pool.free_pages == eng.pool.n_pages
    _, solo = _engines(setup, batch_slots=2, max_len=16)
    assert _drain(solo, [prompts[1]]) == [got[1]]


def test_chunked_prefill_streams_identical(setup):
    jcfg, jparams, cfg, params = setup
    jeng, eng = _engines(setup, batch_slots=2, max_len=32)
    prompts = [list(range(1, 14)), [5, 4, 3]]
    want = _drain(jeng, prompts)
    eng2 = ServingEngine(cfg, params, dataclasses.replace(
        eng.sc, scheduler=Scheduler(prefill_chunk=4)))
    assert _drain(eng2, prompts) == want


def test_cancel_returns_pages(setup):
    _, eng = _engines(setup, batch_slots=2, max_len=16)
    r = eng.submit([1, 2, 3, 4, 5])
    assert eng.pool.pages_in_use > 0
    assert eng.cancel(r) is True
    assert eng.pool.free_pages == eng.pool.n_pages
    assert eng.cancel(r) is False
    eng.pool.check()


def test_temperature_sampling_self_consistent(setup):
    """Seeded temperature streams repeat under the same generator seed (the
    JAX engine's jax.random draws cannot be matched) and stay in range."""
    jcfg, jparams, cfg, params = setup

    def run(seed):
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=16, temperature=1.0, device="cpu",
            cache_dtype="float32",
            attention=AttentionPolicy(backend="paged", page_size=PS)))
        g = torch.Generator().manual_seed(seed)
        r = eng.submit([1, 2, 3], generator=g)
        return [eng.step(generator=g)[r] for _ in range(8)]

    a, b = run(3), run(3)
    assert a == b and all(0 <= t < 64 for t in a)


def test_unported_features_raise(setup):
    jcfg, jparams, cfg, params = setup
    for kw in (dict(prefix_cache=True), dict(mesh=object()),
               dict(spec=object()), dict(obs=object()),
               dict(cache_dtype="bfloat16")):
        kw = {"cache_dtype": "float32", **kw}
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, params, ServeConfig(device="cpu", **kw))
    # int8 KV pages and W8A8 weights are ported now
    # (tests/test_torch_int8_serving.py)
    for kw in (dict(kv_dtype="int8"), dict(weight_dtype="int8")):
        ServingEngine(cfg, params, ServeConfig(device="cpu",
                                               cache_dtype="float32", **kw))
    # a dense backend is ported now: it serves from contiguous caches
    eng = ServingEngine(cfg, params, ServeConfig(
        device="cpu", cache_dtype="float32",
        attention=AttentionPolicy(backend="unfused")))
    assert not eng.paged
    with pytest.raises(ValueError, match="cache_pages"):
        ServingEngine(cfg, params, ServeConfig(
            device="cpu", batch_slots=2, max_len=32, cache_pages=3,
            cache_dtype="float32",
            attention=AttentionPolicy(backend="paged", page_size=PS)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(cfg, params, ServeConfig(cache_dtype="float32"))


def test_serve_cli_runs_on_cpu(capsys):
    assert serve_cli.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--max-len", "32", "--batch-slots", "2",
                           "--n-requests", "3", "--prompt-len", "6",
                           "--gen-len", "4", "--page-size", "8",
                           "--cache-pages", "4", "--pack-weights"]) == 0
    out = capsys.readouterr().out
    assert "batched generate: (2, 4)" in out
    assert "continuous batching: 3 requests" in out


def test_step_uses_gemm_policy(setup):
    """A pinned GEMM backend reaches every projection: the torch backend
    gives the same greedy stream as the plain MatrixFlow path."""
    jcfg, jparams, cfg, params = setup
    streams = []
    for backend in ("matrixflow", "torch"):
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=1, max_len=16, device="cpu", cache_dtype="float32",
            gemm=GemmPolicy(backend=backend),
            attention=AttentionPolicy(backend="paged", page_size=PS)))
        streams.append(_drain(eng, [[3, 1, 4, 1, 5]]))
    assert streams[0] == streams[1]


def test_copied_pool_and_scheduler_match_reference():
    """serving/kv_pool.py and scheduler.py are copies of the reference's
    host-side modules: the same random sequence of pool operations leaves
    both pools in the same state (or raises the same error), and both
    schedulers make the same choices."""
    from repro.serving import kv_pool as JK
    from repro.serving import scheduler as JS
    from repro_torch.serving import kv_pool as K
    from repro_torch.serving import scheduler as S

    rng = np.random.default_rng(0)
    pools = (JK.PagePool(12, 4), K.PagePool(12, 4))
    tables = ([JK.BlockTable(pools[0]) for _ in range(3)],
              [K.BlockTable(pools[1]) for _ in range(3)])
    for _ in range(300):
        op, i, n = rng.integers(0, 5), rng.integers(0, 3), rng.integers(0, 20)
        outcomes = []
        for pool, tbls in zip(pools, tables):
            try:
                if op == 0:
                    r = tbls[i].ensure(int(n))
                elif op == 1:
                    r = tbls[i].truncate(int(n))
                elif op == 2:
                    r = tbls[i].free()
                elif op == 3 and tbls[i].pages:
                    r = pool.fork(tbls[i].pages[0])
                    pool.release([r])
                else:
                    r = tbls[i].as_row(8).tolist() if tbls[i].n_pages <= 8 \
                        else None
                outcomes.append(("ok", r))
            except (RuntimeError, ValueError) as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1]
        assert pools[0].refcount.tolist() == pools[1].refcount.tolist()
        assert pools[0].free_pages == pools[1].free_pages
    pools[1].check()
    assert pools[0].high_water == pools[1].high_water

    views = [dict(rid=r, priority=int(rng.integers(0, 3)),
                  deadline=None if r % 3 else float(rng.integers(0, 50)),
                  arrival=int(rng.integers(0, 9)), n_tokens=r,
                  prefilling=bool(r % 4 == 0)) for r in range(12)]
    for jcls, cls in ((JS.Scheduler, S.Scheduler),
                      (JS.SLOScheduler, S.SLOScheduler)):
        js, s = jcls(prefill_chunk=4), cls(prefill_chunk=4)
        jv = [JS.RequestView(**v) for v in views]
        v = [S.RequestView(**v) for v in views]
        assert js.resume_order(jv) == s.resume_order(v)
        for k in range(1, len(views)):
            assert js.victim(jv[:k]) == s.victim(v[:k])
            assert js.should_preempt(jv[k], jv[k - 1]) == \
                s.should_preempt(v[k], v[k - 1])
