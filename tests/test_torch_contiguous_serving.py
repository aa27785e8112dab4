"""The port's serving engine in contiguous mode (``AttentionPolicy(backend=
"fused")``: per-slot (max_len,) KV caches read by the flash kernel,
slot-bound admission, slot-id handles) against the JAX package's
non-paged engine: greedy streams must be token-identical.

Both engines serve the fp32 smollm-135m smoke config (n_layers=2,
vocab=64, as tests/test_serving.py) with the same weights (JAX init,
converted). The JAX side runs the unfused baseline — or its fused flash
kernel in interpret mode — with the xla GEMM backend; the port runs on the
CPU, where its kernel wrappers run their plain versions. Covered:
generate(), submit/step with more requests than slots and slot recycling,
cancel, the masked-prefill contract (admitting a slot leaves every other
slot's cache untouched, compared against the JAX engine's caches), and
the cache-less dense forward through the paged policy's flash fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import TOLS

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import FUSED_INTERPRET as JFUSED_INTERPRET
from repro.core.plan import UNFUSED as JUNFUSED
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import FUSED, PAGED, AttentionPolicy
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg = jget_smoke_config("smollm-135m", **kw)
    cfg = get_smoke_config("smollm-135m", **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _engines(setup, jattn=JUNFUSED, **kw):
    jcfg, jparams, cfg, params = setup
    jsc = JServeConfig(cache_dtype="float32", gemm=JGemmPolicy(backend="xla"),
                       attention=jattn, **kw)
    sc = ServeConfig(cache_dtype="float32", device="cpu", attention=FUSED,
                     **kw)
    return JServingEngine(jcfg, jparams, jsc), ServingEngine(cfg, params, sc)


def _drain(eng, prompts, cancel_after=None, max_steps=200):
    """Submit every prompt as slots allow and step until all retire at
    max_len; returns the streams in submit order. Handles are slot ids, so
    a recycled slot's handle names its new request. ``cancel_after``
    (request index, n tokens) cancels that request once it has n tokens."""
    pending = list(enumerate(prompts))
    owner, streams = {}, {}
    for _ in range(max_steps):
        while pending:
            h = eng.submit(pending[0][1])
            if h is None:
                break
            owner[h] = pending.pop(0)[0]
            streams[owner[h]] = []
        for h, t in eng.step().items():
            streams[owner[h]].append(t)
        if cancel_after is not None:
            i, n = cancel_after
            h = next((h for h, o in owner.items() if o == i), None)
            if h is not None and len(streams[i]) >= n and eng.slot_live[h]:
                assert eng.cancel(h) is True
                assert eng.cancel(h) is False
                del owner[h]
        if not pending and not eng.slot_live.any():
            break
    assert not pending and not eng.slot_live.any()
    return [streams[i] for i in range(len(prompts))]


@pytest.mark.parametrize("jattn", [JUNFUSED, JFUSED_INTERPRET],
                         ids=["jax_unfused", "jax_fused_interpret"])
def test_generate_streams_identical(setup, jattn):
    jeng, eng = _engines(setup, jattn, batch_slots=2, max_len=32)
    prompts = np.random.default_rng(5).integers(0, 64, (2, 6)).astype(np.int32)
    want = jeng.generate(prompts, 7)
    before = FA.flash_attention.launches
    got = eng.generate(prompts, 7)
    assert FA.flash_attention.launches == before          # CPU: no launch
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 7), want)


def test_submit_step_more_requests_than_slots(setup):
    """Five requests of mixed lengths through two slots, recycling each
    slot; every stream equal to the JAX engine's up to retirement at
    max_len, with slot-bound admission (submit returns None when full)."""
    jeng, eng = _engines(setup, batch_slots=2, max_len=16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 64, n).tolist() for n in (3, 9, 1, 6, 12)]
    assert _drain(eng, prompts) == _drain(jeng, prompts)
    assert eng.submit([1]) == 0 and eng.submit([2]) == 1
    assert eng.submit([3]) is None
    assert "pool_pages" not in eng.stats()


def test_cancel_streams_identical(setup):
    jeng, eng = _engines(setup, batch_slots=2, max_len=20)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    want = _drain(jeng, prompts, cancel_after=(0, 4))
    got = _drain(eng, prompts, cancel_after=(0, 4))
    assert got == want and len(got[0]) == 4


def test_masked_slot_leaves_other_caches_untouched(setup):
    """Admitting slot 1 (a masked prefill: slot 0's row carries position
    −1) and then decoding both leaves slot 0's cache exactly as an
    uninterrupted run leaves it, and every slot's cache agrees with the
    JAX engine's."""
    jeng, eng = _engines(setup, batch_slots=2, max_len=32)
    _, solo = _engines(setup, batch_slots=2, max_len=32)
    for e in (jeng, eng, solo):
        assert e.submit([1, 2, 3]) == 0
        e.step()
        e.step()
    snap = [{k: c[k].clone() for k in ("k", "v", "len")} for c in eng.caches]
    for e in (jeng, eng):
        assert e.submit([4, 5, 6, 7, 8]) == 1
    for c, s in zip(eng.caches, snap):
        assert torch.equal(c["k"][0], s["k"][0])
        assert torch.equal(c["v"][0], s["v"][0])
        assert c["len"].tolist() == [s["len"][0].item(), 5]
    outs = [[e.step()[0] for _ in range(4)] for e in (jeng, eng, solo)]
    assert outs[0] == outs[1] == outs[2]
    for c, cs in zip(eng.caches, solo.caches):
        assert torch.equal(c["k"][0], cs["k"][0])
        assert c["len"][0] == cs["len"][0] == 3 + 2 + 4
    jk = np.asarray(jeng.caches["scan"]["k"])            # (L, B, T, Hkv, dh)
    jlen = np.asarray(jeng.caches["scan"]["len"])
    for i, c in enumerate(eng.caches):
        np.testing.assert_array_equal(c["len"].numpy(), jlen[i])
        np.testing.assert_allclose(c["k"][:, :32].numpy(), jk[i],
                                   *TOLS["float32"])


def test_dense_forward_through_paged_fallback(setup):
    """No cache under the paged policy: the operands are dense and the
    backend falls back to the flash kernel (its plain version here)."""
    jcfg, jparams, cfg, params = setup
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 37))
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JUNFUSED):
        want, _, _ = JT.forward(jparams, jcfg,
                                {"tokens": jnp.asarray(tokens)}, remat=False)
    with torch.no_grad(), api.use_attention_policy(PAGED):
        got, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               *TOLS["float32"])


def test_contiguous_caches_and_rejections(setup):
    jcfg, jparams, cfg, params = setup
    caches = T.init_caches(cfg, 3, 16, "float32", "cpu")
    assert len(caches) == cfg.n_layers
    assert caches[0]["k"].shape == (3, 17, cfg.n_kv_heads, cfg.head_dim)
    for kw in (dict(prefix_cache=True), dict(spec=object())):
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, params, ServeConfig(
                device="cpu", cache_dtype="float32", attention=FUSED, **kw))
    # int8 KV pages are ported, for page pools only (as the reference)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, params, ServeConfig(
            device="cpu", cache_dtype="float32", attention=FUSED,
            kv_dtype="int8"))
    eng = ServingEngine(cfg, params, ServeConfig(
        device="cpu", cache_dtype="float32", batch_slots=2, max_len=16,
        attention=AttentionPolicy(backend="unfused")))
    assert not eng.paged and eng.cancel(0) is False and eng.cancel(7) is False


def test_serve_cli_fused_runs_on_cpu(capsys):
    assert serve_cli.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--max-len", "32", "--batch-slots", "2",
                           "--n-requests", "3", "--prompt-len", "6",
                           "--gen-len", "4", "--attn-backend", "fused",
                           "--pack-weights"]) == 0
    out = capsys.readouterr().out
    assert "attn=fused" in out
    assert "batched generate: (2, 4)" in out
    assert "continuous batching: 3 requests, 12 tokens" in out
