"""Caches in another dtype than the model's (ROADMAP queue 1 item 6b): the
port's ServingEngine against the JAX package's, greedy streams token for
token.

The reference builds its caches in ``ServeConfig.cache_dtype`` whatever
the model's dtype; its default pairs an fp32 model with a bf16 cache. Both
engines serve the smollm-135m smoke config (2 layers, vocab 64) from the
same JAX init (``convert.from_jax_params``), the JAX engine with its
Pallas kernels in interpret mode and the xla GEMM backend, the port on the
CPU (its kernel wrappers' plain versions):

* an fp32 model over a bf16 cache: paged (page 8, a pool small enough to
  preempt), contiguous (``fused``), and int8 KV pages;
* a bf16 model over an fp32 cache: paged and contiguous. A bf16 model's
  GEMMs round their fp32 sums to bf16, and the two packages sum in other
  orders (XLA's dot against the blocked Algorithm 1), so a near-tie can
  flip: bf16 streams are held equal, or parting first where the JAX
  model's top-2 logit margin at that position is below
  ``TOLS["bfloat16"]``'s atol (the rule chip_smoke.py applies to the card
  against the CPU). The same holds with a bf16 cache, where one of the six
  streams parts so.

The reference's contiguous cache is a caveat: its decode step writes K/V
by ``jnp.where``, which promotes a bf16 cache to fp32 from the first
decode step on (the JAX engine's cache dtype changes); the port casts every
write to the cache's dtype, as the paged write does in both packages. The
streams below agree all the same.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.serving.engine import ServeConfig, ServingEngine

import serving_pair as SP
from parity import TOLS

PROMPTS = SP.prompts(6, seed=3)
# paged engines: a pool of 10 pages of 8 under 3 slots of 32 positions
PAGED_KW = dict(batch_slots=3, max_len=32, cache_pages=10)
FUSED_KW = dict(batch_slots=3, max_len=32)


def _setup(dtype: str):
    kw = dict(n_layers=2, vocab=64, dtype=dtype)
    jcfg = jget_smoke_config("smollm-135m", **kw)
    cfg = get_smoke_config("smollm-135m", **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def fp32_model():
    return _setup("float32")


@pytest.fixture(scope="module")
def bf16_model():
    return _setup("bfloat16")


def _streams(setup, attn: str, cache_dtype: str, **kw):
    jcfg, jparams, cfg, params = setup
    jeng = JServingEngine(jcfg, jparams, JServeConfig(
        cache_dtype=cache_dtype, gemm=JGemmPolicy(backend="xla"),
        attention=SP.JATTN[attn], **kw))
    eng = ServingEngine(cfg, params, ServeConfig(
        cache_dtype=cache_dtype, device="cpu", attention=SP.ATTN[attn], **kw))
    return (SP.run_to_retirement(jeng, PROMPTS),
            SP.run_to_retirement(eng, PROMPTS), eng)


def _cache_dtypes(eng):
    pools = [c for c in eng.caches]
    return {str(t.dtype) for c in pools for name, t in c.items()
            if name in ("k", "v", "kp", "vp")}


@pytest.mark.parametrize("attn,kw", [("paged", PAGED_KW),
                                     ("fused", FUSED_KW)])
def test_fp32_model_bf16_cache_streams_match_jax(fp32_model, attn, kw):
    want, got, eng = _streams(fp32_model, attn, "bfloat16", **kw)
    assert got == want
    assert _cache_dtypes(eng) == {"torch.bfloat16"}
    if attn == "paged":
        assert eng.stats()["n_preemptions"] > 0


def test_fp32_model_int8_kv_streams_match_jax(fp32_model):
    want, got, eng = _streams(fp32_model, "paged", "bfloat16",
                              kv_dtype="int8", **PAGED_KW)
    assert got == want
    assert _cache_dtypes(eng) == {"torch.int8"}


def _assert_equal_or_near_tie(setup, want, got):
    """Each stream equal to the JAX engine's, or parting first where the
    JAX model's top-2 margin over the common prefix is a near-tie."""
    jcfg, jparams = setup[:2]
    fwd = jax.jit(lambda p, t: JT.forward(p, jcfg, {"tokens": t},
                                          remat=False)[0])
    for i, prompt in enumerate(PROMPTS):
        w, g = want[i], got[i]
        if w == g:
            continue
        t = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        seq = np.asarray([list(prompt) + w[:t]], np.int32)
        top2 = np.sort(np.asarray(fwd(jparams, seq)[0, -1], np.float32))[-2:]
        assert top2[1] - top2[0] < TOLS["bfloat16"][0], (i, t, top2)


@pytest.mark.parametrize("attn,kw", [("paged", PAGED_KW),
                                     ("fused", FUSED_KW)])
def test_bf16_model_fp32_cache_streams_match_jax(bf16_model, attn, kw):
    want, got, eng = _streams(bf16_model, attn, "float32", **kw)
    _assert_equal_or_near_tie(bf16_model, want, got)
    assert sum(want[i] == got[i] for i in want) >= len(PROMPTS) - 1
    assert _cache_dtypes(eng) == {"torch.float32"}
