"""The JAX package's serving engine and the port's, built side by side for
the port's serving-feature tests (prefix cache, speculative decoding, the
streaming frontend, observability).

Both serve the fp32 smollm-135m smoke config (n_layers=2, vocab=64, the
config the reference's serving tests use) with the same weights: the JAX
init, carried over by ``convert.from_jax_params``. The JAX engine runs its
paged kernel in interpret mode (page 8, as the reference tests'
``PAGED8``) or the fused flash kernel in interpret mode, with the xla GEMM
backend; the port runs on the CPU, where its kernel wrappers run their
plain versions. The reference's default contiguous engine is held against
the port's ``fused`` engine, the port's contiguous mode on the card.
"""
from __future__ import annotations

import jax
import numpy as np

from repro import obs as jobs
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving import spec_decode as jspec
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import obs as tobs
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.plan import FUSED, AttentionPolicy
from repro_torch.serving import spec_decode as tspec
from repro_torch.serving.engine import ServeConfig, ServingEngine

PS = 8
# reference-side policies, as the reference tests spell them
JATTN = {"paged": JAttentionPolicy(backend="paged_interpret", page_size=PS,
                                   block_q=8),
         "fused": JAttentionPolicy(backend="fused_interpret", block_q=8,
                                   block_k=8),
         "default": None}
ATTN = {"paged": AttentionPolicy(backend="paged", page_size=PS),
        "fused": FUSED, "default": FUSED}


def make_setup():
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg = jget_smoke_config("smollm-135m", **kw)
    cfg = get_smoke_config("smollm-135m", **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def jax_engine(setup, attn="paged", spec=None, obs=False, **kw):
    """The JAX engine; ``spec`` is a callable taking the spec_decode
    module (so each side builds its own drafter), ``obs`` a flag."""
    jcfg, jparams = setup[:2]
    return JServingEngine(jcfg, jparams, JServeConfig(
        cache_dtype="float32", gemm=JGemmPolicy(backend="xla"),
        attention=JATTN[attn], spec=spec(jspec) if spec else None,
        obs=jobs.Observability() if obs else jobs.NULL_OBS, **kw))


def port_engine(setup, attn="paged", spec=None, obs=False, **kw):
    """The port's engine on the CPU, with the same arguments."""
    cfg, params = setup[2:]
    return ServingEngine(cfg, params, ServeConfig(
        cache_dtype="float32", device="cpu", attention=ATTN[attn],
        spec=spec(tspec) if spec else None,
        obs=tobs.Observability() if obs else tobs.NULL_OBS, **kw))


def pair(setup, attn="paged", **kw):
    return jax_engine(setup, attn, **kw), port_engine(setup, attn, **kw)


def run_to_retirement(eng, prompts, max_steps=600):
    """Serve ``prompts`` to natural retirement (max_len drain); returns
    {i: full stream} keyed by prompt index (bursts flattened)."""
    outs = {i: [] for i in range(len(prompts))}
    hmap = {}
    pending = list(enumerate(prompts))
    for _ in range(max_steps):
        while pending:
            i, p = pending[0]
            h = eng.submit(list(p))
            if h is None:
                break
            hmap[h] = i
            pending.pop(0)
        for h, t in eng.step().items():
            outs[hmap[h]].extend(t if isinstance(t, list) else [t])
        if not pending and not eng.slot_live.any() \
                and not (eng.paged and eng.wait):
            break
    assert not pending and not eng.slot_live.any()
    return outs


def prompts(n, seed=0, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def mask_ts(events):
    """Chrome trace events without their timing fields (ts, dur), for
    comparing two recorders."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]
