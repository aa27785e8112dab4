"""The port's serving engine on deepseek-v2-236b (MLA + MoE), dbrx-132b
(GQA + MoE) and internvl2-76b (served as a text LM) against the JAX
package's engine on the same converted weights, smoke configs, fp32:
greedy streams token-identical.

deepseek serves from contiguous caches only (the MLA latent cache is not
paged): the port's default policy (``auto``: the plain attention on the
CPU) and its flash kernel (``fused``) against the reference's default.
dbrx and internvl2 are served paged (page 8, the JAX paged kernel in
interpret mode, in a fresh interpreter; a pool small enough to preempt)
and from contiguous caches. With ``weight_dtype="int8"`` (every
projection and the MoE router through the W8A8 route; the expert banks
stay fp, as in the reference) deepseek and dbrx streams are equal, or
part only after an int8 value the packages rounded to either side of a
.5 tie (tests/int8_flips.py). ``pack_model_weights`` packs exactly the
reference's leaves: the MLA projections, the routers and the shared
experts, not the expert banks.

MoE capacity makes a token's output depend on the other tokens of its
dispatch group (bucket padding and other requests' rows included), so
these streams are held to the JAX engine's on the same batches, not to
solo runs.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from serving_pair import JATTN, PS, run_to_retirement
from test_torch_int8_serving import _Recorder, _same_or_tie_flip

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.core.plan import PackedWeight as JPackedWeight
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import FUSED, AttentionPolicy, PackedWeight
from repro_torch.serving.engine import ServeConfig, ServingEngine

_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def synchronous_jax_dispatch():
    """The JAX engine's streams for the MoE models are reproducible only
    with JAX's CPU dispatch synchronous: with asynchronous dispatch two
    runs of one JAX engine on a loaded host can serve different streams
    (the port's stay the same). The reference runs synchronously in this
    module; the setting is restored after it."""
    prev = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", prev)


def _setup(arch):
    if arch not in _MODELS:
        kw = dict(n_layers=2, vocab=64, dtype="float32")
        jcfg = jget_smoke_config(arch, **kw)
        cfg = get_smoke_config(arch, **kw)
        jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                 cfg)
        _MODELS[arch] = (jcfg, jparams, cfg, params)
    return _MODELS[arch]


def _jax_engine(arch, attn="default", **kw):
    jcfg, jparams, _, _ = _setup(arch)
    backend = "blockflow" if kw.get("weight_dtype") else "xla"
    return JServingEngine(jcfg, jparams, JServeConfig(
        cache_dtype="float32", gemm=JGemmPolicy(backend=backend),
        attention=JATTN[attn], **kw))


def _engine(arch, attention=None, **kw):
    _, _, cfg, params = _setup(arch)
    return ServingEngine(cfg, params, ServeConfig(
        cache_dtype="float32", device="cpu", attention=attention, **kw))


PROMPTS = np.random.default_rng(5).integers(0, 64, (2, 7)).astype(np.int32)
PAGED = AttentionPolicy(backend="paged", page_size=PS)
# four prompts on two slots under a pool of 3 pages of 8 (a request grows
# to 16 tokens: 2 pages): both engines preempt
PAGED_PROMPTS = [p.tolist() for p in np.random.default_rng(6).integers(
    0, 64, (4, 5))]
PAGED_KW = dict(batch_slots=2, max_len=16, cache_pages=3)
TESTS = os.path.dirname(os.path.abspath(__file__))

_JAX_PAGED = """
import json, sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
import test_torch_moe_serving as M
from serving_pair import run_to_retirement
out = {}
for arch in sys.argv[1:]:
    eng = M._jax_engine(arch, "paged", **M.PAGED_KW)
    out[arch] = [run_to_retirement(eng, M.PAGED_PROMPTS), eng.n_preemptions]
print("RESULT " + json.dumps(out))
"""


def test_deepseek_contiguous_streams_equal_jax():
    want = _jax_engine("deepseek-v2-236b", batch_slots=2,
                       max_len=32).generate(PROMPTS, 6)
    default = _engine("deepseek-v2-236b", batch_slots=2, max_len=32)
    assert not default.paged and default.attn.backend == "unfused"
    np.testing.assert_array_equal(default.generate(PROMPTS, 6), want)
    fused = _engine("deepseek-v2-236b", FUSED, batch_slots=2, max_len=32)
    np.testing.assert_array_equal(fused.generate(PROMPTS, 6), want)


@pytest.mark.parametrize("arch", ["dbrx-132b", "internvl2-76b"])
def test_contiguous_streams_equal_jax(arch):
    want = _jax_engine(arch, batch_slots=2, max_len=32).generate(PROMPTS, 6)
    got = _engine(arch, FUSED, batch_slots=2, max_len=32).generate(PROMPTS, 6)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_paged_streams():
    """The JAX paged engine's streams for dbrx and internvl2, served in a
    fresh interpreter. In a process that ran other tests of the suite
    first (tests/test_system.py among them) and under load, the JAX
    engine's paged interpret-mode runs served different streams from one
    run to the next, while the port's stayed the same; in a fresh
    interpreter the JAX streams repeat."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(TESTS), "src"), TESTS]
        + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
           else [])))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_PAGED, "dbrx-132b", "internvl2-76b"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT "))
    return {arch: ({int(i): s for i, s in streams.items()}, n)
            for arch, (streams, n) in json.loads(line[7:]).items()}


@pytest.mark.parametrize("arch", ["dbrx-132b", "internvl2-76b"])
def test_paged_streams_equal_jax_under_preemption(arch, jax_paged_streams):
    """PAGED_PROMPTS served to natural retirement under PAGED_KW: both
    engines preempt, and every stream equals the JAX engine's."""
    want, jax_preemptions = jax_paged_streams[arch]
    eng = _engine(arch, PAGED, **PAGED_KW)
    got = run_to_retirement(eng, PAGED_PROMPTS)
    assert eng.n_preemptions > 0 and jax_preemptions > 0
    assert got == want


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_w8a8_streams_equal_jax_or_part_at_a_tie(arch):
    """Every projection, the router included, W8A8 (the JAX engine's on
    blockflow); contiguous caches."""
    with _Recorder() as rec:
        want = np.asarray(_jax_engine(arch, batch_slots=2, max_len=32,
                                      weight_dtype="int8").generate(
                                          PROMPTS, 6))
        got = _engine(arch, FUSED, batch_slots=2, max_len=32,
                      weight_dtype="int8").generate(PROMPTS, 6)
    assert got.shape == want.shape == (2, 6)
    for b in range(2):
        flip = _same_or_tie_flip(rec, got[b].tolist(), want[b].tolist(),
                                 f"{arch} W8A8 generate row {b}")
        if flip is not None:
            print(f"W8A8 stream diverges from JAX at a tie flip: {flip}")


def _packed_paths(tree, cls, prefix=""):
    """Paths of the ``cls`` leaves, layer indices dropped (the JAX tree
    stacks its layers, the port lists them)."""
    out = set()
    items = tree.items() if isinstance(tree, dict) else \
        ((None, v) for v in tree) if isinstance(tree, list) else ()
    for k, v in items:
        path = prefix if k is None else f"{prefix}/{k}"
        if isinstance(v, cls):
            out.add(path)
        else:
            out |= _packed_paths(v, cls, path)
    return out


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_packed_leaves_equal_the_reference(arch):
    jcfg, jparams, cfg, params = _setup(arch)
    want = _packed_paths(japi.pack_model_weights(jparams), JPackedWeight)
    got = _packed_paths(api.pack_model_weights(params), PackedWeight)
    assert got == want
    assert "/layers/moe/router" in got and "/layers/moe/wi" not in got
    if cfg.is_mla:
        assert {f"/layers/attn/{n}" for n in ("wq_a", "wq_b", "wkv_a",
                                              "wkv_b", "wo")} <= got
        assert "/layers/moe/shared/wi" in got
