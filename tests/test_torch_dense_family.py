"""The rest of the dense family in the port — qwen2-1.5b (QKV biases),
qwen3-8b (q/k RMSNorm over a head's dims) and granite-20b (MQA, a biased
GELU MLP without a gate) — against the JAX package on their smoke
configs, with the JAX weights converted.

The reference inits the QKV biases and the GELU MLP's biases to zero and
the q/k norm scales to one, which would hide a missing add or a missing
norm: every test overwrites them in the JAX params with seeded values
before both sides run. fp32 logits agree within tests/parity.py's
TOLS["float32"] without a cache, over paged caches (prefill and greedy
decode) and over contiguous caches; qwen2's greedy streams through the
port's paged engine equal the JAX engine's, preempted or not, and a
preempted request's stream equals its solo stream.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import TOLS
from test_torch_model import _jax_paged, _port_paged

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import FUSED, AttentionPolicy
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

ARCHS = ("qwen2-1.5b", "qwen3-8b", "granite-20b")
# the leaves the reference inits to constants, and what each model has
_CONST_LEAVES = {"qwen2-1.5b": ("bq", "bk", "bv"),
                 "qwen3-8b": ("q_norm", "k_norm"),
                 "granite-20b": ("bi", "bo")}
PS = 8


def _configs(arch, **kw):
    kw = dict(n_layers=2, vocab=64, dtype="float32", **kw)
    return jget_smoke_config(arch, **kw), get_smoke_config(arch, **kw)


def _perturb(np_tree, seed=0):
    """The QKV biases, q/k norm scales and GELU MLP biases set to seeded
    values away from the reference's zeros and ones (in place)."""
    rng = np.random.default_rng(seed)
    layers = np_tree["layers"]
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            a = layers["attn"][name]
            layers["attn"][name] = (0.5 * rng.standard_normal(a.shape)
                                    ).astype(a.dtype)
    for name in ("q_norm", "k_norm"):
        if name in layers["attn"]:
            a = layers["attn"][name]["scale"]
            layers["attn"][name]["scale"] = (
                1 + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    for name in ("bi", "bo"):
        if name in layers["mlp"]:
            a = layers["mlp"][name]
            layers["mlp"][name] = (0.2 * rng.standard_normal(a.shape)
                                   ).astype(a.dtype)
    return np_tree


@pytest.fixture(scope="module", params=ARCHS)
def converted(request):
    jcfg, cfg = _configs(request.param)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_tree = _perturb(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, cfg, np_tree, from_jax_params(np_tree, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirrors_jax_registry(arch):
    """The port's full config carries the reference's values."""
    full, jfull = get_config(arch), jget_config(arch)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "rope_theta", "dtype", "family", "qk_norm",
              "qkv_bias", "mlp_act", "norm", "tie_embeddings", "source"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert full.head_dim == 128


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_draws_the_reference_leaves(arch):
    """init_model accepts each config and lays out the same leaves as the
    JAX init (the constants at their reference values)."""
    jcfg, cfg = _configs(arch)
    params = T.init_model(cfg, seed=1, device="cpu")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jl = jax.tree_util.tree_map(lambda a: a.shape[1:], jparams["layers"])
    pl = jax.tree_util.tree_map(lambda t: tuple(t.shape), params["layers"][0])
    assert jl == pl
    attn, mlp = params["layers"][0]["attn"], params["layers"][0]["mlp"]
    for name in _CONST_LEAVES[arch]:
        leaf = attn.get(name, mlp.get(name))
        leaf = leaf["scale"] if isinstance(leaf, dict) else leaf
        assert torch.equal(leaf, torch.full_like(leaf, float(
            name.endswith("norm"))))


def test_cacheless_forward_matches_jax(converted):
    jcfg, cfg, np_tree, params = converted
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        want, _, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray, np_tree),
                                jcfg, {"tokens": jnp.asarray(tokens)},
                                remat=False)
    with torch.no_grad():
        got, _, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               *TOLS["float32"])


def test_paged_forward_logits_match_jax(converted):
    """Prefill then greedy decode over paged caches (the JAX paged kernel
    in interpret mode; the port's MatrixFlow and paged wrappers on their
    plain versions)."""
    jcfg, cfg, np_tree, params = converted
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 11))
    want = _jax_paged(jcfg, np_tree, tokens, 3)
    got = _port_paged(cfg, params, tokens, 3, "matrixflow")
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, *TOLS["float32"],
                                   err_msg=f"step {i}")


def test_contiguous_forward_logits_match_jax(converted):
    """Prefill then greedy decode over contiguous caches: the port's flash
    wrapper (FUSED) against the JAX unfused attention."""
    jcfg, cfg, np_tree, params = converted
    B, S, n_decode, max_len = 2, 7, 3, 16
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jcaches = JT.init_caches(jcfg, B, max_len, jnp.float32)
    caches = T.init_caches(cfg, B, max_len, torch.float32, "cpu")
    jtok, tok = jnp.asarray(tokens), torch.from_numpy(tokens)
    pos = np.broadcast_to(np.arange(S), (B, S))
    for i in range(n_decode + 1):
        with japi.use_policy(JGemmPolicy(backend="xla")), \
                japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
            want, jcaches, _ = JT.forward(
                jparams, jcfg, {"tokens": jtok, "positions": jnp.asarray(pos)},
                caches=jcaches, remat=False)
        with torch.no_grad(), api.use_attention_policy(FUSED):
            got, caches, _ = T.forward(params, cfg, {
                "tokens": tok, "positions": torch.from_numpy(pos.copy())},
                caches=caches)
        want = np.asarray(want[:, -1])
        np.testing.assert_allclose(got[:, -1].numpy(), want,
                                   *TOLS["float32"], err_msg=f"step {i}")
        nxt = want.argmax(-1)[:, None]
        jtok, tok = jnp.asarray(nxt), torch.from_numpy(nxt)
        pos = np.full((B, 1), S + i)


def test_bf16_forward_runs_every_family_member(converted):
    """bf16 weights through the same converted tree: finite logits of the
    expected shape (the kernels' bf16 paths on the card are held in
    chip_smoke.py)."""
    jcfg, cfg, np_tree, _ = converted
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = jax.tree_util.tree_map(
        lambda t: t.to(torch.bfloat16),
        from_jax_params(np_tree, cfg))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 5)))
    with torch.no_grad():
        got, _, _ = T.forward(params, cfg16, {"tokens": tokens})
    assert got.shape == (2, 5, cfg.vocab) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()


# ---------------------------------------------------------------------------
# qwen2's serving streams, as tests/test_serving.py builds its engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen2():
    jcfg, cfg = _configs("qwen2-1.5b")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_tree = _perturb(jax.tree_util.tree_map(np.asarray, jparams), seed=7)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, np_tree), cfg,
            from_jax_params(np_tree, cfg))


def _engines(qwen2, **kw):
    jcfg, jparams, cfg, params = qwen2
    jsc = JServeConfig(cache_dtype="float32", gemm=JGemmPolicy(backend="xla"),
                       attention=JAttentionPolicy(backend="paged_interpret",
                                                  page_size=PS, block_q=8),
                       **kw)
    sc = ServeConfig(cache_dtype="float32", device="cpu", pack_weights=True,
                     attention=AttentionPolicy(backend="paged", page_size=PS),
                     **kw)
    return JServingEngine(jcfg, jparams, jsc), ServingEngine(cfg, params, sc)


def _drain(eng, prompts, max_steps=200):
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
    return rids, [eng.request_out[r] for r in rids]


def test_qwen2_generate_streams_equal_jax(qwen2):
    jeng, eng = _engines(qwen2, batch_slots=4, max_len=32)
    prompts = np.random.default_rng(5).integers(0, 64, (4, 8)).astype(np.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 6),
                                  jeng.generate(prompts, 6))


def test_qwen2_preempted_streams_equal_jax_and_solo(qwen2):
    """A pool of half the padded need preempts; every stream equals the JAX
    engine's, and each preempted request's equals its solo stream."""
    kw = dict(batch_slots=2, max_len=16, cache_pages=2)
    jeng, eng = _engines(qwen2, **kw)
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9, 10]]
    preempted = set()
    preempt = eng._preempt
    eng._preempt = lambda slot: (preempted.add(int(eng.slot_rid[slot])),
                                 preempt(slot))[1]
    rids, got = _drain(eng, prompts)
    _, want = _drain(jeng, prompts)
    assert eng.n_preemptions > 0 and jeng.n_preemptions > 0
    assert got == want
    assert preempted
    for rid, p, stream in zip(rids, prompts, got):
        if rid not in preempted:
            continue
        solo = _engines(qwen2, **kw)[1]
        r = solo.submit(p)
        alone = []
        while solo.slot_live.any():
            out = solo.step()
            if r in out:
                alone.append(out[r])
        assert stream == alone, (rid, p)
