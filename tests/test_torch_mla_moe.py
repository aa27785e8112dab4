"""MLA and MoE in the port — deepseek-v2-236b (MLA, 160 routed + 2 shared
experts, a leading dense layer) and dbrx-132b (GQA, 16 experts) — against
the JAX package on their smoke configs, fp32, with the JAX weights
converted (``convert.from_jax_params``).

Covered: the four configurations of this slice field by field and
``check_supported`` over every registered config; ``mla_attention`` with no
cache, and through a bucketed prefill (position −1 columns) and four
decode steps over the latent cache (outputs, cache contents and lengths),
under the JAX unfused attention and under its flash kernel in interpret
mode at q/k head dim 48 and v head dim 32 against the port's plain K3;
``moe`` (output and aux loss) in both combine modes on a batch whose
capacity drops tokens, a router whose duplicated columns force top-k
ties, and ``_moe_groups``; the two whole models' cache-less forwards and
deepseek's prefill + decode over contiguous caches. Tolerances are
tests/parity.py's TOLS and ATTN_TOLS.
The JAX reference calls are jitted whole, each test compiling its own
under the policies active at its first call: eager JAX compiles every op
anew at each new shape, several times slower here.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import ATTN_TOLS, TOLS

from repro.configs import internvl2_76b as jinternvl2
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import internvl2_76b
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.core import api
from repro_torch.core.plan import FUSED, UNFUSED, AttentionPolicy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

NEW_ARCHS = ("internvl2-76b", "musicgen-medium", "dbrx-132b",
             "deepseek-v2-236b")
JXLA = JGemmPolicy(backend="xla")
JUNFUSED = JAttentionPolicy(backend="unfused")
JFUSED = JAttentionPolicy(backend="fused_interpret", block_q=8, block_k=8)


def _configs(arch, **kw):
    kw = dict(n_layers=2, vocab=64, dtype="float32", **kw)
    return jget_smoke_config(arch, **kw), get_smoke_config(arch, **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(np_tree):
    if isinstance(np_tree, dict):
        return {k: _to_port(v) for k, v in np_tree.items()}
    return to_tensor(np_tree)


def _shapes(tree, prefix=""):
    """{path: shape} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _close(got, want, tols=TOLS["float32"], msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), *tols,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_reference_field_by_field(arch):
    full, jfull = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(jfull):
        want = getattr(jfull, f.name)
        got = getattr(full, f.name)
        if f.name == "dtype":
            got, want = str(got), str(jnp.dtype(want))
        assert got == want, f.name


def test_registry_covers_the_reference_and_every_config_is_supported():
    """Every configuration the JAX package registers has its counterpart
    here, and check_supported accepts each (with the image-token count of
    internvl2's stub frontend)."""
    assert set(ARCHS) == set(JARCHS)
    for arch in ARCHS:
        T.check_supported(get_config(arch))
    assert internvl2_76b.N_IMAGE_TOKENS == jinternvl2.N_IMAGE_TOKENS == 256


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_model_lays_out_the_reference_leaves(arch):
    """init_model draws the JAX init's leaves at their shapes: the
    per-codebook tables, leading dense layers, MLA projections and expert
    banks (per layer here, stacked there)."""
    jcfg, cfg = _configs(arch)
    params = T.init_model(cfg, seed=1, device="cpu")
    jparams = jax.eval_shape(lambda k: JT.init_model(k, jcfg)[0],
                             jax.random.PRNGKey(0))
    n = len(params["layers"])
    assert n == cfg.n_layers - cfg.first_dense_layers
    want = _shapes({k: v for k, v in jparams.items() if k != "layers"})
    assert _shapes({k: v for k, v in params.items() if k != "layers"}) \
        == want
    want_layer = {k: s[1:] for k, s in _shapes(jparams["layers"]).items()}
    assert all(s[0] == n for s in _shapes(jparams["layers"]).values())
    for lp in params["layers"]:
        assert _shapes(lp) == want_layer


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = _configs("deepseek-v2-236b")
    jp, _ = JL.init_mla(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, cfg, jp, _to_port(_np_tree(jp))


def _mla_ref(mla):
    jcfg = mla[0]
    return jax.jit(lambda p, x, pos, c: JL.mla_attention(
        p, jcfg, x, positions=pos, cache=c))


def _mla_pair(mla, ref, x, positions, jcache, cache, jattn, attn):
    _, cfg, jp, p = mla
    with japi.use_policy(JXLA), japi.use_attention_policy(jattn):
        want, jcache = ref(jp, jnp.asarray(x), jnp.asarray(positions), jcache)
    with torch.no_grad(), api.use_attention_policy(attn):
        got, cache = L.mla_attention(p, cfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(positions),
                                     cache=cache)
    return got.numpy(), np.asarray(want), jcache, cache


def test_mla_cacheless_matches_jax(mla):
    _, cfg, _, _ = mla
    x = np.random.default_rng(0).standard_normal((2, 9, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    got, want, _, _ = _mla_pair(mla, _mla_ref(mla), x, pos, None, None,
                                JUNFUSED, UNFUSED)
    assert got.shape == (2, 9, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("policies", ["unfused", "fused"])
def test_mla_latent_cache_prefill_and_decode_match_jax(mla, policies):
    """A bucketed prefill (row 0's last two columns at position −1, row 1
    full), then four decode steps (row 0 masked at the third): outputs,
    the latent cache's written columns and ``len`` equal JAX's. "fused":
    the JAX flash kernel in interpret mode at (q/k 48, v 32) against the
    port's plain K3."""
    jcfg, cfg, _, _ = mla
    jattn, attn = (JUNFUSED, UNFUSED) if policies == "unfused" else \
        (JFUSED, FUSED)
    B, S, max_len = 2, 8, 16
    rng = np.random.default_rng(1)
    jcache = JL.init_mla_cache(jcfg, B, max_len, jnp.float32)
    cache = L.init_mla_cache(cfg, B, max_len, torch.float32, "cpu")
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32).copy()
    pos[0, 6:] = -1
    steps = [(rng.standard_normal((B, S, cfg.d_model)), pos)]
    nxt = np.array([6, 8], np.int32)
    for i in range(4):
        p = nxt[:, None].copy()
        if i == 2:
            p[0] = -1
        steps.append((rng.standard_normal((B, 1, cfg.d_model)), p))
        nxt = nxt + (p[:, 0] >= 0)
    ref = _mla_ref(mla)
    for i, (x, p) in enumerate(steps):
        got, want, jcache, cache = _mla_pair(
            mla, ref, x.astype(np.float32), p, jcache, cache, jattn, attn)
        live = p >= 0
        _close(got[live], want[live], ATTN_TOLS["float32"], f"step {i}")
        for name in ("ckv", "krope"):
            _close(cache[name][:, :max_len].numpy(), jcache[name],
                   ATTN_TOLS["float32"], f"{name} step {i}")
        np.testing.assert_array_equal(cache["len"].numpy(), jcache["len"])
    assert cache["len"].tolist() == [9, 12]


def test_mla_refuses_paged_caches(mla):
    _, cfg, _, p = mla
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="MLA latent cache"):
        L.mla_attention(p, cfg, x, positions=torch.zeros((1, 2), dtype=int),
                        block_tables=torch.zeros((1, 1), dtype=torch.int32))
    _, mcfg = _configs("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="MLA latent cache"):
        T.init_paged_caches(mcfg, 2, 4, 8, "float32", "cpu")
    params = T.init_model(mcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA latent cache"):
        ServingEngine(mcfg, params, ServeConfig(
            cache_dtype="float32", device="cpu",
            attention=AttentionPolicy(backend="paged", page_size=8)))
    # the default policy serves MLA from contiguous caches
    eng = ServingEngine(mcfg, params, ServeConfig(
        batch_slots=2, max_len=16, cache_dtype="float32", device="cpu"))
    assert not eng.paged and "ckv" in eng.caches[0]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_setup(arch, seed=4, **kw):
    jcfg, cfg = _configs(arch)
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = dataclasses.replace(cfg, **kw)
    jp, _ = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, _np_tree(jp)


def _dropped_pairs(jcfg, jp, x):
    """(token, choice) pairs past their expert's capacity, from JAX's own
    routing (the reference's dispatch arithmetic, in numpy)."""
    B, S, D = x.shape
    E, k = jcfg.n_experts, jcfg.n_experts_active
    G = JL._moe_groups(B * S)
    t = B * S // G
    C = min(max(int(t * k / E * jcfg.capacity_factor), 1), t * k)
    logits = jnp.asarray(x).reshape(G, t, D) @ jp["router"]
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    counts = np.stack([np.bincount(g.reshape(-1), minlength=E)
                       for g in np.asarray(ids)])
    return int(np.maximum(counts - C, 0).sum())


def _moe_pair(jcfg, cfg, jp, np_p, x):
    with japi.use_policy(JXLA):
        want, jaux = jax.jit(lambda p, x: JL.moe(p, jcfg, x))(
            jp, jnp.asarray(x))
    with torch.no_grad():
        got, aux = L.moe(_to_port(np_p), cfg, torch.from_numpy(x))
    return got.numpy(), float(aux), np.asarray(want), float(jaux)


@pytest.mark.parametrize("combine", ["gather", "local"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_matches_jax_with_dropped_tokens(arch, combine):
    """3 x 37 tokens: 3 groups of 37 (the largest divisor <= 32 of 111),
    capacity 11 of ~9.25 pairs an expert on average, so some experts
    overflow and drop; deepseek adds its shared expert."""
    jcfg, cfg, jp, np_p = _moe_setup(arch, moe_combine=combine)
    x = np.random.default_rng(5).standard_normal((3, 37, cfg.d_model)) \
        .astype(np.float32)
    assert _dropped_pairs(jcfg, jp, x) > 0
    got, aux, want, jaux = _moe_pair(jcfg, cfg, jp, np_p, x)
    _close(got, want)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_moe_forced_ties_pick_the_lower_expert():
    """Router columns duplicated in pairs give every token tied
    probabilities; the port's top-k picks what jax.lax.top_k picks (the
    lower index first), on crafted ties and through the whole layer."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = L._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jcfg, cfg, jp, np_p = _moe_setup("dbrx-132b")
    router = np_p["router"].copy()
    router[:, 1::2] = router[:, 0::2]
    np_p["router"] = router
    jp = dict(jp, router=jnp.asarray(router))
    x = np.random.default_rng(6).standard_normal((2, 16, cfg.d_model)) \
        .astype(np.float32)
    lg = torch.from_numpy(x) @ torch.from_numpy(router)
    p = torch.softmax(lg, -1)
    assert torch.equal(p[..., 0::2], p[..., 1::2])          # the ties hold
    _, ids = L._top_k(p, cfg.n_experts_active)
    _, jids = jax.lax.top_k(jnp.asarray(p.numpy()), cfg.n_experts_active)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    got, aux, want, jaux = _moe_pair(jcfg, cfg, jp, np_p, x)
    _close(got, want)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_moe_groups_match_jax():
    for n in list(range(1, 70)) + [96, 111, 127, 128, 512, 1000, 1024]:
        assert L._moe_groups(n) == JL._moe_groups(n), n


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["deepseek-v2-236b", "dbrx-132b"])
def model(request):
    jcfg, cfg = _configs(request.param)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_tree = _np_tree(jparams)
    return jcfg, cfg, np_tree, from_jax_params(np_tree, cfg)


def test_whole_model_cacheless_forward_matches_jax(model):
    jcfg, cfg, np_tree, params = model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    with japi.use_policy(JXLA), japi.use_attention_policy(JUNFUSED):
        want, _, _ = jax.jit(lambda p, b: JT.forward(p, jcfg, b, remat=False))(
            jax.tree_util.tree_map(jnp.asarray, np_tree),
            {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, _, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 9, cfg.vocab)
    _close(got.numpy(), want)


def test_whole_model_contiguous_prefill_and_decode_match_jax(model):
    """Prefill then greedy decode over contiguous caches (the leading dense
    layer's cache first), the port's flash wrapper against the JAX
    unfused attention."""
    jcfg, cfg, np_tree, params = model
    B, S, max_len = 2, 7, 16
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jcaches = JT.init_caches(jcfg, B, max_len, jnp.float32)
    caches = T.init_caches(cfg, B, max_len, torch.float32, "cpu")
    assert len(caches) == cfg.n_layers
    jtok, tok = jnp.asarray(tokens), torch.from_numpy(tokens)
    pos = np.broadcast_to(np.arange(S), (B, S))
    ref = jax.jit(lambda p, b, c: JT.forward(p, jcfg, b, caches=c,
                                             remat=False))
    for i in range(3):
        with japi.use_policy(JXLA), japi.use_attention_policy(JUNFUSED):
            want, jcaches, _ = ref(
                jparams, {"tokens": jtok, "positions": jnp.asarray(pos)},
                jcaches)
        with torch.no_grad(), api.use_attention_policy(FUSED):
            got, caches, _ = T.forward(params, cfg, {
                "tokens": tok, "positions": torch.from_numpy(pos.copy())},
                caches=caches)
        want = np.asarray(want[:, -1])
        _close(got[:, -1].numpy(), want, msg=f"step {i}")
        nxt = want.argmax(-1)[:, None]
        jtok, tok = jnp.asarray(nxt), torch.from_numpy(nxt)
        pos = np.full((B, 1), S + i)


def test_bf16_forward_runs(model):
    """bf16 weights through the same tree: finite logits of the expected
    shape (the expert bank's bf16 products on the card are driven by
    chip_smoke.py)."""
    _, cfg, np_tree, _ = model
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16),
                                    from_jax_params(np_tree, cfg))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 5)))
    with torch.no_grad():
        got, _, _ = T.forward(params, cfg16, {"tokens": tokens})
    assert got.shape == (2, 5, cfg.vocab) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
