"""The port's model (repro_torch/models, repro_torch/convert.py) against the
JAX package's on the smollm-135m smoke config, with the JAX weights
converted (torch's generator cannot reproduce jax.random).

fp32 logits agree within tests/parity.py's TOLS["float32"]. bf16 runs
round at other points in the two frameworks (rmsnorm/rope/silu outputs,
the residual adds, the paged kernel's p) and the differences compound over
the layers: its bound, |Δ| <= BF16_ATOL + BF16_RTOL·|logit|, is stated
below for logits of magnitude ~0.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import TOLS

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.core import api
from repro_torch.core.plan import AttentionPolicy, GemmPolicy
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

BF16_ATOL, BF16_RTOL = 3e-2, 3e-2
PS = 8


def _configs(dtype):
    kw = dict(n_layers=2, vocab=64, dtype=dtype)
    return jget_smoke_config("smollm-135m", **kw), \
        get_smoke_config("smollm-135m", **kw)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def converted(request):
    jcfg, cfg = _configs(request.param)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return request.param, jcfg, cfg, np_tree, from_jax_params(np_tree, cfg)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_config_mirrors_jax_registry():
    jcfg = jget_smoke_config("smollm-135m")
    cfg = get_smoke_config("smollm-135m")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "rope_theta", "dtype", "family"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = get_config("smollm-135m")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (30, 576, 9, 3, 64,
                                                      1536, 49152)
    assert full.param_dtype == torch.bfloat16


def test_from_jax_params_round_trip_bitwise(converted):
    """Every leaf crosses bitwise, each stacked layer leaf unstacked."""
    dtype, jcfg, cfg, np_tree, params = converted
    assert len(params["layers"]) == cfg.n_layers
    assert params["head"].dtype == cfg.param_dtype

    def back(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def walk(np_node, t_node):
        if isinstance(np_node, dict):
            assert set(np_node) == set(t_node)
            for k in np_node:
                walk(np_node[k], t_node[k])
        else:
            np.testing.assert_array_equal(back(t_node), _bits(np_node))

    walk({k: v for k, v in np_tree.items() if k != "layers"},
         {k: v for k, v in params.items() if k != "layers"})
    for i, layer in enumerate(params["layers"]):
        walk(jax.tree_util.tree_map(lambda a, i=i: a[i], np_tree["layers"]),
             layer)


def _jax_paged(jcfg, np_tree, tokens, n_decode):
    """JAX prefill + n_decode greedy steps over paged caches."""
    B, S = tokens.shape
    nb = -(-(S + n_decode) // PS)
    caches = JT.init_paged_caches(jcfg, B, B * nb, PS, jcfg.param_dtype)
    bt = jnp.arange(B * nb, dtype=jnp.int32).reshape(B, nb)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    out = []
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(
                backend="paged_interpret", page_size=PS, block_q=8)):
        batch = {"tokens": jnp.asarray(tokens),
                 "positions": jnp.broadcast_to(jnp.arange(S), (B, S)),
                 "block_tables": bt}
        logits, caches, _ = JT.forward(params, jcfg, batch, caches=caches,
                                       remat=False)
        out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
        for i in range(n_decode):
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            batch = {"tokens": tok,
                     "positions": jnp.full((B, 1), S + i, jnp.int32),
                     "block_tables": bt}
            logits, caches, _ = JT.forward(params, jcfg, batch,
                                           caches=caches, remat=False)
            out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return out


def _port_paged(cfg, params, tokens, n_decode, backend):
    B, S = tokens.shape
    nb = -(-(S + n_decode) // PS)
    caches = T.init_paged_caches(cfg, B, B * nb, PS, cfg.dtype, "cpu")
    bt = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    out = []
    with torch.no_grad(), api.use_policy(GemmPolicy(backend=backend)), \
            api.use_attention_policy(AttentionPolicy(backend="paged",
                                                     page_size=PS)):
        batch = {"tokens": torch.from_numpy(tokens),
                 "positions": torch.arange(S).expand(B, S),
                 "block_tables": bt}
        logits, _ = T.forward(params, cfg, batch, caches=caches)
        out.append(logits[:, -1].float().numpy())
        for i in range(n_decode):
            tok = logits[:, -1].argmax(-1)[:, None]
            batch = {"tokens": tok, "positions": torch.full((B, 1), S + i),
                     "block_tables": bt}
            logits, _ = T.forward(params, cfg, batch, caches=caches)
            out.append(logits[:, -1].float().numpy())
    return out


def _tols(dtype):
    return TOLS["float32"] if dtype == "float32" else (BF16_ATOL, BF16_RTOL)


@pytest.mark.parametrize("backend", ["matrixflow", "blockflow"])
def test_paged_forward_logits_match_jax(converted, backend):
    """Prefill then greedy decode over paged caches: the port's logits at
    every step against JAX T.forward on the same converted weights."""
    dtype, jcfg, cfg, np_tree, params = converted
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 11))
    want = _jax_paged(jcfg, np_tree, tokens, 3)
    got = _port_paged(cfg, params, tokens, 3, backend)
    atol, rtol = _tols(dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=f"step {i}")


def test_cacheless_forward_matches_jax(converted):
    """No cache: full causal self-attention through the unfused backend."""
    dtype, jcfg, cfg, np_tree, params = converted
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        want, _, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray, np_tree),
                                jcfg, {"tokens": jnp.asarray(tokens)},
                                remat=False)
    with torch.no_grad():
        got, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    atol, rtol = _tols(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_masked_positions_write_nothing():
    """Position −1 columns neither write K/V into a named page nor advance
    the valid length (they land in the sink page past the pool)."""
    _, cfg = _configs("float32")
    params = T.init_model(cfg, seed=0, device="cpu")
    caches = T.init_paged_caches(cfg, 2, 4, PS, "float32", "cpu")
    pos = torch.tensor([[0, 1, 2, -1], [-1, -1, -1, -1]])
    batch = {"tokens": torch.ones((2, 4), dtype=torch.long),
             "positions": pos,
             "block_tables": torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)}
    with torch.no_grad(), api.use_attention_policy(
            AttentionPolicy(backend="paged", page_size=PS)):
        T.forward(params, cfg, batch, caches=caches)
    for c in caches:
        assert c["len"].tolist() == [3, 0]
        assert c["kp"].shape[0] == 4 + 1
        written = c["kp"].abs().sum(dim=(1, 2, 3)) > 0
        assert written.tolist() == [False, False, True, False, True]
        assert bool(c["kp"][2, :3].abs().sum(dim=(1, 2)).gt(0).all())
        assert not c["kp"][2, 3:].any()


def test_init_model_shapes_and_determinism():
    _, cfg = _configs("bfloat16")
    p1 = T.init_model(cfg, seed=5, device="cpu")
    p2 = T.init_model(cfg, seed=5, device="cpu")
    assert p1["embed"].shape == (cfg.vocab, cfg.d_model)
    assert p1["head"].shape == (cfg.d_model, cfg.vocab)
    lp = p1["layers"][0]
    assert lp["attn"]["wk"].shape == (cfg.d_model,
                                      cfg.n_kv_heads * cfg.head_dim)
    assert lp["mlp"]["wi"].shape == (cfg.d_model, 2 * cfg.d_ff)
    assert all(torch.equal(a, b) for a, b in
               zip(p1["layers"][1]["mlp"].values(),
                   p2["layers"][1]["mlp"].values()))


def test_unported_configs_and_missing_gpu_raise():
    import dataclasses
    _, cfg = _configs("float32")
    with pytest.raises(NotImplementedError, match="qk_norm"):
        T.init_model(dataclasses.replace(cfg, qk_norm=True), device="cpu")
    with pytest.raises(NotImplementedError):
        get_config("qwen3-8b")
    assert isinstance(cfg, ModelConfig)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.init_model(cfg)                     # default device="cuda"
    t = to_tensor(np.asarray(jnp.ones((2,), jnp.bfloat16)))
    assert t.dtype == torch.bfloat16 and t.tolist() == [1.0, 1.0]
