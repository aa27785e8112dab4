"""The port's BERT/ViT encoders (repro_torch/models) against the JAX
package's, with the JAX weights converted by ``from_jax_params``.

The JAX init leaves every LayerNorm scale at 1 and every bias at 0, which
would hide a dropped or misplaced bias; the tests draw those leaves from
a seeded numpy generator and hand the same tree to both packages. fp32
agrees within tests/parity.py's TOLS["float32"]; the layer tests also run
bf16 within TOLS["bfloat16"].
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import TOLS

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.core import api
from repro_torch.core.plan import FUSED, PAGED, UNFUSED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("bert-base", "vit-base")


def _randomize_affine(np_tree, seed):
    """Replace norm scales/biases and MLP biases with seeded random values
    (the JAX init makes them 1 and 0)."""
    rng = np.random.default_rng(seed)

    def rec(node, key=None):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if key in ("scale", "bias", "bi", "bo"):
            base = 1.0 if key == "scale" else 0.0
            x = base + 0.2 * rng.standard_normal(node.shape)
            return np.asarray(jnp.asarray(x, jnp.float32).astype(node.dtype))
        return node

    return rec(np_tree)


def _pair(arch, dtype="float32", seed=0):
    jcfg = jget_smoke_config(arch, dtype=dtype)
    cfg = get_smoke_config(arch, dtype=dtype)
    jparams, _ = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    np_tree = _randomize_affine(jax.tree_util.tree_map(np.asarray, jparams),
                                seed)
    return jcfg, cfg, np_tree, from_jax_params(np_tree, cfg)


def _batch(cfg, B=2, S=13, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "vit":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_matches_jax(dtype, with_bias):
    rng = np.random.default_rng(1)
    x = jnp.asarray(3 + 2 * rng.standard_normal((2, 5, 48)),
                    jnp.float32).astype(dtype)
    p = {"scale": jnp.asarray(1 + 0.3 * rng.standard_normal(48),
                              jnp.float32).astype(dtype)}
    if with_bias:
        p["bias"] = jnp.asarray(rng.standard_normal(48),
                                jnp.float32).astype(dtype)
    want = np.asarray(JL.layernorm(p, x).astype(jnp.float32))
    tp = {k: to_tensor(np.asarray(v)) for k, v in p.items()}
    got = L.layernorm(tp, to_tensor(np.asarray(x)))
    assert got.dtype == to_tensor(np.asarray(x)).dtype
    atol, rtol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """The encoders' MLP: x·wi + bi → tanh-approximated GELU (jax.nn.gelu's
    default) → ·wo + bo."""
    jcfg, cfg, np_tree, params = _pair("bert-base", dtype, seed=2)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 7, cfg.d_model)), jnp.float32).astype(dtype)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a[0]), np_tree["layers"]["mlp"])
    with japi.use_policy(JGemmPolicy(backend="xla")):
        want = np.asarray(JL.mlp(jp, jcfg, x).astype(jnp.float32))
    got = L.mlp(params["layers"][0]["mlp"], cfg, to_tensor(np.asarray(x)))
    atol, rtol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)
    erf = torch.nn.functional.gelu(torch.tensor([1.5]))
    tanh = torch.nn.functional.gelu(torch.tensor([1.5]), approximate="tanh")
    assert float(jax.nn.gelu(1.5)) == pytest.approx(float(tanh), abs=1e-6)
    assert float(erf) != pytest.approx(float(tanh), abs=1e-6)


@pytest.mark.parametrize("policy", [UNFUSED, FUSED, PAGED],
                         ids=["unfused", "fused", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_forward_matches_jax(arch, policy):
    """Reduced BERT (tokens) and ViT (stub patch embeddings): 2 layers,
    d_model 128, fp32 logits over every position within TOLS, through each
    attention backend (``paged`` without a block table is the flash
    kernel's plain version)."""
    jcfg, cfg, np_tree, params = _pair(arch, seed=3)
    batch = _batch(cfg, seed=3)
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        want = np.asarray(JT.encoder_forward(
            jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg,
            {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad(), api.use_attention_policy(policy):
        got = T.encoder_forward(params, cfg,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert tuple(got.shape) == want.shape == (2, 13, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, *TOLS["float32"])


def test_from_jax_params_carries_encoder_biases():
    for arch in ARCHS:
        _, cfg, np_tree, params = _pair(arch, seed=4)
        assert set(params["final_norm"]) == {"scale", "bias"}
        for i in range(cfg.n_layers):
            lp = params["layers"][i]
            assert set(lp["mlp"]) == {"wi", "bi", "wo", "bo"}
            for blk, key in (("attn_norm", "bias"), ("mlp_norm", "scale"),
                             ("mlp", "bi"), ("mlp", "bo")):
                np.testing.assert_array_equal(
                    lp[blk][key].numpy(), np_tree["layers"][blk][key][i])


@pytest.mark.parametrize("arch", ["bert-base", "vit-huge", "bert-medium",
                                  "bert-large", "vit-base", "vit-large"])
def test_config_matches_reference(arch):
    """Field for field against the reference's bert_config/vit_config."""
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


def test_encoder_init_shapes_and_rejections():
    cfg = get_smoke_config("vit-huge")
    params = T.init_model(cfg, seed=0, device="cpu")
    lp = params["layers"][0]
    assert lp["attn_norm"]["bias"].shape == (cfg.d_model,)
    assert lp["mlp"]["wi"].shape == (cfg.d_model, cfg.d_ff)
    assert lp["mlp"]["bi"].shape == (cfg.d_ff,)
    assert params["head"].shape == (cfg.d_model, cfg.vocab)
    with pytest.raises(NotImplementedError, match="causal"):
        T.init_model(dataclasses.replace(cfg, causal=True), device="cpu")
    with pytest.raises(NotImplementedError, match="GQA"):
        T.init_model(dataclasses.replace(cfg, n_kv_heads=1), device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        T.init_caches(cfg, 2, 16, "float32", "cpu")
