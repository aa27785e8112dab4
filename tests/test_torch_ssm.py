"""The port's Mamba-2 mixer and SSM/hybrid models (repro_torch/models/
ssm.py, transformer.py, convert.py) against the JAX package on the
mamba2-1.3b and zamba2-2.7b smoke configs, with the JAX weights converted.

fp32 logits agree within tests/parity.py's TOLS["float32"]; the mixer's
pieces within tests/test_ssm.py's 1e-4. bf16 runs round at other points in
the two frameworks (conv, silu, the gated norm, the residual adds) and are
held to test_torch_model.py's bf16 bound. Inputs are made with numpy from
a seed. On the CPU the SSD scan runs its plain version.
"""
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
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.core import api
from repro_torch.core.plan import FUSED, UNFUSED, GemmPolicy
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

BF16_ATOL, BF16_RTOL = 3e-2, 3e-2        # test_torch_model.py's bf16 bound
MIXER_TOL = 1e-4                         # tests/test_ssm.py
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


def _configs(arch, dtype):
    kw = dict(vocab=64, dtype=dtype)
    return jget_smoke_config(arch, **kw), get_smoke_config(arch, **kw)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def converted(request):
    arch, dtype = request.param
    jcfg, cfg = _configs(arch, dtype)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return dtype, jcfg, cfg, np_tree, from_jax_params(np_tree, cfg)


def _tols(dtype):
    return TOLS["float32"] if dtype == "float32" else (BF16_ATOL, BF16_RTOL)


def _tree_port(tree):
    if isinstance(tree, dict):
        return {k: _tree_port(v) for k, v in tree.items()}
    return to_tensor(np.asarray(tree))


def test_configs_mirror_jax_registry():
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                          (get_smoke_config(arch), jget_smoke_config(arch))):
            for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab", "ssm_state", "ssm_conv",
                      "ssm_head_dim", "d_inner", "ssm_heads", "attn_every",
                      "dtype"):
                assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
    m, z = get_config("mamba2-1.3b"), get_config("zamba2-2.7b")
    assert (m.n_layers, m.d_model, m.d_inner, m.ssm_heads, m.ssm_head_dim,
            m.ssm_state, m.vocab) == (48, 2048, 4096, 64, 64, 128, 50280)
    assert (z.n_layers, z.d_model, z.ssm_heads, z.ssm_state, z.attn_every,
            z.n_heads, z.head_dim, z.d_ff, z.vocab) == (
                54, 2560, 80, 64, 6, 32, 80, 10240, 32000)


def test_from_jax_params_round_trip_bitwise(converted):
    """Every leaf crosses bitwise — the SSD conv kernels and biases, the
    fp32 A_log, D and dt_bias, and the hybrid's unstacked shared block —
    each stacked layer leaf unstacked."""
    dtype, jcfg, cfg, np_tree, params = converted
    assert len(params["layers"]) == cfg.n_layers
    assert ("shared_attn" in params) == bool(cfg.attn_every)
    ssd = params["layers"][0]["ssd"]
    assert {ssd[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.float32}
    assert ssd["conv_x"].dtype == cfg.param_dtype

    def back(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def bits(a):
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def walk(np_node, t_node):
        if isinstance(np_node, dict):
            assert set(np_node) == set(t_node)
            for k in np_node:
                walk(np_node[k], t_node[k])
        else:
            np.testing.assert_array_equal(back(t_node), bits(np_node))

    walk({k: v for k, v in np_tree.items() if k != "layers"},
         {k: v for k, v in params.items() if k != "layers"})
    for i, layer in enumerate(params["layers"]):
        walk(jax.tree_util.tree_map(lambda a, i=i: a[i], np_tree["layers"]),
             layer)


def test_init_model_shapes_and_determinism():
    for arch in ARCHS:
        cfg = get_smoke_config(arch, vocab=64)
        p1 = T.init_model(cfg, seed=5, device="cpu")
        p2 = T.init_model(cfg, seed=5, device="cpu")
        ssd = p1["layers"][0]["ssd"]
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        assert ssd["w_x"].shape == (cfg.d_model, di)
        assert ssd["w_B"].shape == (cfg.d_model, N)
        assert ssd["w_dt"].shape == (cfg.d_model, H)
        assert ssd["conv_x"].shape == (cfg.ssm_conv, di)
        assert ssd["w_out"].shape == (di, cfg.d_model)
        np.testing.assert_allclose(ssd["A_log"].numpy(),
                                   np.log(np.linspace(1, 16, H)), rtol=1e-6)
        assert float(ssd["dt_bias"][0]) == pytest.approx(np.log(np.e - 1))
        assert ("shared_attn" in p1) == (arch == "zamba2-2.7b")
        assert torch.equal(p1["layers"][1]["ssd"]["w_z"],
                           p2["layers"][1]["ssd"]["w_z"])


def test_causal_conv_matches_jax_and_decode():
    """The full-sequence conv, and token by token through the conv state,
    against the JAX conv."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want, want_state = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b))
    got, state = SSM._causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))
    state = torch.zeros((2, 3, 6))
    outs = []
    for t in range(10):
        y, state = SSM._causal_conv(torch.from_numpy(x[:, t:t + 1]),
                                    torch.from_numpy(w), torch.from_numpy(b),
                                    conv_state=state)
        outs.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_decode_step_continues_prefill_state():
    """S decode-recurrence steps equal the chunked prefill's y and final
    state (tests/test_ssm.py), and each step equals the JAX step."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 1, 16, 2, 4, 8
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((B, S, H)), 0)
                          .astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(H) * 0.5))
                         .astype(np.float32))
    Bc = torch.from_numpy((rng.standard_normal((B, S, N)) * 0.5)
                          .astype(np.float32))
    Cc = torch.from_numpy((rng.standard_normal((B, S, N)) * 0.5)
                          .astype(np.float32))
    y_chunk, hT = SSM.ssd_chunked(x, dt, A, Bc, Cc, chunk=8)
    state = torch.zeros((B, H, P, N))
    jstate = jnp.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        args = [a[:, t:t + 1] for a in (x, dt)] + [A] \
            + [a[:, t:t + 1] for a in (Bc, Cc)]
        y_t, state = SSM.ssd_decode_step(*args, state)
        jy, jstate = JSSM.ssd_decode_step(
            *[jnp.asarray(a.numpy()) for a in args], jstate)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy),
                                   atol=MIXER_TOL, rtol=MIXER_TOL)
        ys.append(y_t[:, 0])
    np.testing.assert_allclose(state.numpy(), hT.numpy(), atol=MIXER_TOL,
                               rtol=MIXER_TOL)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_chunk.numpy(),
                               atol=MIXER_TOL, rtol=MIXER_TOL)


def test_ssd_block_matches_jax_with_and_without_cache():
    """The whole block on converted weights: cache-less, then a prefill
    with a cache followed by decode steps, outputs and the cached conv and
    SSD states against the JAX block's."""
    jcfg, cfg = _configs("mamba2-1.3b", "float32")
    jp, _ = JSSM.init_ssd(jax.random.PRNGKey(4), jcfg, jnp.float32)
    p = _tree_port(jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32) * 0.5
    def pol():
        return japi.use_policy(JGemmPolicy(backend="xla"))

    with pol():
        want, _ = JSSM.ssd_block(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, none = SSM.ssd_block(p, cfg, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MIXER_TOL, rtol=MIXER_TOL)

    jcache = JSSM.init_ssd_cache(jcfg, 2, jnp.float32)
    cache = SSM.init_ssd_cache(cfg, 2, torch.float32, "cpu")
    steps = [x[:, :9]] + [x[:, 9 + i:10 + i] for i in range(3)]
    for xs in steps:
        with pol():
            want, jcache = JSSM.ssd_block(jp, jcfg, jnp.asarray(xs),
                                          cache=jcache)
        with torch.no_grad():
            got, cache = SSM.ssd_block(p, cfg, torch.from_numpy(xs),
                                       cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MIXER_TOL, rtol=MIXER_TOL)
        np.testing.assert_allclose(cache["state"].numpy(),
                                   np.asarray(jcache["state"]),
                                   atol=MIXER_TOL, rtol=MIXER_TOL)
        for k in ("x", "B", "C"):
            np.testing.assert_allclose(cache["conv"][k].numpy(),
                                       np.asarray(jcache["conv"][k]),
                                       atol=1e-5, rtol=1e-5)


def test_cacheless_forward_matches_jax(converted):
    dtype, jcfg, cfg, np_tree, params = converted
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 11))
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        want, _, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray, np_tree),
                                jcfg, {"tokens": jnp.asarray(tokens)},
                                remat=False)
    with torch.no_grad(), api.use_attention_policy(UNFUSED):
        got, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    atol, rtol = _tols(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("backend", ["matrixflow", "blockflow"])
def test_prefill_decode_with_caches_matches_jax(converted, backend):
    """Prefill with caches, then greedy decode steps: the logits of every
    step against JAX T.forward over its own caches (hybrid: the shared
    block's contiguous KV caches through the fused policy).

    The JAX side runs in fp32 on the same weights (bf16 values upcast): a
    bf16 JAX run moves off its own fp32 logits by up to 0.06 at some decode
    steps, where the port's bf16 run stays within 0.02 of them, so bf16
    runs of the two packages are each held to the fp32 computation."""
    dtype, jcfg, cfg, np_tree, params = converted
    B, S, n_decode, max_len = 2, 10, 3, 16
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (B, S))
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.float32), np_tree)
    jcaches = JT.init_caches(jcfg, B, max_len, jnp.float32)
    caches = T.init_caches(cfg, B, max_len, cfg.dtype, "cpu")
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert len(caches) == cfg.n_layers + n_attn
    atol, rtol = _tols(dtype)
    tok = tokens
    for i in range(n_decode + 1):
        pos = np.broadcast_to(np.arange(S) if i == 0 else [[S + i - 1]],
                              tok.shape)
        with japi.use_policy(JGemmPolicy(backend="xla")), \
                japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
            want, jcaches, _ = JT.forward(
                jparams, jcfg, {"tokens": jnp.asarray(tok),
                                "positions": jnp.asarray(pos)},
                caches=jcaches, remat=False)
        with torch.no_grad(), api.use_policy(GemmPolicy(backend=backend)), \
                api.use_attention_policy(FUSED):
            got, _ = T.forward(params, cfg,
                               {"tokens": torch.from_numpy(tok),
                                "positions": torch.from_numpy(pos.copy())},
                               caches=caches)
        want = np.asarray(want[:, -1])
        np.testing.assert_allclose(got[:, -1].float().numpy(), want,
                                   atol=atol, rtol=rtol, err_msg=f"step {i}")
        tok = want.argmax(-1)[:, None]


def test_unsupported_ssm_variants_raise():
    cfg = get_smoke_config("mamba2-1.3b")
    with pytest.raises(NotImplementedError, match="attn_every"):
        T.check_supported(dataclasses.replace(cfg, attn_every=2))
    with pytest.raises(NotImplementedError, match="SSM"):
        T.check_supported(dataclasses.replace(cfg, family="dense"))
    z = get_smoke_config("zamba2-2.7b")
    with pytest.raises(NotImplementedError, match="multiple of attn_every"):
        T.check_supported(dataclasses.replace(z, n_layers=5))
    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="SSD recurrent state"):
            T.init_paged_caches(get_smoke_config(arch), 1, 4, 8, "float32",
                                "cpu")
