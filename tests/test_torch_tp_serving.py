"""Tensor-parallel serving of the port (``repro_torch/distributed/tp.py``,
``ServeConfig.mesh``) on two ranks over gloo, against the one-device port
engine and the JAX package.

One group of 2 ranks serves the module (``tests/torch_mesh_ranks.py``):
the fp32 qwen3 smoke config with ``n_layers=2``, ``vocab=64`` and the
sharding overrides cleared, as the reference's runner builds it
(``tests/tp_serving_runner.py``), so heads and the KV pools split. Every
rank's streams and per-step page accounting must equal the one-device
port engine's in each of the runner's scenarios (greedy, seeded
temperature, preempt/resume, prefix-cache COW, int8 KV) and the
contiguous engine's; the greedy streams must also equal the JAX
single-device engine's (paged kernel in interpret mode, the same weights).
The same group runs the sharded GEMM and attention grids of
``tests/parity.py`` (``run_sharded_grid``) at TP=2 against the reference's
unsharded ``api.matmul`` / ``api.linear`` / ``api.attention`` (and the
``mha_ref`` oracle), int8 exact.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from parity import (ATTN_CASES, ATTN_TOLS, DTYPES, SHAPES, TOLS,
                    make_attention_operands, make_operands,
                    make_paged_operands)
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.kernels.ref import mha_ref
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.distributed import tp
from repro_torch.distributed.launch import spawn
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

WORLD = 2
JPAGED = JAttentionPolicy(backend="paged_interpret", page_size=8, block_q=8)
ATTN_BACKENDS = ("fused", "paged")     # the port's, at TP=2


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def gemm_cells():
    """(dtype, shape) → the operands as numpy (bf16 values held in fp32,
    exactly) and the fp bias of the column+bias cell."""
    cells, keys = [], []
    for dtype in DTYPES:
        for shape in SHAPES:
            M, K, N = shape
            a, b = make_operands(dtype, M, K, N)
            bias = None
            if dtype != "int8":
                bias = _f32(jnp.asarray(np.arange(N, dtype=np.float32) * 0.25,
                                        b.dtype))
            conv = np.asarray if dtype == "int8" else _f32
            cells.append((dtype, conv(a), conv(b), bias))
            keys.append((dtype, shape, a, b))
    return cells, keys


def attn_cells():
    cells, keys = [], []
    for dtype in ATTN_TOLS:
        for backend in ATTN_BACKENDS:
            for case in ATTN_CASES:
                q, k, v, qp, kl = make_attention_operands(case, dtype)
                kop, vop, bt = ((*make_paged_operands(k, v),)
                                if backend == "paged" else (k, v, None))
                cells.append((dtype, backend, _f32(q), _f32(kop), _f32(vop),
                              np.asarray(qp), np.asarray(kl),
                              None if bt is None else np.asarray(bt),
                              case.causal))
                keys.append((dtype, backend, case, (q, kop, vop, qp, kl)))
    return cells, keys


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank group (started first, in the background), the one-device
    port engine's scenarios and the JAX engine's greedy streams."""
    jcfg = jget_smoke_config("qwen3-8b", n_layers=2, vocab=64,
                             sharding_overrides=(), dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    gcells, gkeys = gemm_cells()
    acells, akeys = attn_cells()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            spawn, R.tp_serving_rank, WORLD, (params_np, gcells, acells),
            workdir=str(tmp_path_factory.mktemp("tp2")), timeout_s=240,
            collective_timeout_s=60, threads=1)
        cfg = R.tp_config()
        base = R.serve_scenarios(cfg, from_jax_params(params_np, cfg), None)
        families = R.serve_families(None)
        jeng = JServingEngine(jcfg, jparams, JServeConfig(
            batch_slots=2, max_len=32, attention=JPAGED,
            cache_dtype="float32", gemm=JGemmPolicy(backend="xla")))
        prompts = np.random.default_rng(7).integers(0, 64, (2, 6))
        jgen = np.asarray(jeng.generate(prompts.astype(np.int32), 8))
        results = ranks.result()
    return {"ranks": results, "base": base, "jax": jgen,
            "gkeys": gkeys, "akeys": akeys, "families": families}


@pytest.mark.parametrize("scenario", list(R.SCENARIOS))
def test_tp2_streams_equal_one_device(run, scenario):
    """Every rank's streams, page accounting and prefix counters equal the
    one-device port engine's, scenario by scenario."""
    want = run["base"][scenario]
    for rank, res in enumerate(run["ranks"]):
        got = dict(res["serve"][scenario])
        if scenario == "greedy":
            assert got.pop("kv_shards") == WORLD, "the KV pool must split"
            want = {k: v for k, v in want.items() if k != "kv_shards"}
        assert repr(got) == repr(want), (rank, scenario, got, want)


@pytest.mark.parametrize("arch", R.FAMILY_ARCHS)
def test_tp2_families_equal_one_device(run, arch):
    """Every family the engine serves, with its config's own sharding
    overrides (heads or KV heads pinned whole: Q/K/V gathered for
    replicated attention, the MLP and head still sharded) and with them
    cleared: greedy streams at TP=2 equal the one-device engine's."""
    for cleared in (False, True):
        want, _ = run["families"][arch, cleared]
        for res in run["ranks"]:
            got, shards = res["families"][arch, cleared]
            assert got == want, (arch, cleared)
    cfg = R.family_config(arch, cleared=True)
    split = (not cfg.is_mla and cfg.n_kv_heads % WORLD == 0
             and cfg.n_heads % WORLD == 0)
    assert run["ranks"][0]["families"][arch, True][1] == (WORLD if split
                                                          else 1)


def test_shard_caches_match_rank_caches(run):
    """tp.shard_caches cuts whole caches (int8 pools with their scales,
    contiguous K/V) to the shapes the engine's rank caches have."""
    for res in run["ranks"]:
        for kind, (cut, made) in res["caches"].items():
            assert cut == made, kind
        kp = res["caches"]["paged"][1][0]
        assert kp["kp"][2] == kp["k_scale"][1] == 1    # 2 KV heads / 2


def test_ranks_agree_and_communicate(run):
    """Both ranks produced the same streams (every sampled token is the
    same on every rank), sat at their own model coordinate and issued
    all-reduces only."""
    r0, r1 = run["ranks"]
    assert repr(r0["serve"]) == repr(r1["serve"])
    assert r0["mesh"] == ({"data": 1, "model": 2}, {"data": 0, "model": 0})
    assert r1["mesh"] == ({"data": 1, "model": 2}, {"data": 0, "model": 1})
    c = r0["collectives"]
    assert c["calls"]["all_reduce"] > 0 and c["calls"]["broadcast"] == 0
    assert c == r1["collectives"]


def test_tp2_greedy_equals_jax_engine(run):
    """The JAX single-device engine's greedy streams equal the one-device
    port's, and so every TP rank's."""
    np.testing.assert_array_equal(run["base"]["greedy"]["generate"],
                                  run["jax"])
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["serve"]["greedy"]["generate"],
                                      run["jax"])


def _whole(parts, axis, full):
    """The ranks' outputs put back together along ``axis``: each rank's
    slice, or (a replicated fallback) the whole on every rank."""
    if parts[0].shape[axis] == full:
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        return parts[0]
    return np.concatenate(parts, axis=axis)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_gemm_grid(run, dtype):
    """Column-parallel (N split), row-parallel (K split, fp32/int32
    all-reduce) and column+bias at TP=2 against the reference's unsharded
    api.matmul / api.linear at every SHAPES cell: TOLS, int8 exact;
    odd widths take the replicated fallback."""
    pol = JGemmPolicy(backend="xla")
    n = 0
    for i, (dt, shape, a, b) in enumerate(run["gkeys"]):
        if dt != dtype:
            continue
        n += 1
        ref = np.asarray(japi.matmul(a, b, policy=pol)).astype(np.float64)
        outs = [res["gemm"][i] for res in run["ranks"]]
        got = {"col": _whole([o["col"] for o in outs], -1, shape[2]),
               "row": outs[0]["row"]}
        np.testing.assert_array_equal(outs[1]["row"], outs[0]["row"])
        checks = [("col", got["col"], ref), ("row", got["row"], ref)]
        if dtype != "int8":
            bias = jnp.asarray(np.arange(shape[2], dtype=np.float32) * 0.25,
                               b.dtype)
            refb = np.asarray(japi.linear(a, b, bias, policy=pol)
                              ).astype(np.float64)
            checks.append(("colb", _whole([o["colb"] for o in outs], -1,
                                          shape[2]), refb))
        for name, g, w in checks:
            msg = f"{name} {dtype} {shape}"
            if dtype == "int8":
                np.testing.assert_array_equal(g, w, err_msg=msg)
            else:
                atol, rtol = TOLS[dtype]
                np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                           err_msg=msg)
    assert n == len(SHAPES)


@pytest.fixture(scope="module")
def attn_refs(run):
    """(dtype, case name) → the reference's unsharded api.attention over
    the dense K/V (its plain XLA attention) and the mha_ref oracle: what
    the port's head-sharded dense and paged cells must both give."""
    refs = {}
    pol = JAttentionPolicy(backend="unfused")
    for dtype, _, case, _ in run["akeys"]:
        if (dtype, case.name) in refs:
            continue
        q, k, v, qp, kl = make_attention_operands(case, dtype)
        with japi.use_policy(JGemmPolicy(backend="xla")):
            want = jax.jit(lambda *o, c=case.causal: japi.attention(
                *o[:3], q_positions=o[3], kv_valid_len=o[4], causal=c,
                policy=pol))(q, k, v, qp, kl)
        oracle = jax.jit(mha_ref, static_argnames="causal")(
            q, k, v, causal=case.causal, q_positions=qp, kv_valid_len=kl)
        refs[dtype, case.name] = (np.asarray(want, np.float32),
                                  np.asarray(oracle, np.float32))
    return refs


@pytest.mark.parametrize("dtype", list(ATTN_TOLS))
@pytest.mark.parametrize("backend", ATTN_BACKENDS)
def test_sharded_attention_grid(run, attn_refs, dtype, backend):
    """Heads (and a paged pool's KV heads, read through a shuffled block
    table over distractor pages) split over the two ranks through
    tp.attention, put back together, against the reference's unsharded
    api.attention and the mha_ref oracle within ATTN_TOLS; masked rows
    stay exactly zero; MQA cells (Hkv = 1) keep the KV heads whole."""
    atol, rtol = ATTN_TOLS[dtype]
    for i, (dt, be, case, ops) in enumerate(run["akeys"]):
        if (dt, be) != (dtype, backend):
            continue
        want, oracle = attn_refs[dtype, case.name]
        got = _whole([res["attention"][i] for res in run["ranks"]], 2,
                     case.H)
        assert run["ranks"][0]["attention"][i].shape[2] == case.H // WORLD
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=f"{case.name} vs unsharded")
        np.testing.assert_allclose(got, oracle, atol=atol, rtol=rtol,
                                   err_msg=f"{case.name} vs oracle")
        masked = np.asarray(ops[3])[:, 0] < 0
        if masked.any():
            assert np.abs(got[masked]).max() == 0.0, case.name


def test_model_axis_of_one_is_a_noop(run):
    """A (2, 1) mesh — model axis 1 — leaves tp.linear on the plain api
    path (the ranks' cell equals api.matmul bitwise), and in-process a
    (1, 1) mesh does the same without any process group."""
    dtype, a, b, _ = gemm_cells()[0][0]
    want = api.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["gemm_model1"][0]["col"], want)
        np.testing.assert_array_equal(res["gemm_model1"][0]["row"], want)
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("model") is None
    ctx = tp.make_context(mesh)
    assert ctx.model_size == 1 and tp.head_sharding(ctx, 4, 2) == (False,
                                                                   False)
    x, w = torch.ones((2, 8)), torch.ones((8, 4))
    with tp.use_tp(ctx):
        got = tp.linear(x, w, axes=("embed", "mlp"), full=(8, 4))
    assert torch.equal(got, api.linear(x, w))
    with pytest.raises(ValueError, match="divisible"):
        make_host_mesh(model=2)
    with pytest.raises(ValueError, match=">= 1"):
        make_host_mesh(model=0)


def test_tp_engine_rejects_packed_weights():
    """Resident block-major packed weights have no rank slice: the
    combination refuses at construction, as in the reference."""
    cfg = get_smoke_config("smollm-135m", n_layers=1, vocab=64)
    params = T.init_model(cfg, device="cpu")
    mesh = Mesh((1, 1), ("data", "model"))
    for kw in (dict(pack_weights=True), dict(weight_dtype="int8")):
        with pytest.raises(NotImplementedError, match="packed"):
            ServingEngine(cfg, params, ServeConfig(
                batch_slots=1, max_len=16, device="cpu", mesh=mesh, **kw))
    # a one-rank mesh serves as the one-device engine does
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=1, max_len=16, device="cpu", cache_dtype="float32",
        mesh=mesh))
    assert eng.kv_shards() == 1 and eng.generate(np.array([[1, 2]]),
                                                 2).shape == (1, 2)
