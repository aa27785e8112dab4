"""Expert parallelism over ``model`` (``tp.shard_params(experts=True)``
through ``steps.rank_params``, ``models/layers.py::moe`` on a rank's
experts) against the JAX package's single-device step on the global
batch.

The fp32 dbrx-132b and deepseek-v2-236b smoke configs (2 layers, vocab
64, 8 experts top-2; deepseek's first layer dense) with the JAX init,
and dbrx with the ``"local"`` combine. Two spawns over gloo, one after
the other: four ranks on the (data 2, model 2) mesh, then two on (1, 2).
On each, a ``make_train_step_fn`` step, each rank holding its experts'
half of both banks (and its FSDP cut over data), equals the JAX
``make_train_step_fn`` step (xla GEMMs, unfused attention): loss, aux,
grad norm and every param, gathered whole, within ``TOLS["float32"]``.
The grad norm is the gate that sees a wrong gradient: AdamW's first
step moves each weight by the sign of its gradient.

Also: a rank's bank slice is its experts' rows and half of each bank's
bytes; experts that do not divide the model axis keep the banks whole;
state written on (2, 2) restores bitwise on one device and on (1, 2);
TP=2 serving holds the banks whole.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from parity import TOLS

import torch_mesh_ranks as R
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed import tp as TP
from repro_torch.distributed.launch import spawn
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.checkpoint import CheckpointManager

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=5)
MESHES = ("2x2", "1x2")


def jax_step(jcfg, jparams, batch, **opt):
    """The JAX package's step on the global batch: loss, aux, grad norm
    and the params after it."""
    step = JST.make_train_step_fn(
        jcfg, jadamw.AdamWConfig(lr=R.DP_LR, **opt), total_steps=10)
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        jp, _, jm = jax.jit(step)(jparams, jadamw.adamw_init(jparams),
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    return {"loss": float(jm["loss"]), "aux": float(jm["aux"]),
            "grad_norm": float(jm["grad_norm"]),
            "params": jax.tree_util.tree_map(np.asarray, jp)}


def _spawn_all(params_np, batch, tmp):
    ckpt = str(tmp / "ckpt")
    out = {}
    for name, world in (("2x2", 4), ("1x2", 2)):
        out[name] = spawn(R.ep_rank, world, (params_np, batch, ckpt),
                          workdir=str(tmp / name), timeout_s=240,
                          collective_timeout_s=60, threads=1)
    return out, ckpt


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    batch = TokenPipeline(DataConfig(**DATA)).next_batch()
    jcfgs = {c: jget_smoke_config(c.split("/")[0], n_layers=2, vocab=64,
                                  dtype="float32", **R.EP_CASES[c])
             for c in R.EP_CASES}
    key = jax.random.PRNGKey(1)
    jparams = {c: JT.init_model(key, jcfg)[0] for c, jcfg in jcfgs.items()}
    params_np = {c: jax.tree_util.tree_map(np.asarray, p)
                 for c, p in jparams.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn_all, params_np, batch,
                            tmp_path_factory.mktemp("ep"))
        want = {c: jax_step(jcfgs[c], jparams[c], batch) for c in jcfgs}
        ranks, ckpt = ranks.result()
    return {"want": want, "init": params_np, "ranks": ranks, "ckpt": ckpt}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(R.EP_CASES))
def test_ep_step_matches_jax_single_device_step(run, mesh, case):
    """Every rank's loss, aux, grad norm and params after the step equal
    the JAX global-batch step's; the step moved the weights by several
    times the tolerance."""
    want = run["want"][case]
    cfg = R.ep_config(case)
    jp = [t.numpy() for t in tree_leaves(from_jax_params(want["params"],
                                                         cfg))]
    init = [t.numpy() for t in tree_leaves(
        from_jax_params(run["init"][case], cfg))]
    assert max(float(np.abs(w - i).max()) for w, i in zip(jp, init)) \
        > 3 * ATOL
    assert want["aux"] > 0
    for rk in run["ranks"][mesh]:
        got = rk[case]
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        assert len(got["params"]) == len(jp)
        for g, w in zip(got["params"], jp):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_ep_ranks_hold_their_experts_rows_and_half_the_banks(run, mesh):
    """A rank holds its experts' contiguous half of both banks (and on
    (2, 2) its data cut of their d_model dim: wi's dim 1, wo's dim 2):
    exactly half the banks' bytes at EP=2, a quarter on (2, 2)."""
    cfg = R.ep_config("dbrx-132b")
    whole = from_jax_params(run["init"]["dbrx-132b"], cfg)
    lp = whole["layers"][0]["moe"]
    for rk in run["ranks"][mesh]:
        m, d = rk["coords"]["model"], rk["coords"]["data"]
        n_data = 2 if mesh == "2x2" else 1
        e = cfg.n_experts // 2
        D = cfg.d_model // n_data
        want = {"wi": lp["wi"][m * e:(m + 1) * e, d * D:(d + 1) * D],
                "wo": lp["wo"][m * e:(m + 1) * e, :, d * D:(d + 1) * D]}
        for k in ("wi", "wo"):
            np.testing.assert_array_equal(rk["banks"][k], want[k].numpy())
        held, full = rk["bank_bytes"]
        assert held * 2 * n_data == full


def test_banks_stay_whole_where_experts_do_not_divide_the_model_axis():
    """On a model axis of 3 the smoke config's 8 experts do not divide:
    the rank keeps both banks whole (as the reference's rules fall back),
    runs every expert (``tp.expert_slice``), and the dry run names the
    banks for a train cell; on 2 they are cut."""
    cfg = R.ep_config("dbrx-132b")
    full = T.init_model(cfg, device="meta")
    for model, E in ((3, cfg.n_experts), (2, cfg.n_experts // 2)):
        mesh = Mesh.abstract((1, model), ("data", "model"))
        held = ST.rank_params(cfg, full, mesh)
        assert held["layers"][0]["moe"]["wi"].shape[0] == E
        with TP.use_tp(ST.tp_context(cfg, mesh)):
            assert TP.expert_slice(cfg.n_experts, E) == (0, E)
    with TP.use_tp(ST.tp_context(cfg, mesh)), \
            pytest.raises(ValueError, match="neither"):
        TP.expert_slice(cfg.n_experts, 3)
    parts = DR._placement_parts(cfg, Mesh.abstract((1, 3), ("data",
                                                            "model")),
                                "train_4k", "train", 4, 4)
    assert [p["part"] for p in parts] == ["MoE expert banks"]
    assert "do not divide" in parts[0]["detail"]
    assert DR._placement_parts(cfg, mesh, "train_4k", "train", 4, 4) == []


def test_mesh_state_restores_bitwise_on_one_device_and_1x2(run):
    """The state after the (2, 2) step, gathered whole and written by
    rank 0, restores bitwise on one device, and on (1, 2), where each
    rank holds half of each bank's experts and the state gathered back
    equals it."""
    saved = run["ranks"]["2x2"][0]["saved"]
    for rk in run["ranks"]["2x2"]:
        for a, b in zip(rk["saved"], saved):
            np.testing.assert_array_equal(a, b)
    cfg = R.ep_config("dbrx-132b")
    params = T.init_model(cfg, device="cpu")
    template = {"params": params, "opt": adamw_init(params)}
    one = ST.rank_state(cfg, CheckpointManager(run["ckpt"]).restore(
        template), None)
    got = [t.numpy() for t in tree_leaves(one)]
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        np.testing.assert_array_equal(a, b)
    wi = (cfg.n_experts // 2, cfg.d_model, 2 * cfg.moe_d_ff)
    for rk in run["ranks"]["1x2"]:
        assert wi in rk["restored"]["shapes"]
        for a, b in zip(rk["restored"]["whole"], saved):
            np.testing.assert_array_equal(a, b)


def test_tp2_serving_holds_the_banks_whole(run):
    """The serving engine's cut (``ServeConfig.mesh``) keeps the 3-D
    banks whole, as the reference's TP serving runs them unsharded."""
    cfg = R.ep_config("dbrx-132b")
    whole = [(cfg.n_experts, cfg.d_model, 2 * cfg.moe_d_ff),
             (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)]
    for rk in run["ranks"]["1x2"]:
        assert rk["serving_banks"] == whole
