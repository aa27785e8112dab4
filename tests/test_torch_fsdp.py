"""FSDP over ``data`` (``distributed/fsdp.py``, ``launch/steps.py``) and
checkpoints of sharded state (``steps.full_state`` / ``rank_state``,
``train/checkpoint.py``, ``launch/train.py --ckpt-dir``).

One spawn of four ranks over gloo, a (data 2, model 2) mesh, the fp32
smollm smoke config with the JAX init:

  * a ``make_train_step_fn`` step, each rank holding its cut of every leaf
    over data and its slices over model, equals the JAX single-device
    step on the global batch (loss, grad norm, params gathered whole)
    within ``TOLS["float32"]``;
  * the state after the step, gathered whole and written by rank 0,
    restores bitwise on one device through the port's and the JAX
    package's ``CheckpointManager``; a checkpoint written on one device
    by either restores bitwise on the mesh (each rank cuts its share);
  * ``launch/train.py --dp 2 --tp 2 --ckpt-dir``: two steps, a resume and
    a third equal three steps in one run, bitwise;
  * the dry run's collectives on ``Mesh.abstract`` equal each rank's.

Without ranks: the plan of the cuts, AdamW's decay on a cut, the
qwen3-8b ``train_4k`` dry run's memory gates on the 16 × 16 mesh, and
dbrx-132b's on the 2 × 16 × 16 mesh with its pod all-reduce.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import TOLS

import torch_mesh_ranks as R
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs.registry import SHAPES, get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import UNFUSED, GemmPolicy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed.launch import spawn
from repro_torch.distributed.sharding import mesh_sizes, tree_map_axes
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models import transformer as T
from repro_torch.models.module import param_axes
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train.checkpoint import CheckpointManager

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=8)
MESH = ((2, 2), ("data", "model"))


def _one_device_state(cfg, params, batch):
    """The port's one-device step from ``params``: {"params", "opt"}."""
    step = ST.make_train_step_fn(cfg, AdamWConfig(lr=R.DP_LR),
                                 total_steps=10)
    with api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        p, opt, _ = step(params, adamw_init(params),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"params": p, "opt": opt}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jget_smoke_config("smollm-135m", n_layers=2, vocab=64,
                             dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(4), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    batch = TokenPipeline(DataConfig(**DATA)).next_batch()
    cfg = R.dp_config()
    one = _one_device_state(cfg, from_jax_params(params_np, cfg), batch)
    tmp = tmp_path_factory.mktemp("fsdp")
    ckpts = {"mesh": str(tmp / "mesh"),
             "restore": {"port": str(tmp / "port"), "jax": str(tmp / "jax")}}
    CheckpointManager(ckpts["restore"]["port"], async_save=False).save(
        3, one)
    JCheckpointManager(ckpts["restore"]["jax"], async_save=False).save(
        3, tree_map(lambda t: jnp.asarray(t.numpy()), one))
    cli = {"resumed": str(tmp / "cli_resumed"), "straight": str(tmp /
                                                                "cli")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.fsdp_rank, 4,
                            (params_np, batch, ckpts, cli),
                            workdir=str(tmp / "ranks"), timeout_s=300,
                            collective_timeout_s=60, threads=1)
        step = JST.make_train_step_fn(jcfg, jadamw.AdamWConfig(lr=R.DP_LR),
                                      total_steps=10)
        with japi.use_policy(JGemmPolicy(backend="xla")), \
                japi.use_attention_policy(
                    JAttentionPolicy(backend="unfused")):
            jp, _, jm = jax.jit(step)(
                jparams, jadamw.adamw_init(jparams),
                jax.tree_util.tree_map(jnp.asarray, batch))
        abstract = [DR.run_step(cfg, "train", DATA["global_batch"],
                                DATA["seq_len"],
                                mesh=Mesh.abstract(*MESH, rank=r))
                    for r in range(4)]
        ranks = ranks.result()
    return {"cfg": cfg, "ranks": ranks, "one": one, "ckpts": ckpts,
            "cli": cli, "abstract": abstract,
            "jax": (float(jm["loss"]), float(jm["grad_norm"]),
                    [t.numpy() for t in tree_leaves(from_jax_params(
                        jax.tree_util.tree_map(np.asarray, jp), cfg))])}


def test_fsdp_2x2_step_matches_jax_single_device_step(run):
    jloss, jnorm, want = run["jax"]
    for rk in run["ranks"]:
        got = rk["step"]
        np.testing.assert_allclose(got["loss"], jloss, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], jnorm, atol=ATOL,
                                   rtol=RTOL)
        assert len(got["params"]) == len(want)
        for g, w in zip(got["params"], want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_ranks_hold_a_quarter_of_every_leaf_that_both_axes_cut(run):
    cfg = run["cfg"]
    full = tree_leaves(T.init_model(cfg, device="meta"))
    held = run["ranks"][0]["held_shapes"]
    n_quarter = sum(math.prod(h) * 4 == f.numel()
                    for h, f in zip(held, full))
    assert n_quarter >= 6
    assert all(math.prod(h) < f.numel() for h, f in zip(held, full)
               if len(h))


def test_mesh_checkpoint_restores_bitwise_on_one_device(run):
    """The 2 × 2 mesh's checkpoint (whole arrays by name, rank 0 writing)
    through the port's and the JAX package's managers on one device: the
    ranks' gathered state, bit for bit."""
    saved = run["ranks"][0]["saved"]
    for rk in run["ranks"][1:]:
        for a, b in zip(rk["saved"], saved):
            np.testing.assert_array_equal(a, b)
    d = run["ckpts"]["mesh"]
    port = tree_leaves(CheckpointManager(d).restore(run["one"]))
    jax_ = jax.tree_util.tree_leaves(JCheckpointManager(d).restore(
        tree_map(lambda t: jnp.asarray(t.numpy()), run["one"])))
    assert len(port) == len(jax_) == len(saved)
    for p, j, s in zip(port, jax_, saved):
        assert p.dtype == torch.from_numpy(s).dtype
        np.testing.assert_array_equal(p.numpy(), s)
        np.testing.assert_array_equal(np.asarray(j), s)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_one_device_checkpoint_restores_bitwise_on_mesh(run, writer):
    """A one-device checkpoint (the port's or the JAX package's) restored
    on the mesh: each rank holds its cut (``rank_state``) and the state
    gathered back from the four ranks is the checkpoint's, bit for bit."""
    want = [t.numpy() for t in tree_leaves(run["one"])]
    for rk in run["ranks"]:
        got = rk[writer]
        assert got["shapes"] == rk["held_shapes"]
        for a, b in zip(got["whole"], want):
            np.testing.assert_array_equal(a, b)


def test_train_cli_resumes_sharded_checkpoints_bitwise(run):
    """``launch/train.py --dp 2 --tp 2 --ckpt-dir``: 2 steps, then a run to
    3 that resumes at 2, against 3 steps in one run: the two step-3
    checkpoints are the same arrays."""
    cli = run["ranks"][0]["cli"]
    assert cli["steps"] == {"resumed": [1, 2, 3], "straight": [1, 2, 3]}
    resumed, straight = (CheckpointManager(run["cli"][k]) for k in
                         ("resumed", "straight"))
    cfg = get_smoke_config("smollm-135m")
    template = {"params": T.init_model(cfg, device="cpu")}
    template["opt"] = adamw_init(template["params"])
    a = tree_leaves(resumed.restore(template, 3))
    b = tree_leaves(straight.restore(template, 3))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(torch.int16).numpy()
                                      if x.dtype == torch.bfloat16
                                      else x.numpy(),
                                      y.view(torch.int16).numpy()
                                      if y.dtype == torch.bfloat16
                                      else y.numpy())


def test_abstract_fsdp_collectives_equal_real_run(run):
    """The dry run's train step on ``Mesh.abstract`` at each rank's
    coordinates issues the collectives the rank issued: kinds, calls and
    bytes (the FSDP all-gathers and reduce-scatters, the TP all-reduces,
    the data group's averaging and the norm's)."""
    for rk, res in zip(run["ranks"], run["abstract"]):
        snap = rk["step"]["collectives"]
        assert res["fsdp"] is True
        assert res["collective_counts"] == snap["calls"]
        assert {k: float(v) for k, v in snap["bytes"].items()} == {
            k: res["collectives"][k] for k in snap["bytes"]}
        assert snap["calls"]["all_gather"] > 0
        assert snap["calls"]["reduce_scatter"] > 0


def test_fsdp_plan_cuts_embed_dims():
    """The data axis cuts each leaf's ``embed`` dim where it divides (a
    norm of 128 over 3 ranks stays whole), and the MoE ``wo`` bank's
    d_model dim, which the reference's axes leave unnamed."""
    cfg = R.moe_config("dbrx-132b")
    plan = FSDP.make_plan(cfg, Mesh.abstract((2, 1), ("data", "model")))
    layer = plan["layers"][0]
    assert layer["attn"]["wq"] == FSDP.Cut(0, cfg.d_model)
    assert layer["attn"]["wo"] == FSDP.Cut(1, cfg.d_model)
    assert layer["moe"]["wi"] == FSDP.Cut(1, cfg.d_model)
    assert layer["moe"]["wo"] == FSDP.Cut(2, cfg.d_model)
    assert plan["embed"] == FSDP.Cut(1, cfg.d_model)
    assert plan["final_norm"]["scale"] == FSDP.Cut(0, cfg.d_model)
    odd = FSDP.make_plan(cfg, Mesh.abstract((3, 1), ("data", "model")))
    assert odd["final_norm"]["scale"] is None
    assert FSDP.make_context(cfg, Mesh.abstract((1, 2),
                                                ("data", "model"))) is None


def test_adamw_decays_a_cut_as_its_whole_leaf():
    """A cut keeps its leaf's dims: AdamW on the halves of a matrix and a
    norm scale gives the halves of AdamW on the whole leaves (the matrix
    decayed, the 1-D scale not)."""
    g = torch.Generator().manual_seed(0)
    w, s = torch.randn((4, 6), generator=g), torch.randn((6,), generator=g)
    gw, gs = torch.randn((4, 6), generator=g), torch.randn((6,),
                                                          generator=g)
    cfg = AdamWConfig(weight_decay=0.5)
    params, grads = {"w": w, "s": s}, {"w": gw, "s": gs}
    whole, _, _, _ = adamw_update(params, grads, adamw_init(params), cfg,
                                  0.1, gnorm=torch.tensor(1.0))
    for i in range(2):
        cut = {"w": w.chunk(2, 1)[i].contiguous(), "s": s.chunk(2)[i]}
        gcut = {"w": gw.chunk(2, 1)[i].contiguous(), "s": gs.chunk(2)[i]}
        got, _, _, _ = adamw_update(cut, gcut, adamw_init(cut), cfg, 0.1,
                                    gnorm=torch.tensor(1.0))
        assert torch.equal(got["w"], whole["w"].chunk(2, 1)[i])
        assert torch.equal(got["s"], whole["s"].chunk(2)[i])
    assert not torch.equal(whole["w"], w - 0.1 * torch.sign(gw))


def _spec_bytes(t, spec, sizes):
    n = 1
    for axes in spec:
        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
            n *= sizes[a]
    return t.numel() * t.element_size() // n


def test_dryrun_qwen3_train_4k_memory_gates():
    """qwen3-8b at ``train_4k`` on rank 0 of the 16 × 16 mesh: FSDP on; a
    rank's arguments are its params' and AdamW moments' blocks under
    ``model_shardings``' specs (the reference's placement) plus its rows
    of the batch and the step counter — 0.50 GB, under the 0.66 GB gate
    (7.95 GB before FSDP) — and its temporaries at least 80 GB under the
    169.3 GB before the vocab-parallel loss and the cache-less attention
    on the rank's query heads."""
    cfg = get_config("qwen3-8b")
    res = DR.dryrun_cell("qwen3-8b", "train_4k", verbose=False)
    assert res["fsdp"] is True
    parts = {p["part"] for p in res["parts_from_reference"]}
    assert not parts & {"params and optimizer state", "params",
                        "whole-vocab loss"}
    mesh = Mesh.abstract(*production_mesh_shape())
    sizes = mesh_sizes(mesh)
    full = T.init_model(cfg, device="meta")
    specs = ST.model_shardings(cfg, full, param_axes(cfg),
                               ST.make_rules(cfg, mesh))
    held = ST.rank_params(cfg, full, mesh)
    leaves = []
    tree_map_axes(lambda a, t, h, spec: leaves.append((t, h, spec)),
                  param_axes(cfg), full, held, specs)
    blocks = 0
    for t, h, spec in leaves:
        want = _spec_bytes(t, spec, sizes)
        assert h.numel() * h.element_size() == want, (tuple(h.shape), spec)
        blocks += want // t.element_size()          # elements
    shape = SHAPES["train_4k"]
    rows = shape.batch // mesh.axis_size("data")
    batch = rows * shape.seq * 4                    # int32 tokens
    arg = res["memory"]["argument_size_in_bytes"]
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    assert arg == blocks * (itemsize + 4 + 4) + batch + 4
    assert arg <= 0.66e9
    assert res["memory"]["temp_size_in_bytes"] <= 169.3e9 - 80e9


def test_dryrun_dbrx_train_4k_multi_pod():
    """dbrx-132b at ``train_4k`` on rank 0 of the 2 × 16 × 16 mesh with
    ``compress_grads``: expert parallelism brings a rank's arguments
    under 10 GB (79.8 GB with the banks whole over model); no part of the
    train cell names the MoE banks or the gradient reduction; the step's
    one all-reduce over ``pod`` carries the rank's cut gradients in fp32
    (the closed form), and compression adds one amax max-reduce over data
    (a float a leaf) beside the clip norm's."""
    res = DR.dryrun_cell("dbrx-132b", "train_4k", multi_pod=True,
                         verbose=False, compress_grads=True)
    assert res["memory"]["argument_size_in_bytes"] < 10e9
    parts = {p["part"] for p in res["parts_from_reference"]}
    assert not parts & {"MoE expert banks", "gradient reduction"}
    cfg = get_config("dbrx-132b")
    mesh = Mesh.abstract(*production_mesh_shape(multi_pod=True))
    by_axes = res["collectives_by_axes"]
    assert by_axes["all_reduce:pod"] == {
        "calls": 1, "bytes": R.pod_all_reduce_bytes(cfg, mesh)}
    n_leaves = len(tree_leaves(T.init_model(cfg, device="meta")))
    assert by_axes["all_reduce:data"] == {"calls": 2,
                                          "bytes": 8 + 4 * n_leaves}
