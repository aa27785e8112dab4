"""Data-parallel training of the port (``launch/steps.py``,
``train/loop.py`` on ``make_host_mesh()``) on two ranks over gloo, with
the params and moments cut over data (FSDP, ``distributed/fsdp.py``).

The fp32 smollm smoke config (2 layers, vocab 64) with the JAX init: a
DP=2 ``make_train_step_fn`` step — each rank 2 of the 4 rows of the global
batch and its half of every leaf's ``embed`` dim, each leaf gathered where
the model uses it and its gradient reduce-scattered — against the JAX
single-device ``make_train_step_fn`` on the whole batch (xla GEMMs,
unfused attention) within the fp32 train tolerances (``TOLS["float32"]``),
and against the port's own one-device step, the ranks' params gathered
whole after the step; both steps take an lr (``torch_mesh_ranks.DP_LR``)
whose first update is several times that tolerance. Three ``Trainer``
steps on the mesh log the one-device Trainer's losses.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures

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
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.launch import spawn
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import tree_leaves

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jget_smoke_config("smollm-135m", n_layers=2, vocab=64,
                             dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    batch = TokenPipeline(DataConfig(**DATA)).next_batch()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.dp_rank, 2, (params_np, batch, DATA),
                            workdir=str(tmp_path_factory.mktemp("dp2")),
                            timeout_s=180, collective_timeout_s=60,
                            threads=1)
        jstep = JST.make_train_step_fn(
            jcfg, jadamw.AdamWConfig(lr=R.DP_LR), total_steps=10)
        with japi.use_policy(JGemmPolicy(backend="xla")), \
                japi.use_attention_policy(
                    JAttentionPolicy(backend="unfused")):
            jp, _, jm = jax.jit(jstep)(
                jparams, jadamw.adamw_init(jparams),
                jax.tree_util.tree_map(jnp.asarray, batch))
        cfg = R.dp_config()
        want = [a.numpy() for a in tree_leaves(from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp), cfg))]
        init = [a.numpy() for a in tree_leaves(from_jax_params(params_np,
                                                                cfg))]
        one = R.dp_step(cfg, from_jax_params(params_np, cfg), batch, None)
        one_device_bytes = one["held_bytes"]
        solo = R.dp_trainer(cfg, from_jax_params(params_np, cfg), DATA, None)
        ranks = ranks.result()
    return {"jax": (float(jm["loss"]), float(jm["grad_norm"]), want),
            "init": init, "one_device_bytes": one_device_bytes,
            "ranks": ranks, "one": one, "solo": solo}


def test_dp2_step_matches_jax_single_device_step(run):
    """The JAX step moves weights by several times the params' tolerance
    (``R.DP_LR``), so params equal within it come from the same update."""
    jloss, jnorm, want = run["jax"]
    moved = max(float(np.abs(w - i).max())
                for w, i in zip(want, run["init"]))
    assert moved > 3 * ATOL, moved
    for res in run["ranks"]:
        loss, norm, params = (res["step"][k]
                              for k in ("loss", "grad_norm", "params"))
        np.testing.assert_allclose(loss, jloss, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(norm, jnorm, atol=ATOL, rtol=RTOL)
        assert len(params) == len(want)
        for got, w in zip(params, want):
            np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL)


def test_dp2_ranks_agree_and_match_one_device(run):
    """Both ranks' params, gathered whole after the step, are the same
    (one global gradient), within the fp32 tolerances of the one-device
    port step; each rank held half the one-device step's param and moment
    bytes but for the leaves that stay whole. The step's collectives: an
    all-gather of each cut leaf where it is used, a reduce-scatter of its
    gradient, one all-reduce of the whole leaves' gradients with the
    metrics and one of the norm's squares: a layer's leaves gathered
    again in remat's recompute (``R.fsdp_closed_form``)."""
    s0, s1 = (r["step"] for r in run["ranks"])
    assert (s0["loss"], s0["grad_norm"]) == (s1["loss"], s1["grad_norm"])
    for a, b in zip(s0["params"], s1["params"]):
        np.testing.assert_array_equal(a, b)
    one = run["one"]
    np.testing.assert_allclose(s0["loss"], one["loss"], atol=ATOL, rtol=RTOL)
    for a, b in zip(s0["params"], one["params"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    cfg = R.dp_config()
    whole = sum(a.nbytes for a, cut in zip(
        run["init"], R.data_cuts(cfg, 2)) if cut is None)
    # params fp32 + two fp32 moments: 12 bytes a weight, half of each cut
    assert s0["held_bytes"] == (run["one_device_bytes"] + 3 * whole) // 2
    want = R.fsdp_closed_form(cfg, (2, 1))
    for r in run["ranks"]:
        c = r["step"]["collectives"]
        assert c["calls"] == {"all_reduce": 2, "broadcast": 0,
                              **want["calls"]}
        assert {k: c["bytes"][k] for k in want["bytes"]} == want["bytes"]


def test_dp2_trainer_tracks_one_device_trainer(run):
    for res in run["ranks"]:
        got = res["trainer"]
        assert [s for s, _ in got] == [s for s, _ in run["solo"]]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in run["solo"]], atol=1e-5,
                                   rtol=1e-5)


def test_data_shard_and_host_mesh():
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    b = {"tokens": torch.arange(8).reshape(4, 2)}
    assert ST.data_shard(b, mesh) is b
