"""MoE training under data parallelism (``models/layers.py::moe`` under
``distributed/fsdp.py``'s data context, ``launch/steps.py``) against the
JAX package's single-device step on the global batch.

The fp32 dbrx-132b and deepseek-v2-236b smoke configs (2 layers, vocab
64; deepseek's first layer dense) with the JAX init: a DP=2
``make_train_step_fn`` step on two ranks over gloo — each rank 2 of the 4
rows of the global batch and its FSDP cut of the params — against the
JAX ``make_train_step_fn`` on the whole batch (xla GEMMs, unfused
attention): loss, the load-balance ``aux`` and every param (gathered
whole) within ``TOLS["float32"]``. A rank dispatches its tokens in its
share of the global batch's groups, so each expert keeps the global
capacity, and the aux loss's two means are averaged over the data group
before their product (its gradient the global step's). The groups of a
global batch that do not divide over the data axis raise.
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
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed.launch import spawn
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.optim.adamw import tree_leaves

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=5)


def _jax_step(jcfg, jparams, batch):
    step = JST.make_train_step_fn(jcfg, jadamw.AdamWConfig(lr=R.DP_LR),
                                  total_steps=10)
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        jp, _, jm = jax.jit(step)(jparams, jadamw.adamw_init(jparams),
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    return {"loss": float(jm["loss"]), "aux": float(jm["aux"]),
            "params": jax.tree_util.tree_map(np.asarray, jp)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    batch = TokenPipeline(DataConfig(**DATA)).next_batch()
    jcfgs = {a: jget_smoke_config(a, n_layers=2, vocab=64, dtype="float32")
             for a in R.MOE_ARCHS}
    jparams = {a: JT.init_model(jax.random.PRNGKey(1), c)[0]
               for a, c in jcfgs.items()}
    params_np = {a: jax.tree_util.tree_map(np.asarray, p)
                 for a, p in jparams.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.moe_dp_rank, 2, (params_np, batch),
                            workdir=str(tmp_path_factory.mktemp("moe_dp")),
                            timeout_s=240, collective_timeout_s=60,
                            threads=1)
        want = {a: _jax_step(jcfgs[a], jparams[a], batch) for a in jcfgs}
        ranks = ranks.result()
    return {"want": want, "init": params_np, "ranks": ranks}


@pytest.mark.parametrize("arch", R.MOE_ARCHS)
def test_moe_dp2_step_matches_jax_single_device_step(run, arch):
    """Both ranks' loss, aux and params after the step equal the JAX
    global-batch step's; the step moved the weights by several times the
    tolerance (``R.DP_LR``)."""
    want = run["want"][arch]
    cfg = R.moe_config(arch)
    jp = [t.numpy() for t in tree_leaves(from_jax_params(want["params"],
                                                         cfg))]
    init = [t.numpy() for t in tree_leaves(
        from_jax_params(run["init"][arch], cfg))]
    moved = max(float(np.abs(w - i).max()) for w, i in zip(jp, init))
    assert moved > 3 * ATOL, moved
    assert want["aux"] > 0
    for rk in run["ranks"]:
        got = rk[arch]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got["aux"], want["aux"], atol=ATOL,
                                   rtol=RTOL)
        assert len(got["params"]) == len(jp)
        for g, w in zip(got["params"], jp):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", R.MOE_ARCHS)
def test_moe_dp2_ranks_agree(run, arch):
    a, b = (rk[arch] for rk in run["ranks"])
    assert (a["loss"], a["aux"], a["grad_norm"]) == \
        (b["loss"], b["aux"], b["grad_norm"])
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)


def _data_context(n):
    cfg = R.moe_config("dbrx-132b")
    return FSDP.make_context(cfg, Mesh.abstract((n, 1), ("data", "model")))


@pytest.mark.parametrize("n,T,groups", [(1, 64, 32), (2, 32, 16),
                                        (4, 16, 8), (2, 8, 8)])
def test_rank_groups_are_the_global_batch_groups(n, T, groups):
    """A rank of n takes G / n of the global batch's G groups (the
    reference's groups, aligned with the data shards): each of the global
    size T·n / G."""
    with FSDP.use_fsdp(_data_context(n) if n > 1 else None):
        assert L._rank_groups(T) == groups
    assert (T * n) // (groups * n) == (T * n) // L._moe_groups(T * n)


def test_moe_groups_that_do_not_divide_over_data_raise():
    """31 tokens a rank at DP=2: the global 62 form 31 groups (62's
    largest divisor up to 32), which two ranks cannot split."""
    cfg = R.moe_config("dbrx-132b")
    x = torch.zeros((1, 31, cfg.d_model))
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts)),
         "wi": torch.zeros((cfg.n_experts, cfg.d_model, 2 * cfg.d_ff)),
         "wo": torch.zeros((cfg.n_experts, cfg.d_ff, cfg.d_model))}
    with FSDP.use_fsdp(_data_context(2)), \
            pytest.raises(NotImplementedError, match="31 groups"):
        L.moe(p, cfg, x)
