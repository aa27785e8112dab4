"""Tensor-parallel training of the port (``launch/steps.py::
make_train_step_fn`` on a ``(data, model)`` mesh, ``distributed/tp.py``'s
collectives under autograd) against the JAX package's unsharded step.

One spawn of four ranks over gloo, a (data 2, model 2) mesh: the fp32
qwen3 smoke config with its sharding overrides cleared (4 / 2 heads, so
the heads, the KV heads, d_ff, the vocab of the embedding and the head all
split over the model axis; the q/k norms and the layer norms stay
replicated). A TP=2 step on 2 rows (both data rows fed the same rows, so
the data ranks average two equal gradients: exactly the TP=2 pair's
step) and a DP=2 × TP=2 step on 4 rows, each held against the JAX
``make_train_step_fn`` on the same rows (xla GEMMs, unfused attention):
loss, gradient norm and every param within ``TOLS["float32"]``, each
rank's params gathered whole after the step (``steps.full_params``). A
rank holds its slices over ``model`` and its cut over ``data`` (FSDP), as
``rank_params`` cuts them at the rank's coordinates of an abstract mesh.
The norm leaves' gradients are the same on both model ranks of a data
row.
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
from repro_torch.distributed.launch import spawn
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import tree_leaves

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=3)
MESH = ((2, 2), ("data", "model"))


def _jax_step(jcfg, jparams, batch):
    step = JST.make_train_step_fn(jcfg, jadamw.AdamWConfig(lr=R.DP_LR),
                                  total_steps=10)
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        jp, _, jm = jax.jit(step)(jparams, jadamw.adamw_init(jparams),
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    return float(jm["loss"]), float(jm["grad_norm"]), \
        jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jget_smoke_config("qwen3-8b", n_layers=2, vocab=64,
                             sharding_overrides=(), dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    b4 = TokenPipeline(DataConfig(**DATA)).next_batch()
    b2 = {k: v[:2] for k, v in b4.items()}
    batches = {"tp2": {k: np.concatenate([v, v]) for k, v in b2.items()},
               "dp2tp2": b4}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.tp_train_rank, 4, (params_np, batches),
                            workdir=str(tmp_path_factory.mktemp("tp_train")),
                            timeout_s=240, collective_timeout_s=60,
                            threads=1)
        want = {"tp2": _jax_step(jcfg, jparams, b2),
                "dp2tp2": _jax_step(jcfg, jparams, b4)}
        ranks = ranks.result()
    return {"cfg": R.tp_config(), "init": params_np, "want": want,
            "ranks": ranks}


def _rank_slices(cfg, params_np, rank):
    """The JAX params ``params_np`` cut to ``rank``'s share, as the port
    cuts a rank's (``rank_params``)."""
    mesh = Mesh.abstract(*MESH, rank=rank)
    return [t.numpy() for t in tree_leaves(
        ST.rank_params(cfg, from_jax_params(params_np, cfg), mesh))]


@pytest.mark.parametrize("case", ["tp2", "dp2tp2"])
def test_tp_train_step_matches_jax_unsharded_step(run, case):
    """Each rank's loss, gradient norm and params after the step,
    gathered whole, equal the JAX step's; the step moved the weights by
    several times the tolerance (``R.DP_LR``)."""
    jloss, jnorm, jp = run["want"][case]
    cfg = run["cfg"]
    want = [t.numpy() for t in tree_leaves(from_jax_params(jp, cfg))]
    init = [t.numpy() for t in tree_leaves(
        from_jax_params(run["init"], cfg))]
    for res in run["ranks"]:
        got = res[case]
        np.testing.assert_allclose(got["loss"], jloss, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], jnorm, atol=ATOL,
                                   rtol=RTOL)
        assert len(got["params"]) == len(want)
        moved = max(float(np.abs(w - i).max()) for w, i in zip(want, init))
        assert moved > 3 * ATOL, moved
        for g, w in zip(got["params"], want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_tp_ranks_hold_slices_and_count_collectives(run):
    """The ranks hold their cuts of the leaves (over model, over data or
    both); the step's collectives are the same on every rank: all-reduces,
    and the FSDP all-gathers and reduce-scatters of
    ``R.fsdp_closed_form``."""
    cfg = run["cfg"]
    held = [a.shape for a in _rank_slices(cfg, run["init"], 0)]
    full = [np.shape(a) for a in tree_leaves(
        from_jax_params(run["init"], cfg))]
    assert sum(w != f for w, f in zip(held, full)) >= 8
    calls = [r["dp2tp2"]["collectives"]["calls"] for r in run["ranks"]]
    assert all(c == calls[0] for c in calls)
    assert calls[0]["broadcast"] == 0 and calls[0]["all_reduce"] > 4
    want = R.fsdp_closed_form(cfg, MESH[0])
    for r, res in enumerate(run["ranks"]):
        c = res["dp2tp2"]["collectives"]
        assert {k: c["calls"][k] for k in want["calls"]} == want["calls"]
        assert {k: c["bytes"][k] for k in want["bytes"]} == \
            R.fsdp_closed_form(cfg, MESH[0], r)["bytes"]


def test_norm_gradients_identical_across_model_ranks(run):
    by_coords = {(r["coords"]["data"], r["coords"]["model"]): r["norm_grads"]
                 for r in run["ranks"]}
    for d in (0, 1):
        a, b = by_coords[(d, 0)], by_coords[(d, 1)]
        assert sorted(a) == sorted(b) and len(a) >= 8
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
