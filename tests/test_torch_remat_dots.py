"""``remat_policy="dots"`` of the port against the JAX package (the
reference's ``jax.checkpoint_policies.checkpoint_dots``).

At smoke width (2 layers, vocab 64, fp32, B 2 x 12 tokens):

* smollm-135m and dbrx-132b (MoE banks) under "dots": loss and every
  gradient within ``TOLS["float32"]`` of the JAX step under "dots", and
  bitwise equal to the port's "full" step, on the block-major backend
  (K1's autograd Function; its plain version here) and on ``torch``
  (``torch.matmul``, the einsums);
* the recompute of "dots" runs no product: a counter on the block-major
  GEMM counts 0 forward GEMMs in it, against one per product of the
  blocks under "full";
* the recompute keeps its record on autograd's device thread too;
* the dry run of a train cell under "dots" counts K1 as with remat off,
  and more temporaries than under "full";
* a recompute that asks for another product than the forward saved
  raises.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses
import threading

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
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import UNFUSED, GemmPolicy
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves

ATOL, RTOL = TOLS["float32"]
ARCHS = ("smollm-135m", "dbrx-132b")
POLICIES = ("full", "dots", "none")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(cfg, params, batch, JAX (loss, grads) under "dots") of one arch."""
    arch = request.param
    kw = dict(n_layers=2, vocab=64, dtype="float32", remat_policy="dots")
    jcfg, cfg = jget_smoke_config(arch, **kw), get_smoke_config(arch, **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(3), jcfg)
    batch = {"tokens": np.random.default_rng(11).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)}
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.lm_loss(p, jcfg, b), has_aux=True))(
                jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    return (cfg, from_jax_params(_np(jparams), cfg), batch,
            (float(loss), from_jax_params(_np(grads), cfg)))


def _grads(cfg, params, batch, backend, policy, *, count=None):
    c = dataclasses.replace(cfg, remat_policy=policy)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with api.use_policy(GemmPolicy(backend=backend)), \
            api.use_attention_policy(UNFUSED):
        return ST.value_and_grad(lambda p: T.lm_loss(p, c, tb), params)


@pytest.fixture(scope="module")
def runs(case):
    """Each (backend, policy)'s ((loss, metrics), grads), and the forward
    GEMMs each ran through the block-major function."""
    cfg, params, batch, _ = case
    out, gemms = {}, {}
    real = api._block_major
    for backend in ("matrixflow", "torch"):
        for policy in POLICIES:
            n = [0]

            def counted(*a, backward=False, **kw):
                n[0] += not backward
                return real(*a, backward=backward, **kw)
            api._block_major = counted
            try:
                out[backend, policy] = _grads(cfg, params, batch, backend,
                                              policy)
            finally:
                api._block_major = real
            gemms[backend, policy] = n[0]
    return out, gemms


@pytest.mark.parametrize("backend", ["matrixflow", "torch"])
def test_dots_step_matches_jax_dots_step(case, runs, backend):
    _, _, _, (jloss, jgrads) = case
    (loss, _), grads = runs[0][backend, "dots"]
    np.testing.assert_allclose(float(loss), jloss, atol=ATOL, rtol=RTOL)
    for g, jg in zip(tree_leaves(grads), tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), jg.numpy(), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("backend", ["matrixflow", "torch"])
def test_dots_step_bitwise_full_step(runs, backend):
    (lf, _), gf = runs[0][backend, "full"]
    (ld, _), gd = runs[0][backend, "dots"]
    assert torch.equal(lf, ld)
    for a, b in zip(tree_leaves(gf), tree_leaves(gd)):
        assert torch.equal(a, b)


def test_dots_recompute_runs_no_gemm(runs):
    """Forward-direction GEMMs of the block-major function: the forward's
    (remat off), twice that under "full" (the recompute repeats them),
    and none in the recompute under "dots"."""
    gemms = runs[1]
    forward = gemms["matrixflow", "none"]
    recompute_full = gemms["matrixflow", "full"] - forward
    assert forward > 0 and recompute_full > 0
    assert gemms["matrixflow", "dots"] - forward == 0


def test_dots_recompute_on_another_thread(case):
    """The recompute may run on autograd's device thread: the block's
    record lives in its function, so a backward started on another thread
    replays it as well (bitwise the "full" step)."""
    cfg, params, batch, _ = case
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        p = {k: v for k, v in params.items()}
        leaves = []

        def leaf(t):
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t
        p = jax.tree_util.tree_map(leaf, p)
        with api.use_policy(GemmPolicy(backend="matrixflow")), \
                api.use_attention_policy(UNFUSED):
            loss, _ = T.lm_loss(p, c, tb)
        out = []
        t = threading.Thread(target=lambda: out.extend(
            torch.autograd.grad(loss, leaves)))
        t.start()
        t.join()
        grads.append(out)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_dots_counts_k1_as_remat_off(arch):
    cfg = get_smoke_config(arch, n_layers=2, vocab=64, d_head=64)
    # B 8 x 128 (phase 20's batch): the blocks' activations, not the
    # params' update, set the peak of the step's temporaries
    res = {p: DR.run_step(dataclasses.replace(cfg, remat_policy=p), "train",
                          8, 128) for p in POLICIES}
    k1 = {p: DR.launch_counters(r)["matrixflow_gemm"] for p, r in res.items()}
    assert k1["dots"] == k1["none"] < k1["full"]
    temps = {p: r["memory"]["temp_size_in_bytes"] for p, r in res.items()}
    assert temps["full"] < temps["dots"] <= temps["none"]


def test_saved_dots_raise_on_another_product():
    rec = api.SavedDots()
    with api.saving_dots(rec):
        rec.product((2, 3), torch.float32, lambda: torch.zeros(2, 3))
    with pytest.raises(RuntimeError, match="saved as"):
        with api.saving_dots(rec):
            rec.product((2, 4), torch.float32, lambda: torch.zeros(2, 4))
    rec = api.SavedDots()
    with api.saving_dots(rec):
        pass
    with pytest.raises(RuntimeError, match="saved 0"):
        with api.saving_dots(rec):
            rec.product((1,), torch.float32, lambda: torch.zeros(1))
