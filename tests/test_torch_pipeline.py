"""The port's GPipe pipeline (``repro_torch/distributed/pipeline.py``) on
four ranks over gloo against the JAX sequential version: the script of
``tests/test_pipeline.py`` (S 4 stages x 2 layers, μ 6 microbatches of 3,
d 16, ``tanh(h @ w)`` layers), the forward within 1e-5 of the sequential
forward and the gradient of sum(out²) within 1e-4 of
``jax.grad(loss_seq)``. Each rank holds only its stage's layers
(``tests/torch_mesh_ranks.py::pipeline_rank``)."""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro_torch.distributed.launch import spawn
from repro_torch.distributed.pipeline import stack_for_stages

S, LPERS, MU, MB, D = 4, 2, 6, 3, 16
L = S * LPERS


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    ws = jax.random.normal(key, (L, D, D), jnp.float32) * (1.0 / D ** 0.5)
    x = jax.random.normal(jax.random.fold_in(key, 1), (MU, MB, D))

    def seq_apply(ws, x):
        h = x
        for i in range(L):
            h = jnp.tanh(h @ ws[i])
        return h

    def loss_seq(ws):
        return jnp.sum(jax.vmap(seq_apply, in_axes=(None, 0))(ws, x) ** 2)

    ref = np.asarray(jax.vmap(seq_apply, in_axes=(None, 0))(ws, x))
    gref = np.asarray(jax.grad(loss_seq)(ws))
    ranks = spawn(R.pipeline_rank, S, (np.asarray(ws), np.asarray(x)),
                  workdir=str(tmp_path_factory.mktemp("pipe")),
                  timeout_s=180, collective_timeout_s=60, threads=1)
    return ref, gref, ranks


def test_pipeline_forward_matches_sequential(run):
    ref, _, ranks = run
    for res in ranks:            # every rank holds the last stage's outputs
        np.testing.assert_allclose(res["out"], ref, atol=1e-5, rtol=1e-5)


def test_pipeline_backward_matches_sequential(run):
    _, gref, ranks = run
    got = np.concatenate([res["grad"] for res in ranks])   # stage-major
    np.testing.assert_allclose(got, gref, atol=1e-4, rtol=1e-4)


def test_pipeline_hops_are_broadcasts(run):
    """μ + S − 1 ticks: every tick after the first hands one microbatch on
    between each pair of neighbours, forward and backward, and one
    all-reduce brings the outputs to every rank."""
    _, _, ranks = run
    ticks = MU + S - 1
    for s, res in enumerate(ranks):
        c = res["collectives"]["calls"]
        pairs = (s > 0) + (s < S - 1)
        assert c["broadcast"] == 2 * (ticks - 1) * pairs, (s, c)
        assert c["all_reduce"] == 1


def test_stack_for_stages():
    layers = list(range(8))
    assert stack_for_stages(layers, 4) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    t = torch.arange(8 * 3).reshape(8, 3)
    assert stack_for_stages({"w": t}, 2)["w"].shape == (2, 4, 3)
    with pytest.raises(ValueError, match="stages"):
        stack_for_stages(layers, 3)
