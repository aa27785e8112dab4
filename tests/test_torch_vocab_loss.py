"""The vocab-parallel loss (``models/transformer.py::lm_loss`` under a
model axis, ``distributed/tp.py::vocab_parallel_nll``) at TP=2 on two
ranks over gloo.

On the fp32 qwen3 smoke config with its sharding overrides cleared (the
head's 64 vocab columns cut 32 a rank) and the JAX init: the loss and
every gradient of a rank's slices equal those of the loss that gathers
the whole vocab's logits first, within ``TOLS["float32"]``, and the
collectives differ by exactly the gathered logits (the loss's row max,
sum of ``exp`` and label logit move three small all-reduces instead).
Under qwen3's own overrides (its KV heads replicated) the cache-less
attention runs each rank's query heads over its group's KV heads
(``tp.kv_group_slice``), and a TP=2 train step equals the JAX
single-device step. The audio family's head is not whole vocab slices of
each codebook: its loss keeps the gather and equals the one-device loss.
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
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import UNFUSED, GemmPolicy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.launch import spawn
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves

ATOL, RTOL = TOLS["float32"]
B, S, V = 2, 16, 64


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jget_smoke_config("qwen3-8b", n_layers=2, vocab=V,
                             sharding_overrides=(), dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(2), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    batch = TokenPipeline(DataConfig(seq_len=S, global_batch=B, vocab=V,
                                     seed=6)).next_batch()
    audio = get_smoke_config("musicgen-medium", n_layers=2, vocab=V,
                             dtype="float32")
    jaudio = jget_smoke_config("musicgen-medium", n_layers=2, vocab=V,
                               dtype="float32")
    audio_np = jax.tree_util.tree_map(
        np.asarray, JT.init_model(jax.random.PRNGKey(3), jaudio)[0])
    audio_batch = TokenPipeline(DataConfig(
        seq_len=S, global_batch=B, vocab=V, seed=7,
        n_codebooks=audio.n_codebooks)).next_batch()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.vocab_loss_rank, 2,
                            (params_np, batch, audio_np, audio_batch),
                            workdir=str(tmp_path_factory.mktemp("vocab")),
                            timeout_s=240, collective_timeout_s=60,
                            threads=1)
        # the JAX step under qwen3's own overrides (sharding only: the
        # params and the math are the cleared config's)
        jown = jget_smoke_config("qwen3-8b", n_layers=2, vocab=V,
                                 dtype="float32")
        step = JST.make_train_step_fn(jown, jadamw.AdamWConfig(lr=R.DP_LR),
                                      total_steps=10)
        with japi.use_policy(JGemmPolicy(backend="xla")), \
                japi.use_attention_policy(
                    JAttentionPolicy(backend="unfused")):
            jp, _, jm = jax.jit(step)(
                jparams, jadamw.adamw_init(jparams),
                jax.tree_util.tree_map(jnp.asarray, batch))
        with api.use_policy(GemmPolicy(backend="matrixflow")), \
                api.use_attention_policy(UNFUSED), torch.no_grad():
            audio_one = float(T.lm_loss(
                from_jax_params(audio_np, audio), audio,
                {k: torch.from_numpy(v) for k, v in audio_batch.items()})[0])
        ranks = ranks.result()
    own = get_smoke_config("qwen3-8b", n_layers=2, vocab=V, dtype="float32")
    return {"ranks": ranks, "audio_one": audio_one,
            "jax": (float(jm["loss"]), float(jm["grad_norm"]),
                    [t.numpy() for t in tree_leaves(from_jax_params(
                        jax.tree_util.tree_map(np.asarray, jp), own))])}


def test_vocab_parallel_loss_equals_gathered_loss(run):
    for rk in run["ranks"]:
        assert rk["is_vocab_parallel"]
        vp, g = rk["vocab_parallel"], rk["gathered"]
        np.testing.assert_allclose(vp["loss"], g["loss"], atol=ATOL,
                                   rtol=RTOL)
        assert len(vp["grads"]) == len(g["grads"])
        for a, b in zip(vp["grads"], g["grads"]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    a, b = (rk["vocab_parallel"]["loss"] for rk in run["ranks"])
    assert a == b


def test_vocab_parallel_loss_moves_no_logits(run):
    """The gathered loss all-reduces the (B, S, V) fp32 logits once; the
    vocab-parallel one three (B, S - 1) fp32 rows (the max, the sum of
    exp, the label's logit) instead."""
    for rk in run["ranks"]:
        vp = rk["vocab_parallel"]["collectives"]
        g = rk["gathered"]["collectives"]
        assert vp["calls"]["all_reduce"] - g["calls"]["all_reduce"] == 2
        assert g["bytes"]["all_reduce"] - vp["bytes"]["all_reduce"] == \
            B * S * V * 4 - 3 * B * (S - 1) * 4


def test_tp2_step_with_replicated_kv_heads_matches_jax(run):
    """qwen3's own overrides keep its 2 KV heads whole on both ranks:
    each rank attends with its 2 query heads over the KV head of their
    group, and the step equals the JAX single-device step."""
    jloss, jnorm, want = run["jax"]
    for r, rk in enumerate(run["ranks"]):
        assert rk["kv_slice"] == (r, 1)
        got = rk["own_overrides"]
        np.testing.assert_allclose(got["loss"], jloss, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], jnorm, atol=ATOL,
                                   rtol=RTOL)
        assert len(got["params"]) == len(want)
        for g, w in zip(got["params"], want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_audio_loss_gathers_and_equals_one_device(run):
    for rk in run["ranks"]:
        assert rk["audio_vocab_parallel"] is False
        np.testing.assert_allclose(rk["audio"], run["audio_one"], atol=ATOL,
                                   rtol=RTOL)
