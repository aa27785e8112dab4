"""Training in the port (ROADMAP queue 1 item 8) against the JAX package, on
the CPU at smoke shapes, fp32 unless a test says otherwise:

* ``optim``: ``cosine_schedule`` within 1e-7; ``adamw_update`` on the same
  numpy params and grads within 2 fp32 ulps (``rtol=2.4e-7``, ``atol``
  1e-12: the two packages' ``pow`` for the bias corrections may differ in
  the last bit), with and without int8 compression; ``quantize_int8``
  bitwise;
* ``data``: ``TokenPipeline`` batches bitwise (tokens, codebooks, image
  embeddings, host shards, resumed cursors);
* ``train/checkpoint``: JAX → port and port → JAX bitwise (bf16, fp32,
  int32 leaves), and the reference's keep-N, atomic and async tests;
* ``lm_loss`` and every gradient leaf against ``jax.value_and_grad`` for
  smollm (and its explicit-labels branch), qwen2 (QKV biases), dbrx (the
  MoE aux loss), deepseek (MLA + MoE), internvl2 (the image prefix),
  musicgen (per-codebook labels) and mamba2 (the plain SSD scan), through
  ``GemmPolicy(backend="matrixflow")`` — the autograd Function over K1's
  plain version, its backward K1's plain version again — and ``torch``;
  tolerance ``TOLS["float32"]`` (tests/parity.py);
* the K1 Function at shapes that pad every block, the batched rhs, and the
  unfused attention with its gradient against the JAX unfused attention;
* remat on equals remat off, bitwise;
* ``make_train_step_fn`` with two microbatches against the reference's;
* the port's ``Trainer`` against the JAX ``Trainer`` from the same params
  and data, per-step losses over 5 steps within 1e-5 without weight decay
  and 5e-4 with it (the reference also decays its stacked (n_layers, d)
  norm scales, the port's 1-D ones not: ROADMAP.md, reference caveats);
* resume after a SIGTERM checkpoint equals the uninterrupted run bitwise;
* the forward-only kernel wrappers (K2–K6) raise under autograd, a packed
  weight under autograd raises, SSD training on a CUDA device raises;
* ``python -m repro_torch.launch.train ... --device cpu`` exits 0.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim.schedule import cosine_schedule as jcosine
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import (FUSED, UNFUSED, GemmPolicy, pack_weight)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ssd_scan as K6
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, Trainer, check_trainable

ATOL, RTOL = TOLS["float32"]
JXLA = JGemmPolicy(backend="xla")
JUNFUSED = JAttentionPolicy(backend="unfused")
REPO = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 25), (1, 2), (20, 10)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in range(0, 30):
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              base_lr=3e-4, warmup=warmup, total=total)
        want = jcosine(jnp.asarray(step, jnp.int32), base_lr=3e-4,
                       warmup=warmup, total=total)
        assert abs(float(got) - float(want)) <= 1e-7, (step, got, want)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "layers": [{"k": rng.standard_normal((4, 4, 2)).astype(np.float32)}
                       for _ in range(2)]}


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_jax(compress):
    cfg_kw = dict(lr=1e-2, compress_grads=compress, grad_clip=0.5)
    params = _opt_tree(0)
    jp, tp = (jax.tree_util.tree_map(jnp.asarray, params),
              tree_map(torch.from_numpy, params))
    jstate, tstate = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    jerr = terr = None
    for step in range(3):
        grads = _opt_tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, jstate, jm, jerr = jadamw.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            jadamw.AdamWConfig(**cfg_kw), jnp.float32(lr), jerr)
        tp, tstate, tm, terr = tadamw.adamw_update(
            tp, tree_map(torch.from_numpy, grads), tstate,
            tadamw.AdamWConfig(**cfg_kw), torch.tensor(lr), terr)
        _close(tm["grad_norm"], jm["grad_norm"], atol=1e-12, rtol=2.4e-7)
        for name, j, t in (("params", jp, tp), ("mu", jstate["mu"],
                                                 tstate["mu"]),
                           ("nu", jstate["nu"], tstate["nu"])):
            for a, b in zip(jax.tree_util.tree_leaves(j), tree_leaves(t)):
                _close(b, a, atol=1e-12, rtol=2.4e-7, msg=name)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        if compress:
            for a, b in zip(jax.tree_util.tree_leaves(jerr),
                            tree_leaves(terr)):
                _close(b, a, atol=1e-12, rtol=2.4e-7, msg="err")


def test_adamw_weight_decay_matrices_only_and_dtype_kept():
    p = {"w": torch.ones((2, 2), dtype=torch.bfloat16),
         "s": torch.ones((2,), dtype=torch.bfloat16)}
    g = tree_map(torch.zeros_like, p)
    out, state, _, _ = tadamw.adamw_update(
        p, g, tadamw.adamw_init(p), tadamw.AdamWConfig(weight_decay=0.5),
        torch.tensor(0.1))
    assert out["w"].dtype == torch.bfloat16 and state["mu"]["w"].dtype \
        == torch.float32
    assert float(out["w"][0, 0]) < 1.0 and float(out["s"][0]) == 1.0


def test_quantize_int8_bitwise():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((33, 17)).astype(np.float32) * 3
    err = rng.standard_normal((33, 17)).astype(np.float32) * 1e-2
    for e in (None, err):
        jd, je = jadamw.quantize_int8(jnp.asarray(g),
                                      None if e is None else jnp.asarray(e))
        td, te = tadamw.quantize_int8(torch.from_numpy(g),
                                      None if e is None else
                                      torch.from_numpy(e))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seq_len=16, global_batch=4, vocab=100, seed=3),
    dict(seq_len=8, global_batch=2, vocab=50, n_codebooks=4, seed=1),
    dict(seq_len=8, global_batch=2, vocab=50, n_image_tokens=3, seed=2)])
def test_token_pipeline_bitwise(kw):
    for host in ((0, 1), (1, 2)):
        jp = JTokenPipeline(JDataConfig(**kw), host_id=host[0],
                            n_hosts=host[1])
        tp = TokenPipeline(DataConfig(**kw), host_id=host[0],
                           n_hosts=host[1])
        for _ in range(3):
            a, b = jp.next_batch(), tp.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert jp.state_dict() == tp.state_dict()
    tp2 = TokenPipeline(DataConfig(**kw))
    tp2.load_state_dict({"cursor": 1, "seed": kw["seed"]})
    jp2 = JTokenPipeline(JDataConfig(**kw))
    jp2.next_batch()
    np.testing.assert_array_equal(tp2.next_batch()["tokens"],
                                  jp2.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"a": rng.standard_normal((2, 3)).astype(np.float32),
                       "layers": [{"w": rng.standard_normal((3, 2)).astype(
                           np.float32)} for _ in range(2)],
                       "b": rng.standard_normal((4,)).astype(np.float32)},
            "opt": {"step": np.asarray(7, np.int32)}}


def _bf16_bits_jax(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


def test_checkpoint_jax_to_port_bitwise(tmp_path):
    tree = _ckpt_np()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["params"]["b"] = jtree["params"]["b"].astype(jnp.bfloat16)
    JCheckpointManager(str(tmp_path), async_save=False).save(
        4, jtree, extra={"data": {"cursor": 4, "seed": 0}})
    cm = CheckpointManager(str(tmp_path))
    template = tree_map(torch.from_numpy, tree)
    template["params"]["b"] = template["params"]["b"].bfloat16()
    out = cm.restore(template)
    assert out["params"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["params"]["b"].view(torch.int16).numpy().view(np.uint16),
        _bf16_bits_jax(tree["params"]["b"]))
    for key in ("a",):
        np.testing.assert_array_equal(out["params"][key].numpy(),
                                      tree["params"][key])
    for i in range(2):
        np.testing.assert_array_equal(out["params"]["layers"][i]["w"].numpy(),
                                      tree["params"]["layers"][i]["w"])
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["opt"]["step"]) == 7
    assert cm.meta()["extra"]["data"]["cursor"] == 4 and cm.latest_step() == 4


def test_checkpoint_port_to_jax_bitwise(tmp_path):
    tree = _ckpt_np(1)
    ttree = tree_map(torch.from_numpy, tree)
    ttree["params"]["b"] = ttree["params"]["b"].bfloat16()
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(2, ttree, extra={"data": {"cursor": 2, "seed": 0}})
    cm.wait()
    jtemplate = jax.tree_util.tree_map(jnp.asarray, tree)
    out = JCheckpointManager(str(tmp_path)).restore(jtemplate)
    assert out["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["params"]["b"]).view(
        np.uint16), ttree["params"]["b"].view(torch.int16).numpy().view(
        np.uint16))
    np.testing.assert_array_equal(np.asarray(out["params"]["a"]),
                                  tree["params"]["a"])
    np.testing.assert_array_equal(np.asarray(out["params"]["layers"][1]["w"]),
                                  tree["params"]["layers"][1]["w"])
    assert np.asarray(out["opt"]["step"]).dtype == np.int32


def _state():
    return {"params": {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_keep_n_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        cm.save(s, _state())
    assert cm.all_steps() == [3, 4]


def test_checkpoint_atomic_no_partial(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, _state())
    os.makedirs(tmp_path / ".tmp_step_2", exist_ok=True)
    (tmp_path / ".tmp_step_2" / "arrays.npz").write_bytes(b"partial garbage")
    assert cm.all_steps() == [1] and cm.latest_step() == 1


def test_checkpoint_async_save_and_specific_step(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5, async_save=True)
    s = _state()
    cm.save(1, s)
    s2 = {"params": {"a": s["params"]["a"] + 100,
                     "nested": s["params"]["nested"]}, "opt": s["opt"]}
    cm.save(2, s2)
    cm.wait()
    assert cm.latest_step() == 2
    out1, out2 = cm.restore(s, step=1), cm.restore(s, step=2)
    assert float(out2["params"]["a"][0, 1] - out1["params"]["a"][0, 1]) == 100
    assert out1["params"]["nested"]["b"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# lm_loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

FAMILIES = ("smollm-135m", "qwen2-1.5b", "dbrx-132b", "deepseek-v2-236b",
            "internvl2-76b", "musicgen-medium", "mamba2-1.3b")
N_IMG = 3
_CASES = {}


def _case(arch, labels=False):
    """(jcfg, cfg, jparams, params, numpy batch, JAX (loss, metrics),
    JAX grads as the port's tree), cached per module."""
    key = (arch, labels)
    if key in _CASES:
        return _CASES[key]
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg, cfg = jget_smoke_config(arch, **kw), get_smoke_config(arch, **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(1), jcfg)
    np_params = _np(jparams)
    rng = np.random.default_rng(7)
    B, S = 2, 12
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (B, N_IMG, cfg.d_model)).astype(np.float32)
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)

    def loss_fn(p, b):
        return JT.lm_loss(p, jcfg, b)

    with japi.use_policy(JXLA), japi.use_attention_policy(JUNFUSED):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jparams, jax.tree_util.tree_map(
                jnp.asarray, batch))
    _CASES[key] = (jcfg, cfg, jparams, from_jax_params(np_params, cfg),
                   batch, (float(loss), _np(metrics)),
                   from_jax_params(_np(grads), cfg))
    return _CASES[key]


def _port_grads(cfg, params, batch, backend, remat=None):
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with api.use_policy(GemmPolicy(backend=backend)), \
            api.use_attention_policy(UNFUSED):
        return ST.value_and_grad(lambda p: T.lm_loss(p, cfg, tb), params)


@pytest.mark.parametrize("backend", ["matrixflow", "torch"])
@pytest.mark.parametrize("arch,labels", [(a, False) for a in FAMILIES]
                         + [("smollm-135m", True)])
def test_lm_loss_and_grads_match_jax(arch, labels, backend):
    jcfg, cfg, _, params, batch, (jloss, jmetrics), jgrads = \
        _case(arch, labels)
    (loss, metrics), grads = _port_grads(cfg, params, batch, backend)
    _close(loss, jloss, msg="loss")
    _close(metrics["aux"], jmetrics["aux"], msg="aux")
    if cfg.is_moe:
        assert float(metrics["aux"]) > 0
    jl, tl = tree_leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and b.dtype == a.dtype
        _close(b, a.numpy(), msg=arch)
    assert max(float(g.abs().max()) for g in tl) > 0


def test_remat_on_equals_off_bitwise():
    for arch in ("smollm-135m", "dbrx-132b"):
        _, cfg, _, params, batch, _, _ = _case(arch)
        on = _port_grads(cfg, params, batch, "matrixflow", remat=True)
        off = _port_grads(cfg, params, batch, "matrixflow", remat=False)
        assert torch.equal(on[0][0], off[0][0])
        for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
            assert torch.equal(a, b)


def test_remat_recompute_keeps_the_forward_policies():
    """The backward pass may run on another thread (autograd's device
    thread on a card), whose thread-local policies are the defaults: the
    recompute must run under the forward's GEMM and attention policies.
    Here the forward runs under the ``torch`` GEMM backend (the default
    on the CPU is ``blockflow``) and the backward on a fresh thread; the
    gradients equal a same-thread backward's bitwise."""
    import threading

    _, cfg, _, params, batch, _, _ = _case("smollm-135m")
    cfg = dataclasses.replace(cfg, remat=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for threaded in (False, True):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with api.use_policy(GemmPolicy(backend="torch")), \
                api.use_attention_policy(UNFUSED):
            loss, _ = T.lm_loss(p, cfg, tb)
        leaves = tree_leaves(p)
        out = []
        run = lambda: out.extend(torch.autograd.grad(loss, leaves))  # noqa
        if threaded:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            run()
        grads.append(out)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The K1 Function, the batched rhs and the unfused attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["matrixflow", "blockflow"])
@pytest.mark.parametrize("lead,M,K,N", [((), 70, 96, 40), ((3,), 5, 33, 17),
                                        ((2, 3), 129, 64, 80)])
def test_block_major_function_grads_match_autograd(backend, lead, M, K, N):
    rng = np.random.default_rng(M + K + N)
    a0 = torch.from_numpy(rng.standard_normal((*lead, M, K)).astype(
        np.float32))
    b0 = torch.from_numpy(rng.standard_normal(
        (*lead, K, N) if lead else (K, N)).astype(np.float32))
    dc = torch.from_numpy(rng.standard_normal((*lead, M, N)).astype(
        np.float32))
    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    c = api.matmul(a, b, policy=GemmPolicy(backend=backend))
    c.backward(dc)
    ar, br = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    torch.matmul(ar.double(), br.double()).backward(dc.double())
    _close(c, torch.matmul(a0.double(), b0.double()).numpy(), atol=1e-4)
    _close(a.grad, ar.grad.numpy(), atol=1e-4)
    _close(b.grad, br.grad.numpy(), atol=1e-4)


def test_block_major_batched_rhs_matches_torch():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((4, 3, 7, 40)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 3, 40, 9)).astype(
        np.float32))
    for backend in ("matrixflow", "blockflow"):
        got = api.matmul(a, b, policy=GemmPolicy(backend=backend))
        _close(got, torch.matmul(a, b).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="leading dims"):
        api.matmul(a[0], b, policy=GemmPolicy(backend="matrixflow"))


@pytest.mark.parametrize("backend,jbackend", [("matrixflow", "blockflow"),
                                              ("torch", "xla")])
def test_unfused_attention_and_grads_match_jax(backend, jbackend):
    rng = np.random.default_rng(11)
    B, Sq, T_, H, Hkv, D = 2, 5, 9, 6, 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T_, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T_, Hkv, D)).astype(np.float32)
    qpos = np.array([[4, 5, 6, 7, 8], [0, 1, -1, 2, 3]], np.int32)
    kvl = np.array([9, 3], np.int32)
    ct = rng.standard_normal((B, Sq, H, D)).astype(np.float32)

    def jf(q, k, v):
        with japi.use_policy(JGemmPolicy(backend=jbackend)):
            o = japi.attention(q, k, v, q_positions=jnp.asarray(qpos),
                               kv_valid_len=jnp.asarray(kvl),
                               policy=JUNFUSED)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with api.use_policy(GemmPolicy(backend=backend)):
        o = api.attention(tq, tk, tv, q_positions=torch.from_numpy(qpos),
                          kv_valid_len=torch.from_numpy(kvl), policy=UNFUSED)
    (o * torch.from_numpy(ct)).sum().backward()
    _close(o, jo)
    for t, g in zip((tq, tk, tv), jg):
        _close(t.grad, g)


# ---------------------------------------------------------------------------
# The train step, the Trainer, resume
# ---------------------------------------------------------------------------

def test_train_step_microbatches_match_jax():
    _, cfg, jparams, params, _, _, _ = _case("smollm-135m")
    jcfg = jget_smoke_config("smollm-135m", n_layers=2, vocab=64,
                             dtype="float32")
    batch = TokenPipeline(DataConfig(seq_len=8, global_batch=4,
                                     vocab=64)).next_batch()
    jstep = JST.make_train_step_fn(jcfg, total_steps=10, microbatches=2)
    with japi.use_policy(JXLA), japi.use_attention_policy(JUNFUSED):
        jp, jo, jm = jax.jit(jstep)(jparams, jadamw.adamw_init(jparams),
                                    jax.tree_util.tree_map(jnp.asarray,
                                                           batch))
    tstep = ST.make_train_step_fn(cfg, total_steps=10, microbatches=2)
    with api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        tp, to, tm = tstep(params, tadamw.adamw_init(params),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tm["loss"], jm["loss"], msg="loss")
    _close(tm["grad_norm"], jm["grad_norm"], msg="grad_norm")
    for a, b in zip(tree_leaves(from_jax_params(_np(jp), cfg)),
                    tree_leaves(tp)):
        _close(b, a.numpy())


@pytest.mark.parametrize("weight_decay,atol", [(0.0, 1e-5), (0.1, 5e-4)])
def test_trainer_tracks_jax_trainer(weight_decay, atol):
    """Per-step losses over 5 steps. Without weight decay within 1e-5; with
    the default decay the reference also decays its stacked (n_layers, d)
    norm scales, which the port (1-D scales) does not: 1e-4 apart by step
    4 at lr 3e-3 here (my CPU run: 1.4e-6, 1.7e-6, 3.4e-5, 9.7e-5, 1.0e-4;
    without decay all below 1.7e-6), so 5e-4."""
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg = jget_smoke_config("smollm-135m", **kw)
    cfg = get_smoke_config("smollm-135m", **kw)
    dkw = dict(seq_len=16, global_batch=4, vocab=64, seed=2)
    tkw = dict(steps=5, log_every=1, ckpt_every=0, base_lr=3e-3, warmup=2)
    with japi.use_policy(JXLA), japi.use_attention_policy(JUNFUSED):
        jt = JTrainer(jcfg, JDataConfig(**dkw), JTrainConfig(**tkw),
                      jadamw.AdamWConfig(lr=3e-3, weight_decay=weight_decay))
        start = from_jax_params(_np(jt.params), cfg)
        want = jt.run()["history"]
    got = Trainer(cfg, DataConfig(**dkw), TrainConfig(device="cpu", **tkw),
                  tadamw.AdamWConfig(lr=3e-3, weight_decay=weight_decay),
                  params=start).run()["history"]
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(5))
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               atol=atol, rtol=0)
    assert got[-1][1] < got[0][1]


def test_resume_after_sigterm_equals_uninterrupted(tmp_path):
    cfg = get_smoke_config("qwen2-1.5b", n_layers=2, vocab=64)
    dc = DataConfig(seq_len=8, global_batch=2, vocab=cfg.vocab, seed=1)

    def tc(d):
        return TrainConfig(steps=6, log_every=100, ckpt_every=0,
                           ckpt_dir=str(tmp_path / d), base_lr=1e-3,
                           device="cpu")

    full = Trainer(cfg, dc, tc("full")).run()
    first = Trainer(cfg, dc, tc("resume"))
    step_fn, calls = first._step_fn, []

    def preempted(*args):
        calls.append(1)
        if len(calls) == 3:          # SIGTERM during the third step
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(*args)

    first._step_fn = preempted
    first.run()
    assert first.ckpt.latest_step() == 3
    resumed = Trainer(cfg, dc, tc("resume"))
    assert resumed.start_step == 3
    out = resumed.run()
    for a, b in zip(tree_leaves(full["params"]), tree_leaves(out["params"])):
        assert torch.equal(a, b)
    assert out["final_loss"] == full["final_loss"]


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_forward_only_wrappers_raise_under_grad():
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32, grad=True):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dtype).requires_grad_(grad)

    q, k, v = t(1, 2, 2, 16), t(1, 4, 1, 16), t(1, 4, 1, 16)
    with pytest.raises(RuntimeError, match="forward-only.*unfused"):
        FA.flash_attention(q, k, v)
    pools = t(3, 8, 1, 16), t(3, 8, 1, 16)
    bt = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        PA.paged_attention(q, *pools, bt)
    i8 = torch.zeros((3, 8, 1, 16), dtype=torch.int8)
    scales = (torch.ones((3, 1)), torch.ones((3, 1)))
    with pytest.raises(RuntimeError, match="forward-only"):
        PA.paged_attention(q, i8, i8, bt, kv_scales=scales)
    a8 = torch.zeros((1, 1, 16, 32), dtype=torch.int8)
    b8 = torch.zeros((1, 1, 32, 32), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="forward-only"):
        MF.matrixflow_gemm_dequant(a8, b8, t(16), None)
    with pytest.raises(RuntimeError, match="SSD training"):
        K6.ssd_scan(t(1, 8, 2, 4), t(1, 8, 2), -t(2, grad=False).abs(),
                    t(1, 8, 4), t(1, 8, 4))
    # the same calls without a gradient run their plain versions
    with torch.no_grad():
        assert FA.flash_attention(q, k, v).shape == (1, 2, 2, 16)
    # a packed weight under autograd
    w = pack_weight(t(16, 8, grad=False), GemmPolicy(backend="matrixflow"))
    with pytest.raises(ValueError, match="autograd"):
        api.matmul(t(4, 16), w, policy=GemmPolicy(backend="matrixflow"))


def test_fused_policy_refuses_training():
    _, cfg, _, params, batch, _, _ = _case("smollm-135m")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with api.use_attention_policy(FUSED), pytest.raises(RuntimeError,
                                                        match="forward-only"):
        ST.value_and_grad(lambda p: T.lm_loss(p, cfg, tb), params)


def test_ssd_training_refused_on_cuda():
    cfg = get_smoke_config("mamba2-1.3b", n_layers=2, vocab=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_trainable(cfg, torch.device("cuda"))
    check_trainable(cfg, torch.device("cpu"))
    check_trainable(get_smoke_config("smollm-135m"), torch.device("cuda"))


def test_train_cli_cpu_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--smoke", "--steps", "3", "--global-batch", "2",
         "--seq-len", "32", "--log-every", "1", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("[train] step") == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    # the production mesh is 16 x 16: it needs a world of 256 ranks
    with pytest.raises(ValueError, match="256 ranks"):
        from repro_torch.launch import train as LT
        LT.main(["--arch", "smollm-135m", "--smoke", "--production-mesh",
                 "--device", "cpu"])
