"""Sequence parallelism of the port (``act_seq -> model``, the reference's
``seqpar`` arm of ``benchmarks/hillclimb.py``) in the train step and the
dry run, against the JAX package.

  * The residual stream's cut — the rank's rows of the batch over pod x
    data (``steps.data_shard``) and of the sequence over model where
    ``tp.seq_parallel`` says so — equals the reference's own
    ``ShardingRules.spec(("act_batch", "act_seq", "act_embed"), ...)`` for
    every config of the registry under ``act_seq -> model``, on (2, 2),
    (16, 16) and (2, 16, 16) meshes, at the train, prefill and decode
    cells' shapes and a sequence that does not divide.
  * One spawn of four ranks over gloo, a (data 2, model 2) mesh: for the
    fp32 smoke configs (2 layers, vocab 64) of smollm-135m (attention
    whole on every rank), qwen3-8b (query heads cut, KV heads whole),
    granite-20b (MQA: the query heads cut, the one K/V head whole, whose
    gradient each rank's heads give in part), dbrx-132b (MoE),
    deepseek-v2-236b (MLA, shared experts, a dense layer) and zamba2-2.7b
    (SSD blocks and the shared attention), the
    step's loss, gradient norm and every gradient leaf, gathered whole,
    equal the JAX package's single-device ``jax.grad`` of ``lm_loss``
    within ``TOLS["float32"]``, on a batch the model pair runs alone (each
    data row fed the same rows; an MoE model's dispatch groups are then
    the doubled batch's, and so is its reference) and on four rows over
    data; and equal the port's baseline TP step there. A sequence of 15
    columns does not divide over model: the step falls back to the
    baseline, bit for bit. Remat "dots" under sequence parallelism gives
    "full"'s gradients.
  * The dry run at rank 0 of 16 x 16: under ``seqpar`` smollm-135m's and
    qwen3-8b's ``train_4k`` hold fewer temporaries than the baseline and
    launch K1 as often; their collectives over model equal the closed
    form (``seqpar_form.closed_form``); the baseline keeps its figures to the
    byte.
  * ``act_batch`` rules (``batch2d``, ``kvseq_batch2d``) raise by name at
    ``make_rules``/``serve_context``, ``make_train_step_fn`` and
    ``dryrun_cell``; ``act_seq -> model`` raises in a prefill and runs a
    decode step (one column) as the baseline does.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from parity import TOLS

import torch_mesh_ranks as R
from seqpar_form import closed_form
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.distributed import sharding as jshd
from repro.models import transformer as JT
from repro_torch.configs.registry import ARCHS, SHAPES, get_config
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed import tp as TP
from repro_torch.distributed.launch import spawn
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=3)
SEQPAR = R.SEQPAR
BATCH2D = {"act_batch": ("pod", "data", "model")}
KVSEQ_BATCH2D = {"act_kv_seq": "model", **BATCH2D}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

# The reference's dry-run figures of the baseline at rank 0 of 16 x 16
# (temporaries, collectives, K1 launches), which seqpar must not touch.
BASELINE = {("smollm-135m", "train_4k"): (42340741568, 7084232452, 963),
            ("qwen3-8b", "train_4k"): (33907895952, 168482163164, 1155),
            ("qwen3-8b", "decode_32k"): (40248213604, 14292992, 217)}


# ---------------------------------------------------------------------------
# The residual stream's cut against the reference's spec
# ---------------------------------------------------------------------------

def _port_cut(cfg, mesh, B, S):
    """The port's cut of a (B, S, d_model) residual stream: its rows over
    the batch axes that ``steps.data_shard`` cuts, and over the sequence
    where ``tp.seq_parallel`` cuts it."""
    batch = tuple(a for a in FSDP.BATCH_AXES if a in mesh.axis_names)
    if B % mesh.span(batch)[1]:
        batch = ()
    ctx = TP.make_context(mesh, overrides=ST.merged_overrides(cfg, SEQPAR))
    seq = ctx.model_axis if TP.seq_parallel(ctx, S, B, cfg.d_model) else None
    return (batch[0] if len(batch) == 1 else (batch or None), seq, None)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_residual_cut_matches_reference_spec(mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = Mesh.abstract(shape, axes)
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  devices=np.empty(shape, dtype=np.int8))
    cells = [(c.batch, c.seq) for c in SHAPES.values()] + [(4, 4095)]
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        rules = jshd.ShardingRules(jmesh, ST.merged_overrides(cfg, SEQPAR))
        for B, S in cells:
            want = tuple(rules.spec(("act_batch", "act_seq", "act_embed"),
                                    (B, S, cfg.d_model)))
            assert _port_cut(cfg, mesh, B, S) == want, (arch, B, S)
            n += want[1] == "model"
    assert n >= len(ARCHS) * 2


# ---------------------------------------------------------------------------
# Steps on a (data 2, model 2) mesh against jax.grad on one device
# ---------------------------------------------------------------------------

def _jax_grads(arch, jparams, batch):
    jcfg = jget_smoke_config(arch, n_layers=2, vocab=64, dtype="float32")
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, jcfg, jb)[0]))(jparams)
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    b4 = TokenPipeline(DataConfig(**DATA)).next_batch()
    batches = {"tp2": {k: np.concatenate([v, v]) for k, v in b4.items()},
               "dp2tp2": b4,
               "odd": TokenPipeline(DataConfig(
                   **dict(DATA, seq_len=15))).next_batch()}
    jparams = {a: JT.init_model(jax.random.PRNGKey(2), jget_smoke_config(
        a, n_layers=2, vocab=64, dtype="float32"))[0]
        for a in R.SEQPAR_ARCHS}
    params_np = {a: jax.tree_util.tree_map(np.asarray, p)
                 for a, p in jparams.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.seqpar_rank, 4, (params_np, batches),
                            workdir=str(tmp_path_factory.mktemp("seqpar")),
                            timeout_s=300, collective_timeout_s=60,
                            threads=1)
        want = {(a, "dp2tp2"): _jax_grads(a, jparams[a], b4)
                for a in R.SEQPAR_ARCHS}
        # the pair alone runs the doubled batch: the same loss for a dense
        # model, other dispatch groups (so another loss) for an MoE one
        for a in R.SEQPAR_ARCHS:
            want[a, "tp2"] = want[a, "dp2tp2"] if not R.seqpar_config(
                a).is_moe else _jax_grads(a, jparams[a], batches["tp2"])
        ranks = ranks.result()
    return {"want": want, "ranks": ranks}


def _close(got, want, msg):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=msg)


@pytest.mark.parametrize("arch", R.SEQPAR_ARCHS)
@pytest.mark.parametrize("case", ["tp2", "dp2tp2"])
def test_seqpar_step_matches_jax_single_device(run, arch, case):
    """Every rank's loss, gradient norm and gradient leaves (gathered
    whole) under act_seq -> model equal jax.grad on one device, and the
    baseline TP step's; the step ran sequence-parallel."""
    jloss, jg = run["want"][arch, case]
    cfg = R.seqpar_config(arch)
    want = [t.numpy() for t in tree_leaves(from_jax_params(jg, cfg))]
    jnorm = float(np.sqrt(sum(np.sum(w.astype(np.float64) ** 2)
                              for w in want)))
    for r, rank in enumerate(run["ranks"]):
        got, base = rank[arch, case, "seqpar"], rank[arch, case, "baseline"]
        assert got["seq_parallel"] and not base["seq_parallel"]
        for k in ("loss", "step_loss"):
            _close(got[k], jloss, f"{arch} {case} rank {r} {k}")
        _close(got["grad_norm"], jnorm, f"{arch} {case} rank {r} norm")
        _close(got["grad_norm"], base["grad_norm"], f"{arch} {case} norm")
        assert len(got["grads"]) == len(want)
        for i, (g, w, b) in enumerate(zip(got["grads"], want,
                                          base["grads"])):
            assert g.shape == w.shape
            _close(g, w, f"{arch} {case} rank {r} leaf {i}")
            _close(g, b, f"{arch} {case} rank {r} leaf {i} vs baseline")
        assert max(float(np.abs(g).max()) for g in got["grads"]) > 0
        by = got["collectives"]
        assert by["all_gather:model"]["calls"] > 0
        assert by["reduce_scatter:model"]["calls"] > 0


def test_seqpar_falls_back_where_the_sequence_does_not_divide(run):
    """15 columns over 2 model ranks: the step runs the baseline, bitwise."""
    for rank in run["ranks"]:
        got, base = rank["smollm-135m", "odd", "seqpar"], \
            rank["smollm-135m", "odd", "baseline"]
        assert not got["seq_parallel"]
        assert got["loss"] == base["loss"]
        assert got["grad_norm"] == base["grad_norm"]
        for g, b in zip(got["grads"], base["grads"]):
            np.testing.assert_array_equal(g, b)
        assert "all_gather:model" not in got["collectives"]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_seqpar_remat_dots_equals_full(run, arch):
    """The seqpar_dots arm: remat "dots" under sequence parallelism gives
    "full"'s loss and gradients, and so jax.grad's."""
    jloss, jg = run["want"][arch, "dp2tp2"]
    want = [t.numpy() for t in tree_leaves(
        from_jax_params(jg, R.seqpar_config(arch)))]
    for rank in run["ranks"]:
        dots, full = rank[arch, "dp2tp2", "seqpar_dots"], \
            rank[arch, "dp2tp2", "seqpar"]
        assert dots["seq_parallel"]
        _close(dots["loss"], jloss, f"{arch} dots loss")
        _close(dots["grad_norm"], full["grad_norm"], f"{arch} dots norm")
        for g, f, w in zip(dots["grads"], full["grads"], want):
            _close(g, f, f"{arch} dots vs full")
            _close(g, w, f"{arch} dots vs jax")


# ---------------------------------------------------------------------------
# The dry run under seqpar
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dry():
    out = {}
    for arch in ("smollm-135m", "qwen3-8b"):
        for arm, ov in (("baseline", None), ("seqpar", SEQPAR)):
            out[arch, arm] = DR.dryrun_cell(arch, "train_4k", verbose=False,
                                            rules_overrides=ov)
    out["qwen3-8b", "decode"] = DR.dryrun_cell("qwen3-8b", "decode_32k",
                                               verbose=False)
    return out


def _figures(res):
    return (res["memory"]["temp_size_in_bytes"],
            int(res["collectives"]["total"]),
            res["launches"]["matrixflow_gemm"]["wgmma"])


def test_dryrun_baseline_keeps_its_figures(dry):
    for (arch, shape), want in BASELINE.items():
        res = dry[arch, "baseline" if shape == "train_4k" else "decode"]
        assert _figures(res) == want, (arch, shape)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_dryrun_seqpar_train_cell(dry, arch):
    """Fewer temporaries than the baseline, K1 launched as often, the
    collectives over model the closed form; the placements that part from
    the reference's spec listed, the residual stream not among them."""
    base, sp = dry[arch, "baseline"], dry[arch, "seqpar"]
    assert sp["memory"]["temp_size_in_bytes"] < \
        base["memory"]["temp_size_in_bytes"]
    assert sp["launches"] == base["launches"]
    cfg = get_config(arch)
    cell = SHAPES["train_4k"]
    want = closed_form(cfg, cell.batch // 16, cell.seq, 16, 16,
                       cfg.param_dtype.itemsize)
    by = sp["collectives_by_axes"]
    for kind, (calls, nbytes) in want.items():
        assert by[f"{kind}:model"] == {"calls": calls, "bytes": nbytes}, kind
    parts = {p["part"] for p in sp["parts_from_reference"]}
    assert "sequence parallelism: k" in parts
    assert not any(p.startswith("sequence parallelism") for p in
                   {q["part"] for q in base["parts_from_reference"]})


# ---------------------------------------------------------------------------
# What is not ported raises by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", [BATCH2D, KVSEQ_BATCH2D],
                         ids=["batch2d", "kvseq_batch2d"])
def test_act_batch_rules_raise_by_name(arm):
    cfg = R.seqpar_config("qwen3-8b")
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="act_batch"):
        ST.make_rules(cfg, mesh, extra_overrides=arm)
    with pytest.raises(NotImplementedError, match="act_batch"):
        ST.serve_context(cfg, mesh, extra_overrides=arm)
    with pytest.raises(NotImplementedError, match="act_batch"):
        ST.make_train_step_fn(cfg, mesh=mesh, rules_overrides=arm)
    with pytest.raises(NotImplementedError, match="act_batch"):
        DR.dryrun_cell("qwen3-8b", "train_4k", verbose=False,
                       rules_overrides=arm)


def test_seqpar_serving_prefill_raises_and_decode_runs():
    cfg = R.tp_dryrun_config()
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="act_seq"):
        DR.run_step(cfg, "prefill", 4, 16, mesh=mesh, rules_overrides=SEQPAR)
    got = DR.run_step(cfg, "decode", 4, 16, mesh=mesh,
                      rules_overrides=SEQPAR)
    base = DR.run_step(cfg, "decode", 4, 16, mesh=mesh)
    for k in ("memory", "collectives_by_axes", "launches"):
        assert got[k] == base[k], k
