"""Rank bodies of the port's multi-device tests, and the scenarios they
share with the one-device runs they are held against.

The tests start their ranks with ``repro_torch.distributed.launch.spawn``
(the ``spawn`` start method, a gloo group through a FileStore under the
test's ``tmp_path``); each rank imports this module, which imports torch,
numpy and ``repro_torch`` only — never JAX or the JAX package — runs its
body on its own slice and hands back numpy results. The parent test
compares them with the one-device port (the same scenario functions with
no mesh) and with the live JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch_threads  # noqa: F401  (one intra-op thread a rank)

from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import AttentionPolicy, GemmPolicy
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed import tp as TP
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.serving.engine import ServeConfig, ServingEngine

PAGED = AttentionPolicy(backend="paged", page_size=8)
FUSED = AttentionPolicy(backend="fused")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


# ---------------------------------------------------------------------------
# TP serving: the reference runner's scenarios (tests/tp_serving_runner.py)
# plus the contiguous engine
# ---------------------------------------------------------------------------

def tp_config():
    """qwen3 smoke (GQA H=4, Hkv=2, q/k norm) in fp32 with the sharding
    overrides cleared, so heads and the KV pools split at TP=2 — the
    reference runner's ``build()``."""
    return get_smoke_config("qwen3-8b", n_layers=2, vocab=64,
                            sharding_overrides=(), dtype="float32")


def _engine(cfg, params, mesh, **kw):
    sc = dict(batch_slots=2, max_len=32, attention=PAGED,
              cache_dtype="float32", device="cpu")
    sc.update(kw)
    return ServingEngine(cfg, params, ServeConfig(**sc, mesh=mesh))


def _plain(step_out):
    return {int(h): int(t) for h, t in step_out.items()}


def _accounting(eng):
    return (eng.pool.free_pages, eng.pool.pages_in_use) if eng.paged else None


def _steps(eng, n, generator=None):
    """n steps: their outputs and the pool's (free, in use) after each."""
    outs, acct = [], []
    for _ in range(n):
        outs.append(_plain(eng.step(generator=generator)))
        acct.append(_accounting(eng))
    return outs, acct


def _drain(eng, max_steps=80):
    acct = []
    for _ in range(max_steps):
        eng.step()
        acct.append(_accounting(eng))
        if not eng.slot_live.any() and not eng.wait:
            break
    return acct


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def scenario_greedy(cfg, params, mesh):
    eng = _engine(cfg, params, mesh)
    prompts = np.random.default_rng(7).integers(0, 64, (2, 6))
    out = {"generate": eng.generate(prompts, 8)}
    eng = _engine(cfg, params, mesh)
    out["handles"] = [eng.submit([3, 1, 4, 1, 5]), eng.submit([9, 2, 6])]
    out["steps"], out["pages"] = _steps(eng, 6)
    out["kv_shards"] = eng.kv_shards()
    return out


def scenario_temperature(cfg, params, mesh):
    eng = _engine(cfg, params, mesh, temperature=0.8)
    prompts = np.random.default_rng(11).integers(0, 64, (2, 5))
    out = {"generate": eng.generate(prompts, 8, generator=_gen(42))}
    eng = _engine(cfg, params, mesh, temperature=0.8)
    out["handles"] = [eng.submit([5, 4, 3], generator=_gen(1))]
    out["steps"], out["pages"] = _steps(eng, 6, generator=_gen(100))
    return out


def _preempt_run(cfg, params, mesh, **kw):
    # 2 pages of 8 tokens = half of 2 slots x max_len 16: decode growth
    # exhausts the pool and preempts
    eng = _engine(cfg, params, mesh, max_len=16, cache_pages=2, **kw)
    handles = [eng.submit(p) for p in ([1, 2, 3], [4, 5, 6])]
    pages = _drain(eng)
    eng.pool.check()
    assert eng.n_preemptions > 0, "pool pressure never hit — dead scenario"
    return {"handles": handles, "pages": pages,
            "streams": {int(h): list(map(int, eng.request_out[h]))
                        for h in handles},
            "n_preemptions": eng.n_preemptions,
            "pool_free_at_end": eng.pool.free_pages == eng.pool.n_pages}


def scenario_preempt(cfg, params, mesh):
    return _preempt_run(cfg, params, mesh)


def scenario_prefix(cfg, params, mesh):
    eng = _engine(cfg, params, mesh, batch_slots=3, prefix_cache=True,
                  cache_pages=12)
    shared = list(range(1, 12))              # 11 tokens: 1 full page + tail
    prompts = [shared + [40, 41], shared + [50, 51],
               shared[:5] + [60, 61, 62, 63]]
    handles = [eng.submit(p) for p in prompts]
    out = {"handles": handles, "hits": eng.prefix.hits,
           "cow_forks": eng.prefix.cow_forks}
    out["steps"], out["pages"] = _steps(eng, 6)
    out["prefix_stats"] = eng.prefix.stats()
    eng.pool.check()
    eng.prefix.check()
    return out


def scenario_kv_int8(cfg, params, mesh):
    eng = _engine(cfg, params, mesh, kv_dtype="int8")
    prompts = np.random.default_rng(13).integers(0, 64, (2, 6))
    return {"generate": eng.generate(prompts, 8),
            "preempt": _preempt_run(cfg, params, mesh, kv_dtype="int8")}


def scenario_contiguous(cfg, params, mesh):
    eng = _engine(cfg, params, mesh, attention=FUSED)
    prompts = np.random.default_rng(17).integers(0, 64, (2, 6))
    out = {"generate": eng.generate(prompts, 8)}
    eng = _engine(cfg, params, mesh, attention=FUSED)
    out["handles"] = [eng.submit([3, 1, 4, 1, 5]), eng.submit([9, 2, 6])]
    out["steps"], _ = _steps(eng, 6)
    return out


SCENARIOS = {"greedy": scenario_greedy, "temperature": scenario_temperature,
             "preempt": scenario_preempt, "prefix": scenario_prefix,
             "kv-int8": scenario_kv_int8, "contiguous": scenario_contiguous}


def serve_scenarios(cfg, params, mesh):
    return {name: fn(cfg, params, mesh) for name, fn in SCENARIOS.items()}


# every family the engine serves, with its own sharding overrides and with
# them cleared: MQA (granite), QKV biases (qwen2), MoE (dbrx: the banks
# whole, the shared path sharded), MLA (deepseek: contiguous), the hybrid
# (zamba2: SSD blocks whole, the shared attention block sharded), the VLM
FAMILY_ARCHS = ("smollm-135m", "qwen2-1.5b", "granite-20b", "dbrx-132b",
                "deepseek-v2-236b", "zamba2-2.7b", "internvl2-76b")


def family_config(arch, cleared):
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    if cleared:
        kw["sharding_overrides"] = ()
    cfg = get_smoke_config(arch, **kw)
    if cfg.attn_every:            # one attention group
        cfg = get_smoke_config(arch, **dict(kw, n_layers=cfg.attn_every))
    return cfg


def serve_families(mesh):
    """(arch, cleared) → (greedy generate of seeded prompts, kv_shards)."""
    from repro_torch.models import transformer as T
    out = {}
    for arch in FAMILY_ARCHS:
        for cleared in (False, True):
            cfg = family_config(arch, cleared)
            paged = cfg.family not in T.SSD_FAMILIES and not cfg.is_mla
            B = 1 if cfg.attn_every else 2       # SSD: one slot submits
            eng = _engine(cfg, T.init_model(cfg, seed=0, device="cpu"),
                          mesh, batch_slots=B,
                          attention=PAGED if paged else FUSED)
            prompts = np.random.default_rng(1).integers(0, 64, (B, 6))
            out[arch, cleared] = (eng.generate(prompts, 5).tolist(),
                                  eng.kv_shards())
    return out


# ---------------------------------------------------------------------------
# The sharded GEMM / attention grid (tests/parity.py run_sharded_grid)
# ---------------------------------------------------------------------------

def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TORCH_DTYPES[dtype])


def _np(t):
    return t.float().numpy() if t.dtype.is_floating_point else t.numpy()


def _held(t, names, ctx):
    """The weight ``t`` as this rank holds it (``tp.shard_params``): its
    slice along the dim that ``tp.param_cut`` shards, else whole."""
    cut = TP.param_cut(ctx, names, tuple(t.shape))
    return t if cut is None else TP.shard_dim(t, cut[0], ctx.rank,
                                              ctx.model_size)


def sharded_gemm(cells, ctx):
    """Each cell: (dtype, a, b, bias or None) → the rank's column-parallel
    output (its N slice), row-parallel output (whole), and column+bias;
    the weight and bias cut to the rank's slices first."""
    out = []
    col, row = ("embed", "mlp"), ("mlp", "embed")
    with TP.use_tp(ctx):
        for dtype, a, b, bias in cells:
            at, bt = _t(a, dtype), _t(b, dtype)
            full = tuple(bt.shape)
            r = {"col": _np(TP.matmul(at, _held(bt, col, ctx), axes=col,
                                      full=full)),
                 "row": _np(TP.matmul(at, _held(bt, row, ctx), axes=row,
                                      full=full))}
            if bias is not None:
                bb = _t(bias, dtype)
                if TP.param_cut(ctx, col, full) is not None:
                    bb = TP.shard_dim(bb, 0, ctx.rank, ctx.model_size)
                r["colb"] = _np(TP.linear(at, _held(bt, col, ctx), bb,
                                          axes=col, full=full))
            out.append(r)
    return out


def sharded_attention(cells, ctx):
    """Each cell: (dtype, backend, q, k, v, q_positions, kv_valid_len,
    block_tables or None, causal) → the rank's output heads; q and the
    K/V (dense or pools) cut to the rank's heads where
    ``tp.head_sharding`` shards them."""
    out = []
    with TP.use_tp(ctx):
        for dtype, backend, q, k, v, qp, kl, bt, causal in cells:
            pol = AttentionPolicy(backend=backend, page_size=16)
            H, Hkv = q.shape[2], k.shape[2]
            shard_q, shard_kv = TP.head_sharding(ctx, H, Hkv)

            def cut(a, shard):
                a = _t(a, dtype)
                return (TP.shard_dim(a, 2, ctx.rank, ctx.model_size)
                        if shard else a)
            o = TP.attention(
                cut(q, shard_q), cut(k, shard_kv), cut(v, shard_kv),
                q_positions=torch.from_numpy(qp),
                kv_valid_len=torch.from_numpy(kl), heads=(H, Hkv),
                causal=causal,
                block_tables=None if bt is None else torch.from_numpy(bt),
                policy=pol)
            out.append(_np(o))
    return out


def rank_cache_shapes(cfg, ctx):
    """The rank's int8 paged and contiguous caches, as shard_caches cuts
    whole ones and as init_*caches(tpctx=) makes them: leaf shapes."""
    from repro_torch.models import transformer as T

    def shapes(caches):
        return [{k: tuple(v.shape) for k, v in c.items()} for c in caches]
    _, shard_kv = TP.head_sharding(ctx, cfg.n_heads, cfg.n_kv_heads)
    paged = (2, 6, 8, torch.float32, "cpu")
    contiguous = (2, 16, torch.float32, "cpu")
    return {"paged": (shapes(TP.shard_caches(T.init_paged_caches(
                cfg, *paged, kv_dtype="int8"), ctx, shard_kv=shard_kv)),
                      shapes(T.init_paged_caches(cfg, *paged, kv_dtype="int8",
                                                 tpctx=ctx))),
            "contiguous": (shapes(TP.shard_caches(T.init_caches(
                cfg, *contiguous), ctx, shard_kv=shard_kv)),
                           shapes(T.init_caches(cfg, *contiguous,
                                                tpctx=ctx)))}


def tp_serving_rank(rank, world, params_np, gemm_cells, attn_cells):
    """One rank of the TP=2 group: the six serving scenarios on a (1, 2)
    mesh, then the sharded GEMM and attention grids; every collective the
    scenarios issued, by kind and bytes."""
    torch.manual_seed(0)
    cfg = tp_config()
    params = from_jax_params(params_np, cfg)
    mesh = make_host_mesh(model=world)
    TP.collectives.reset()
    out = {"serve": serve_scenarios(cfg, params, mesh),
           "collectives": TP.collectives.snapshot(),
           "mesh": (dict(mesh.shape), dict(mesh.coords)),
           "families": serve_families(mesh)}
    ctx = TP.make_context(mesh)
    out["caches"] = rank_cache_shapes(cfg, ctx)
    with api.use_policy(GemmPolicy()):
        out["gemm"] = sharded_gemm(gemm_cells, ctx)
        out["attention"] = sharded_attention(attn_cells, ctx)
    # a (2, 1) mesh of the same ranks: the model axis is 1, a no-op
    ctx1 = TP.make_context(Mesh((world, 1), ("data", "model")))
    out["gemm_model1"] = sharded_gemm(gemm_cells[:1], ctx1)
    return out


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------

# The step-0 lr of the schedule's fixed warmup of 100 is lr / 100: at 5e-2
# AdamW's first step moves a weight by about 5e-4, five times the params'
# fp32 tolerance (1e-4), so a step that applied no update, or a wrong one,
# fails the comparison (AdamWConfig's default 3e-4 would move it 3e-6).
DP_LR = 5e-2


def data_cuts(cfg, n):
    """Each leaf's cut over ``n`` data ranks (``fsdp.Cut``, or None where
    it stays whole), in ``tree_leaves`` order."""
    from repro_torch.models import transformer as T
    ctx = FSDP.make_context(cfg, Mesh.abstract((n, 1), ("data", "model")))
    return [c for _, c in FSDP.leaves_with_cuts(
        T.init_model(cfg, device="meta"), ctx)]


def fsdp_closed_form(cfg, mesh_shape, rank=0):
    """The all-gathers and reduce-scatters of one FSDP train step of
    ``cfg`` (no pipeline, no hybrid) at ``rank`` of a (data, model) mesh:
    every cut leaf gathered where it is used — a layer's again in remat's
    recompute — and its gradient reduce-scattered once; calls and bytes,
    as ``tp.collectives`` counts them (the gathered leaf, the rank's
    cut)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    mesh = Mesh.abstract(mesh_shape, ("data", "model"), rank)
    held = ST.rank_params(cfg, T.init_model(cfg, device="meta"), mesh)
    ctx = FSDP.make_context(cfg, mesh)
    keys = [k for k in sorted(held) for _ in tree_leaves(held[k])]
    out = {"calls": {"all_gather": 0, "reduce_scatter": 0},
           "bytes": {"all_gather": 0, "reduce_scatter": 0}}
    for key, (t, cut) in zip(keys, FSDP.leaves_with_cuts(held, ctx)):
        if cut is None:
            continue
        block = key == "layers" or key.startswith("dense_layer")
        gathers = 2 if block and cfg.remat else 1
        nbytes = t.numel() * t.element_size()
        out["calls"]["all_gather"] += gathers
        out["bytes"]["all_gather"] += gathers * nbytes * ctx.size
        out["calls"]["reduce_scatter"] += 1
        out["bytes"]["reduce_scatter"] += nbytes
    return out


def dp_config():
    return get_smoke_config("smollm-135m", n_layers=2, vocab=64,
                            dtype="float32")


def _leaves_np(tree):
    from repro_torch.optim.adamw import tree_leaves
    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def dp_step(cfg, params, batch, mesh, *, compress=False, keep_state=False):
    """One make_train_step_fn step (lr :data:`DP_LR`; int8 gradients with
    ``compress``) on ``batch`` (the global batch) under K1's autograd
    Function and unfused attention, from the whole ``params`` cut to this
    rank's share on ``mesh`` (``rank_params``: FSDP over data, slices and
    experts over model) or on one device: loss, grad_norm, the step's
    collectives (also by the axes each went over), the bytes of the
    params and moments the rank held, and the params after the update
    gathered whole (``steps.full_params``); with ``keep_state`` the
    rank's ``{"params", "opt"}`` after the step too."""
    from repro_torch.core.plan import UNFUSED
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig, adamw_init
    step = ST.make_train_step_fn(
        cfg, AdamWConfig(lr=DP_LR, compress_grads=compress), total_steps=10,
        mesh=mesh)
    held = ST.rank_params(cfg, params, mesh)
    opt = adamw_init(held)
    TP.collectives.reset()
    with api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        p, opt, m = step(held, opt,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    coll, by_axes = TP.collectives.snapshot(), TP.collectives.by_axes(mesh)
    nbytes = sum(t.numel() * t.element_size() for t in
                 _leaves(p) + _leaves(opt["mu"]) + _leaves(opt["nu"]))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "aux": float(m["aux"]), "collectives": coll, "by_axes": by_axes,
           "held_bytes": nbytes,
           "params": _leaves_np(ST.full_params(cfg, p, mesh))}
    if keep_state:
        out["state"] = {"params": p, "opt": opt}
    return out


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def dp_trainer(cfg, params, data_kw, mesh):
    """Three Trainer steps from ``params``: the logged losses."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainConfig
    tr = Trainer(cfg, DataConfig(**data_kw),
                 TrainConfig(steps=3, log_every=1, ckpt_every=0,
                             base_lr=3e-3, warmup=2, device="cpu"),
                 AdamWConfig(lr=3e-3), params=params, mesh=mesh)
    return tr.run()["history"]


def dp_rank(rank, world, params_np, batch, data_kw):
    cfg = dp_config()
    mesh = make_host_mesh()
    return {"step": dp_step(cfg, from_jax_params(params_np, cfg), batch,
                            mesh),
            "trainer": dp_trainer(cfg, from_jax_params(params_np, cfg),
                                  data_kw, mesh)}


# ---------------------------------------------------------------------------
# GPipe pipeline (tests/test_pipeline.py's script)
# ---------------------------------------------------------------------------

def pipeline_stage_fn(wslice, h):
    for w in wslice:
        h = torch.tanh(api.matmul(h, w))
    return h


def pipeline_rank(rank, world, ws, x):
    """Stage ``rank`` of a 4-stage pipeline over ``ws`` (L, d, d): the
    forward outputs and the gradient of sum(out²) w.r.t. this stage's
    layers."""
    from repro_torch.distributed.pipeline import pipeline_apply, \
        stack_for_stages
    mesh = Mesh((world,), ("stage",))
    staged = stack_for_stages(torch.from_numpy(ws), world)
    mine = staged[mesh.coords["stage"]].clone().requires_grad_(True)
    TP.collectives.reset()
    out = pipeline_apply(pipeline_stage_fn, mine, torch.from_numpy(x),
                         mesh=mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "grad": mine.grad.numpy(),
            "collectives": TP.collectives.snapshot()}


# ---------------------------------------------------------------------------
# Tensor-parallel training: TP=2 and DP=2 x TP=2 on one (data 2, model 2)
# mesh of four ranks
# ---------------------------------------------------------------------------

def _norm_leaves(tree, path=()):
    """(path, leaf) of every norm parameter: replicated over the model
    axis, so every model rank must get the same gradient of it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _norm_leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _norm_leaves(v, path + (i,))]
    return [(path, tree)] if any("norm" in str(k) for k in path) else []


def tp_train_rank(rank, world, params_np, batches):
    """One make_train_step_fn step (lr :data:`DP_LR`) from the whole
    ``params_np`` cut to this rank's share (FSDP over data, slices over
    model), per named global batch, on the (data 2, model 2) mesh; and
    the gradients of the norm leaves' cuts on the last batch (this rank's
    data rows, reduce-scattered over data). A batch whose two halves are
    equal gives both data rows the same rows, so their averaged gradient
    is exactly each TP=2 pair's own: that batch runs TP=2 alone."""
    from repro_torch.core.plan import UNFUSED
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    cfg = tp_config()
    mesh = make_host_mesh(model=2)
    whole = from_jax_params(params_np, cfg)
    out = {"coords": dict(mesh.coords)}
    for name, batch in batches.items():
        out[name] = dp_step(cfg, whole, batch, mesh)
    params = ST.rank_params(cfg, whole, mesh)
    rows = ST.data_shard({k: torch.from_numpy(v) for k, v in batch.items()},
                         mesh)
    with TP.use_tp(ST.tp_context(cfg, mesh)), \
            FSDP.use_fsdp(FSDP.make_context(cfg, mesh)), \
            api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        _, grads = ST.value_and_grad(lambda p: T.lm_loss(p, cfg, rows),
                                     params)
    out["norm_grads"] = {"/".join(map(str, k)): g.numpy()
                         for k, g in _norm_leaves(grads)}
    return out


# ---------------------------------------------------------------------------
# The dry run's collectives against a real TP=2 decode step
# ---------------------------------------------------------------------------

def tp_dryrun_config():
    """:func:`tp_config` at head_dim 64, a head dim the card's attention
    kernels take (the dry run checks the card's geometry on ``meta``)."""
    return get_smoke_config("qwen3-8b", n_layers=2, vocab=64,
                            sharding_overrides=(), dtype="float32",
                            d_head=64)


def tp_decode_rank(rank, world, rows, max_len):
    """One decode step at TP=2 on the CPU from this rank's slices and
    contiguous caches of its KV heads: the collectives it issued."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import make_decode_step
    cfg = tp_dryrun_config()
    mesh = make_host_mesh(model=2)
    ctx = ST.tp_context(cfg, mesh)
    params = ST.rank_params(cfg, T.init_model(cfg, seed=0, device="cpu"),
                            mesh)
    caches = T.init_caches(cfg, rows, max_len, cfg.param_dtype, "cpu",
                           tpctx=ctx)
    tok = torch.zeros((rows, 1), dtype=torch.int32)
    TP.collectives.reset()
    with torch.no_grad():
        make_decode_step(cfg, tpctx=ctx)(params, tok, tok, caches)
    return TP.collectives.snapshot()


# ---------------------------------------------------------------------------
# MoE under data parallelism: the dispatch groups and the aux loss of the
# global batch
# ---------------------------------------------------------------------------

MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")


def moe_config(arch, **kw):
    return get_smoke_config(arch, n_layers=2, vocab=64, dtype="float32",
                            **kw)


def moe_dp_rank(rank, world, params_by_arch, batch):
    """A DP=2 step of each MoE smoke config from its whole JAX-init params
    (:func:`dp_step`): loss, aux, grad norm and the params gathered
    whole."""
    mesh = make_host_mesh()
    return {arch: dp_step(moe_config(arch),
                          from_jax_params(p, moe_config(arch)), batch, mesh)
            for arch, p in params_by_arch.items()}


# ---------------------------------------------------------------------------
# The vocab-parallel loss at TP=2
# ---------------------------------------------------------------------------

def gathered_lm_loss(params, cfg, batch):
    """``transformer.lm_loss``' cross-entropy with the logits gathered
    whole over the model group before an fp32 ``log_softmax`` (the loss
    before the vocab-parallel one)."""
    from repro_torch.models import transformer as T
    logits, _, aux = T.forward(params, cfg, batch)
    lg = logits[:, :-1].float()
    nll = -torch.gather(torch.log_softmax(lg, dim=-1), -1,
                        batch["tokens"][:, 1:].long()[..., None])
    return torch.mean(nll) + 0.01 * aux


def _loss_and_grads(fn, params, cfg, rows, mesh):
    from repro_torch.core.plan import UNFUSED
    from repro_torch.launch import steps as ST
    TP.collectives.reset()
    with TP.use_tp(ST.tp_context(cfg, mesh)), \
            api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        (loss, _), grads = ST.value_and_grad(
            lambda p: (fn(p), {}), params)
    return {"loss": float(loss), "grads": _leaves_np(grads),
            "collectives": TP.collectives.snapshot()}


def vocab_loss_rank(rank, world, params_np, batch, audio_np, audio_batch):
    """At TP=2 (a (1, 2) mesh) on the rank's slices of the fp32 qwen3
    smoke config (overrides cleared): the loss and its gradients, vocab-
    parallel (``lm_loss``) and gathered (:func:`gathered_lm_loss`); a
    train step of qwen3 under its own overrides (KV heads replicated: the
    cache-less attention on the rank's query heads over their group's KV
    heads, ``tp.kv_group_slice``); and musicgen's loss, whose head is not
    vocab slices of each codebook (the loss gathers)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    mesh = make_host_mesh(model=world)
    cfg = tp_config()
    rows = {k: torch.from_numpy(v) for k, v in batch.items()}
    held = ST.rank_params(cfg, from_jax_params(params_np, cfg), mesh)
    out = {"vocab_parallel": _loss_and_grads(
               lambda p: T.lm_loss(p, cfg, rows)[0], held, cfg, rows, mesh),
           "gathered": _loss_and_grads(
               lambda p: gathered_lm_loss(p, cfg, rows), held, cfg, rows,
               mesh)}
    with TP.use_tp(ST.tp_context(cfg, mesh)):
        out["is_vocab_parallel"] = T.vocab_parallel(cfg)
    own = get_smoke_config("qwen3-8b", n_layers=2, vocab=64, dtype="float32")
    out["own_overrides"] = dp_step(own, from_jax_params(params_np, own),
                                   batch, mesh)
    ctx = ST.tp_context(own, mesh)
    out["kv_slice"] = TP.kv_group_slice(ctx, own.n_heads, own.n_kv_heads)
    audio = get_smoke_config("musicgen-medium", n_layers=2, vocab=64,
                             dtype="float32")
    arows = {k: torch.from_numpy(v) for k, v in audio_batch.items()}
    with TP.use_tp(ST.tp_context(audio, mesh)):
        out["audio_vocab_parallel"] = T.vocab_parallel(audio)
    out["audio"] = _loss_and_grads(
        lambda p: T.lm_loss(p, audio, arows)[0],
        ST.rank_params(audio, from_jax_params(audio_np, audio), mesh), audio,
        arows, mesh)["loss"]
    return out


# ---------------------------------------------------------------------------
# FSDP on the 2 x 2 mesh: the step, checkpoints of sharded state
# ---------------------------------------------------------------------------

def _state_np(state):
    """A ``{"params", "opt"}`` state as numpy leaves (bf16 as fp32 values:
    the tests' states are fp32), in ``tree_leaves`` order."""
    from repro_torch.optim.adamw import tree_leaves
    return [t.detach().numpy() for t in tree_leaves(state)]


def fsdp_rank(rank, world, params_np, batch, ckpts, cli):
    """On the (data 2, model 2) mesh, the fp32 smollm smoke config: one
    step from the whole JAX-init params cut to this rank's share
    (:func:`dp_step`, which gathers the params after it); the state after
    the step gathered whole and written by rank 0 as step 1 to
    ``ckpts["mesh"]``; and each checkpoint of ``ckpts["restore"]`` (one
    written on one device by the port, one by the JAX package) restored
    to the rank's cut (``steps.rank_state``), its shapes and the whole
    state gathered back from it; then ``launch/train.py --dp 2 --tp 2
    --ckpt-dir``, 2 steps and a resumed third into ``cli["resumed"]``, 3
    steps into ``cli["straight"]``."""
    from repro_torch.core.plan import UNFUSED
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = dp_config()
    mesh = make_host_mesh(model=2)
    whole = from_jax_params(params_np, cfg)
    out = {"coords": dict(mesh.coords), "step": dp_step(cfg, whole, batch,
                                                       mesh)}
    step = ST.make_train_step_fn(cfg, AdamWConfig(lr=DP_LR), total_steps=10,
                                 mesh=mesh)
    held = ST.rank_params(cfg, whole, mesh)
    with api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        p, opt, _ = step(held, adamw_init(held),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    state = ST.full_state(cfg, {"params": p, "opt": opt}, mesh)
    if mesh.rank == 0:
        CheckpointManager(ckpts["mesh"], async_save=False).save(1, state)
    out["saved"] = _state_np(state)
    template = {"params": p, "opt": opt}
    for name, d in ckpts["restore"].items():
        mine = ST.rank_state(cfg, CheckpointManager(d).restore(template),
                             mesh)
        out[name] = {"shapes": [tuple(t.shape) for t in _leaves(mine)],
                     "whole": _state_np(ST.full_state(cfg, mine, mesh))}
    out["held_shapes"] = [tuple(t.shape) for t in _leaves(template)]
    import torch.distributed as dist
    from repro_torch.launch import train as TR
    argv = ["--arch", "smollm-135m", "--smoke", "--global-batch", "4",
            "--seq-len", "16", "--device", "cpu", "--dp", "2", "--tp", "2",
            "--ckpt-every", "1", "--log-every", "1"]
    for steps, d in ((2, cli["resumed"]), (3, cli["resumed"]),
                     (3, cli["straight"])):
        TR.main(argv + ["--steps", str(steps), "--ckpt-dir", d])
        dist.barrier()           # rank 0's last write is on disk
    out["cli"] = {"steps": {k: CheckpointManager(d).all_steps()
                            for k, d in cli.items()}}
    return out


# ---------------------------------------------------------------------------
# Expert parallelism over model: the (1, 2) and (2, 2) meshes
# ---------------------------------------------------------------------------

# case → the MoE smoke config's overrides: both archs, and dbrx with the
# "local" combine
EP_CASES = {"dbrx-132b": {}, "deepseek-v2-236b": {},
            "dbrx-132b/local": {"moe_combine": "local"}}


def ep_config(case):
    return moe_config(case.split("/")[0], **EP_CASES[case])


def _bank_bytes(params):
    return sum(t.numel() * t.element_size()
               for lp in params["layers"] if "moe" in lp
               for k, t in lp["moe"].items() if k in ("wi", "wo"))


def ep_rank(rank, world, params_by_case, batch, ckpt):
    """On the (data, model) mesh of ``world`` / 2 x 2 ranks: a step of
    each case of :data:`EP_CASES` from its whole JAX-init params
    (:func:`dp_step`); the rank's layer-0 banks of dbrx and their bytes
    against the whole banks'. On (2, 2) rank 0 writes dbrx's state after
    the step, gathered whole, to ``ckpt``; on (1, 2) each rank restores
    it to its cut (``steps.rank_state``: shapes, and the state gathered
    back), and a TP=2 serving engine of dbrx holds the banks whole."""
    from repro_torch.launch import steps as ST
    from repro_torch.train.checkpoint import CheckpointManager
    mesh = make_host_mesh(model=2)
    out = {"coords": dict(mesh.coords)}
    for case, p in params_by_case.items():
        cfg = ep_config(case)
        out[case] = dp_step(cfg, from_jax_params(p, cfg), batch, mesh,
                            keep_state=case == "dbrx-132b")
    cfg = ep_config("dbrx-132b")
    whole = from_jax_params(params_by_case["dbrx-132b"], cfg)
    held = ST.rank_params(cfg, whole, mesh)
    out["banks"] = {k: held["layers"][0]["moe"][k].numpy()
                    for k in ("wi", "wo")}
    out["bank_bytes"] = (_bank_bytes(held), _bank_bytes(whole))
    state = out["dbrx-132b"].pop("state")
    if mesh.axis_size("data") == 2:
        full = ST.full_state(cfg, state, mesh)
        if mesh.rank == 0:
            CheckpointManager(ckpt, async_save=False).save(1, full)
        out["saved"] = _state_np(full)
    else:
        mine = ST.rank_state(cfg, CheckpointManager(ckpt).restore(state),
                             mesh)
        out["restored"] = {
            "shapes": [tuple(t.shape) for t in _leaves(mine)],
            "whole": _state_np(ST.full_state(cfg, mine, mesh))}
        eng = _engine(cfg, whole, mesh, attention=FUSED)
        out["serving_banks"] = [tuple(eng.params["layers"][0]["moe"][k].shape)
                                for k in ("wi", "wo")]
    return out


# ---------------------------------------------------------------------------
# The pod axis and int8 gradient compression on meshes that cut the params
# ---------------------------------------------------------------------------

POD_MESHES = {"pod": (2, 1), "pod_ep": (2, 2), "data_ep": (1, 2)}
POD_ARCHS = ("smollm-135m", "dbrx-132b")


def pod_config(arch):
    return dp_config() if arch == "smollm-135m" else moe_config(arch)


def compressed_cuts(cfg, grads_whole, mesh):
    """int8 compression of a gradient tree as a rank of ``mesh`` runs it:
    the rank's cut of ``grads_whole`` (``steps.rank_params``), each leaf
    quantized with the whole tensor's amax (``steps._grad_amax``: max-
    reduces over the axes that cut it, and over the layers, which the
    reference stacks) through ``adamw.quantize_int8``, gathered whole
    again."""
    from repro_torch.launch import steps as ST
    from repro_torch.optim.adamw import quantize_int8, tree_map
    cut = ST.rank_params(cfg, grads_whole, mesh)
    amax = ST._grad_amax(cut, ST.tp_context(cfg, mesh),
                         FSDP.make_context(cfg, mesh))
    deq = tree_map(lambda g, a: quantize_int8(g, None, a)[0], cut, amax)
    return _leaves_np(ST.full_params(cfg, deq, mesh))


def pod_rank(rank, world, params_np, batch, grads_np, cli_dir):
    """On four ranks: each arch's step on (pod 2, data 2, model 1); its
    step with ``compress_grads`` on (pod 2, data 1, model 2) and on (pod
    1, data 2, model 2); :func:`compressed_cuts` of each arch's
    ``grads_np`` on both compressing meshes; and ``launch/train.py --pod 2
    --dp 2 --compress-grads``, two steps."""
    from repro_torch.launch import train as TR
    out = {}
    for arch in POD_ARCHS:
        cfg = pod_config(arch)
        whole = from_jax_params(params_np[arch], cfg)
        mesh = make_host_mesh(pod=2, model=1)
        out[arch, "pod"] = dp_step(cfg, whole, batch, mesh)
        for name in ("pod_ep", "data_ep"):
            pod, model = POD_MESHES[name]
            mesh = make_host_mesh(pod=pod, model=model)
            out[arch, name] = dp_step(cfg, whole, batch, mesh,
                                      compress=True)
            out[arch, name, "quantized"] = compressed_cuts(
                cfg, from_jax_params(grads_np[arch], cfg), mesh)
    out["cli"] = TR.main(["--arch", "smollm-135m", "--smoke",
                          "--global-batch", "4", "--seq-len", "16",
                          "--device", "cpu", "--pod", "2", "--dp", "2",
                          "--compress-grads", "--steps", "2",
                          "--ckpt-dir", cli_dir, "--ckpt-every", "0"])
    return out


def pod_all_reduce_bytes(cfg, mesh):
    """The train step's one all-reduce over ``pod`` at ``mesh``'s rank: the
    fp32 gradients of every leaf the data axis cuts, the rank's cuts."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    held = ST.rank_params(cfg, T.init_model(cfg, device="meta"), mesh)
    return 4 * sum(t.numel() for t, cut in FSDP.leaves_with_cuts(
        held, FSDP.make_context(cfg, mesh)) if cut is not None)


# ---------------------------------------------------------------------------
# KV caches cut over the sequence (act_kv_seq over data, the long_500k
# rules): zamba2's shared-attention caches at smoke width
# ---------------------------------------------------------------------------

KVSEQ_MAX_LEN = 64            # two ranks: columns [0, 32) and [32, 64)
# each row's written length: row 0 writes in rank 1's half and both ranks
# see keys (long_500k's len 524,280); row 1 writes in rank 0's and rank 1
# sees nothing (len 100,000); row 2 crosses from rank 0's half to rank 1's
KVSEQ_LENS = (56, 12, 30)
KVSEQ_STEPS = 4


def kvseq_config():
    return get_smoke_config("zamba2-2.7b", vocab=64, dtype="float32")


def kvseq_state(cfg, seed=5):
    """Numpy caches of a zamba2 decode at :data:`KVSEQ_LENS`: every SSD
    layer's conv and SSD state, every shared-attention group's K/V (B, T,
    Hkv, D) and length, drawn from ``seed``; and the first tokens."""
    rng = np.random.default_rng(seed)
    B, K = len(KVSEQ_LENS), cfg.ssm_conv

    def draw(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    ssd = [{"conv": {"x": draw(B, K - 1, cfg.d_inner),
                     "B": draw(B, K - 1, cfg.ssm_state),
                     "C": draw(B, K - 1, cfg.ssm_state)},
            "state": draw(B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                          scale=0.1)}
           for _ in range(cfg.n_layers)]
    shape = (B, KVSEQ_MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
    attn = [{"k": draw(*shape), "v": draw(*shape),
             "len": np.asarray(KVSEQ_LENS, np.int32)}
            for _ in range(cfg.n_layers // cfg.attn_every)]
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    return ssd, attn, tokens


def kvseq_port_caches(ssd, attn):
    """The port's whole caches from :func:`kvseq_state`: a sink column
    after each K/V."""
    def sink(a):
        return torch.from_numpy(np.concatenate(
            [a, np.zeros_like(a[:, :1])], axis=1))
    return ([{"conv": {k: torch.from_numpy(v) for k, v in c["conv"].items()},
              "state": torch.from_numpy(c["state"])} for c in ssd]
            + [{"k": sink(c["k"]), "v": sink(c["v"]),
                "len": torch.from_numpy(c["len"].copy())} for c in attn])


def kvseq_decode(cfg, params, caches, tokens, ctx, attn_policy):
    """KVSEQ_STEPS greedy decode steps through the serving decode step
    from the caches at their lengths: (logits per step, tokens)."""
    from repro_torch.serving.engine import make_decode_step
    step = make_decode_step(cfg, attn=attn_policy, tpctx=ctx)
    tok = torch.from_numpy(tokens)
    pos = torch.as_tensor(KVSEQ_LENS, dtype=torch.int32)[:, None]
    logits, toks = [], []
    with torch.no_grad():
        for _ in range(KVSEQ_STEPS):
            lg, caches = step(params, tok, pos, caches)
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            logits.append(lg.float().numpy())
            toks.append(tok[:, 0].numpy())
            pos = pos + 1
    return np.stack(logits), np.stack(toks), caches


def kvseq_rank(rank, world, params_np, policies):
    """This rank's decode over its half of every K/V cache (mesh (data 2,
    model 1) under the long_500k rules): logits and tokens per policy,
    the collectives of one step, the K/V bytes it holds and its caches'
    lengths after the steps."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.launch import steps as ST
    cfg = kvseq_config()
    mesh = make_host_mesh()
    ctx = ST.serve_context(cfg, mesh, SHAPES["long_500k"])
    params = from_jax_params(params_np, cfg)
    ssd, attn, tokens = kvseq_state(cfg)
    out = {}
    for name in policies:
        policy = AttentionPolicy(backend=name)
        caches = TP.shard_caches(kvseq_port_caches(ssd, attn), ctx,
                                 shard_kv=False)
        made = _init_caches(cfg, len(KVSEQ_LENS), KVSEQ_MAX_LEN, ctx)
        TP.collectives.reset()
        lg, toks, caches = kvseq_decode(cfg, params, caches, tokens, ctx,
                                        policy)
        kv = [c for c in caches if "k" in c]
        out[name] = dict(
            logits=lg, tokens=toks,
            collectives=TP.collectives.by_axes(mesh),
            kv_bytes=sum(c[n].numel() * c[n].element_size()
                         for c in kv for n in ("k", "v")),
            offsets=[int(c["seq_offset"]) for c in kv],
            lens=[c["len"].numpy() for c in kv],
            init_shapes=[tuple(c["k"].shape) for c in made if "k" in c],
            init_offsets=[int(c["seq_offset"]) for c in made if "k" in c])
    return out


def _init_caches(cfg, batch, max_len, ctx):
    from repro_torch.models import transformer as T
    return T.init_caches(cfg, batch, max_len, cfg.param_dtype, "cpu",
                         tpctx=ctx)


# ---------------------------------------------------------------------------
# MLA's latent cache cut over the sequence: deepseek's smoke config, the
# latent's 64 columns in two halves
# ---------------------------------------------------------------------------

MLASEQ_MAX_LEN = 64           # two ranks: columns [0, 32) and [32, 64)
MLASEQ_CHUNK = 8
MLASEQ_STEPS = 4
# mesh (data, model), the rules' overrides, each row's written length. On
# (1, 2) the cut shares model with the query heads: row 0's prefill chunk
# crosses from rank 0's half to rank 1's, row 1 stays in rank 0's (rank 1
# sees none of it) with its last two columns bucket padding. On (2, 1) the
# cut takes data, the heads model: long_500k's one row crosses too.
MLASEQ_CASES = {"model": ((1, 2), {"act_kv_seq": "model"}, (28, 5)),
                "data": ((2, 1), {"act_kv_seq": "data"}, (29,))}


def mlaseq_config():
    return get_smoke_config("deepseek-v2-236b", n_layers=2, vocab=64,
                            dtype="float32")


def mlaseq_state(cfg, lens, seed=7):
    """Numpy inputs of a prefill chunk then decode steps over latent
    caches at ``lens``: every layer's ``ckv`` (B, T, kv_lora_rank) and
    ``krope`` (B, T, rope dim), the two halves' columns drawn apart; the
    chunk's tokens, positions (row 1's last two columns -1) and each
    row's last real column."""
    rng = np.random.default_rng(seed)
    B, T, half = len(lens), MLASEQ_MAX_LEN, MLASEQ_MAX_LEN // 2

    def draw(width):
        a = rng.standard_normal((B, T, width)).astype(np.float32)
        a[:, half:] = 0.5 * a[:, half:] + 0.5
        return a
    latent = [{"ckv": draw(cfg.kv_lora_rank),
               "krope": draw(cfg.qk_rope_head_dim),
               "len": np.asarray(lens, np.int32)}
              for _ in range(cfg.n_layers)]
    tokens = rng.integers(0, cfg.vocab, (B, MLASEQ_CHUNK)).astype(np.int32)
    pos = (np.asarray(lens, np.int32)[:, None]
           + np.arange(MLASEQ_CHUNK, dtype=np.int32))
    last = np.full((B,), MLASEQ_CHUNK - 1, np.int64)
    if B > 1:
        pos[1, -2:] = -1
        last[1] = MLASEQ_CHUNK - 3
    return latent, tokens, pos, last


def mlaseq_port_caches(latent):
    """The port's whole latent caches: a sink column after each."""
    def sink(a):
        return torch.from_numpy(np.concatenate(
            [a, np.zeros_like(a[:, :1])], axis=1))
    return [{"ckv": sink(c["ckv"]), "krope": sink(c["krope"]),
             "len": torch.from_numpy(c["len"].copy())} for c in latent]


def mlaseq_serve(cfg, params, caches, state, ctx, attn_policy):
    """The chunk's prefill, then MLASEQ_STEPS greedy decode steps,
    through the serving steps: (logits (1 + steps, B, vocab), tokens
    (1 + steps, B), caches)."""
    from repro_torch.serving.engine import make_decode_step, \
        make_prefill_step
    _, tokens, pos, last = state
    prefill = make_prefill_step(cfg, attn=attn_policy, tpctx=ctx)
    decode = make_decode_step(cfg, attn=attn_policy, tpctx=ctx)
    logits = []
    with torch.no_grad():
        lg, caches = prefill(params, {
            "tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos),
            "last_cols": torch.from_numpy(last)}, caches)
        nxt = torch.from_numpy(pos[np.arange(len(last)), last] + 1)[:, None]
        toks = []
        for i in range(MLASEQ_STEPS + 1):
            if i:
                lg, caches = decode(params, tok, nxt, caches)
                nxt = nxt + 1
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            logits.append(lg.float().numpy())
            toks.append(tok[:, 0].numpy())
    return np.stack(logits), np.stack(toks), caches


def mlaseq_rank(rank, world, params_np, policies):
    """This rank's prefill and decode over its half of every latent
    cache, for each case of :data:`MLASEQ_CASES` and attention policy:
    logits, tokens, the collectives of the run, its caches' offsets and
    shapes (cut whole caches and ``init_caches``), the up-projection's
    shape as it holds it."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.module import param_axes
    cfg = mlaseq_config()
    whole = from_jax_params(params_np, cfg)
    out = {}
    for case, (shape, overrides, lens) in MLASEQ_CASES.items():
        mesh = make_host_mesh(model=shape[1])
        ctx = ST.serve_context(cfg, mesh, extra_overrides=overrides)
        params = TP.shard_params(whole, param_axes(cfg), ctx,
                                 units=TP.head_units(cfg))
        state = mlaseq_state(cfg, lens)
        for name in policies:
            caches = TP.shard_caches(mlaseq_port_caches(state[0]), ctx,
                                     shard_kv=False)
            made = _init_caches(cfg, len(lens), MLASEQ_MAX_LEN, ctx)
            TP.collectives.reset()
            lg, toks, caches = mlaseq_serve(
                cfg, params, caches, state, ctx,
                AttentionPolicy(backend=name))
            out[case, name] = dict(
                logits=lg, tokens=toks,
                collectives=TP.collectives.by_axes(mesh),
                offsets=[int(c["seq_offset"]) for c in caches],
                shapes=[(tuple(c["ckv"].shape), tuple(c["krope"].shape))
                        for c in caches],
                init=[(tuple(c["ckv"].shape), int(c["seq_offset"]))
                      for c in made],
                ckv=[c["ckv"][:, :-1].numpy() for c in caches],
                lens=[c["len"].numpy() for c in caches],
                wkv_b=tuple(params["layers"][0]["attn"]["wkv_b"].shape),
                wq_b=tuple(params["layers"][0]["attn"]["wq_b"].shape))
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism (act_seq over model) in the train step
# ---------------------------------------------------------------------------

SEQPAR = {"act_seq": "model"}
SEQPAR_ARCHS = ("smollm-135m", "qwen3-8b", "granite-20b", "dbrx-132b",
                "deepseek-v2-236b", "zamba2-2.7b")


def seqpar_config(arch, **kw):
    return get_smoke_config(arch, n_layers=2, vocab=64, dtype="float32",
                            **kw)


def seqpar_grads(cfg, params, batch, mesh, overrides):
    """The gradients of ``make_train_step_fn``'s AdamW (``steps.
    make_grad_fn``) and the step's loss and grad norm, from the whole
    ``params`` cut to this rank's share on ``mesh`` under ``overrides``,
    on the global ``batch``: the gradients gathered whole, whether the
    step ran sequence-parallel and its collectives."""
    from repro_torch.core.plan import UNFUSED
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    held = ST.rank_params(cfg, params, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with api.use_policy(GemmPolicy(backend="matrixflow")), \
            api.use_attention_policy(UNFUSED):
        TP.collectives.reset()
        (loss, _), grads = ST.make_grad_fn(
            cfg, mesh=mesh, rules_overrides=overrides)(held, tb)
        coll = TP.collectives.by_axes(mesh)
        step = ST.make_train_step_fn(cfg, AdamWConfig(lr=DP_LR),
                                     total_steps=10, mesh=mesh,
                                     rules_overrides=overrides)
        _, _, m = step(held, adamw_init(held), tb)
    with TP.use_tp(ST.tp_context(cfg, mesh, overrides)):
        sp = T.seq_parallel(cfg, ST.data_shard(tb, mesh))
    return {"loss": float(loss), "step_loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "seq_parallel": sp,
            "collectives": coll,
            "grads": _leaves_np(ST.full_params(cfg, grads, mesh))}


def seqpar_rank(rank, world, params_np, batches):
    """On the (data 2, model 2) mesh, for each config of
    :data:`SEQPAR_ARCHS` and each named global batch: the gradients under
    ``act_seq -> model`` and under the config's own rules (the baseline
    TP step). A batch whose halves are equal gives both data rows the same
    rows, so it runs the model-2 pair alone. Besides, for smollm-135m: a
    sequence that does not divide over model (falls back to whole) and
    remat "dots" under sequence parallelism; for qwen3-8b, "dots"."""
    import dataclasses
    mesh = make_host_mesh(model=2)
    out = {}
    for arch in SEQPAR_ARCHS:
        cfg = seqpar_config(arch)
        params = from_jax_params(params_np[arch], cfg)
        for name in ("tp2", "dp2tp2"):
            for rules in ("seqpar", "baseline"):
                out[arch, name, rules] = seqpar_grads(
                    cfg, params, batches[name], mesh,
                    SEQPAR if rules == "seqpar" else None)
        if arch in ("smollm-135m", "qwen3-8b"):
            dots = dataclasses.replace(cfg, remat_policy="dots")
            out[arch, "dp2tp2", "seqpar_dots"] = seqpar_grads(
                dots, params, batches["dp2tp2"], mesh, SEQPAR)
    cfg = seqpar_config("smollm-135m")
    params = from_jax_params(params_np["smollm-135m"], cfg)
    for rules in ("seqpar", "baseline"):
        out["smollm-135m", "odd", rules] = seqpar_grads(
            cfg, params, batches["odd"], mesh,
            SEQPAR if rules == "seqpar" else None)
    return out
