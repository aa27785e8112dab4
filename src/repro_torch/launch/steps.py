"""The optimizer step of the training launcher and the sharding trees of
its meshes (``repro/launch/steps.py``).

The trees map a config's params, optimizer state, batch and caches to
specs (``distributed/sharding.py``: a tuple per tensor, the counterpart of
the reference's ``PartitionSpec``); where the ranks' params part from
:func:`model_shardings`' tree, its docstring says how.

Training runs over a ``(data, model)`` or ``(pod, data, model)`` mesh,
with the params and AdamW's moments placed as the reference's rules place
them (:func:`rank_params`):

  * along ``pod`` x ``data`` (pod major, the reference's ``act_batch``)
    each rank takes its slice of the global batch; along ``data`` it holds
    its cut of every leaf whose ``embed`` dim the data axis divides (FSDP,
    ``distributed/fsdp.py``): the model gathers a leaf where it uses it,
    and the gathers' backward reduce-scatters the gradients, which one
    all-reduce over ``pod`` then sums; the leaves that stay whole over
    data (norms whose dim does not divide) are summed by one all-reduce
    over pod x data, with the loss and the metrics, and every gradient is
    divided by the pod x data ranks (:func:`_average_over_batch`); params
    and moments are replicated over ``pod``;
  * along ``model`` each rank holds its slices of the params (the cut of
    tensor-parallel serving, ``tp.shard_params``, and its experts' slice
    of the MoE banks: expert parallelism) and runs the forward and
    backward tensor-parallel (``distributed/tp.py``'s collectives under
    autograd), the loss vocab-parallel.

Under sequence parallelism (``rules_overrides={"act_seq": "model"}``,
the reference's ``seqpar`` arm) the model axis also cuts the residual
stream's sequence (``models/transformer.py``): a leaf that every rank
holds whole is then applied by each rank to its own rows, so its
gradient is the rank's share, and one all-reduce over the model group
sums those shares before the clip (:func:`_sum_whole_over_model`).

The clip's global gradient norm sums each leaf's squares over the axes
that cut it (:func:`_grad_norm`), and AdamW runs on the cuts, so its
moments inherit them; int8 gradient compression takes each leaf's scale
from the whole leaf's amax, a max over the axes that cut it
(:func:`_grad_amax`). Checkpoints hold whole arrays: :func:`full_state`
gathers a rank's state, :func:`rank_state` cuts it again, on any mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import ShapeCell
from repro_torch.core.plan import ShardingPolicy
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_axes
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_map


def value_and_grad(loss_fn: Callable, params) -> Tuple[Tuple, Dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)`` for a tree of
    tensors: ((loss, metrics), grads), grads in the params' tree and
    dtypes; a parameter the loss does not reach gets zeros (the audio
    family's unused ``embed``), as in JAX."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(p)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda t: by_id[id(t)], p))


def data_shard(batch: Dict[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: its contiguous 1/n of every
    leaf's first dim over the n ranks of pod x data, pod major (the
    reference's ``act_batch`` → ("pod", "data"))."""
    if mesh is None:
        return batch
    i, n = mesh.span(FSDP.BATCH_AXES)
    if n == 1:
        return batch
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows; the "
                             f"{n} ranks of pod x data must divide them")
    return {k: TP.shard_dim(v, 0, i, n) for k, v in batch.items()}


def all_reduce_mean(tree, group, n: int):
    """Every leaf averaged over ``group`` (n ranks) in one all-reduce of
    their fp32 concatenation; each leaf keeps its dtype."""
    leaves = tree_leaves(tree)
    if n == 1 or not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    flat = TP.all_reduce(flat, group) / n
    out, i = {}, 0
    for t in leaves:
        out[id(t)] = flat[i:i + t.numel()].reshape(t.shape).to(t.dtype)
        i += t.numel()
    return tree_map(lambda t: out[id(t)], tree)


# The reference's activation rules that the port places as the reference
# does: act_batch over pod x data (``fsdp.BATCH_AXES``), nothing else.
PORTED_ACT_BATCH = shd.DEFAULT_RULES["act_batch"]


def merged_overrides(cfg: ModelConfig, overrides: Optional[Dict] = None
                     ) -> Dict:
    """The config's own sharding overrides with ``overrides`` on top, as
    :func:`make_rules` merges them; raises NotImplementedError for an
    ``act_batch`` rule other than the default, which the port does not
    place (the reference's ``batch2d`` and ``kvseq_batch2d`` arms,
    ``benchmarks/hillclimb.py:51``; ROADMAP queue 1, item 14)."""
    merged = cfg.overrides_dict()
    if overrides:
        merged.update(overrides)
    check_ported_rules(merged)
    return merged


def check_ported_rules(overrides: Dict) -> None:
    """Raise NotImplementedError for a rule the port does not place."""
    batch = overrides.get("act_batch", PORTED_ACT_BATCH)
    if batch != PORTED_ACT_BATCH:
        raise NotImplementedError(
            f"act_batch -> {batch!r} (the reference's batch2d arm, "
            f"benchmarks/hillclimb.py:51) is not ported: the port cuts the "
            f"batch over {PORTED_ACT_BATCH!r} alone (ROADMAP queue 1, "
            f"item 14)")


def tp_context(cfg: ModelConfig, mesh, overrides: Optional[Dict] = None
               ) -> Optional[TP.TPContext]:
    """The TP context of a mesh whose ``model`` axis spans more than one
    rank, under the config's own sharding overrides and ``overrides`` on
    top (:func:`merged_overrides`); else None."""
    merged = merged_overrides(cfg, overrides)
    if mesh is None or mesh.axis_size("model") == 1:
        return None
    return TP.make_context(mesh, overrides=merged)


def rank_params(cfg: ModelConfig, params, mesh):
    """This rank's cut of whole ``params`` (or of their ``meta``
    stand-ins, or of an AdamW moment of the same tree) on ``mesh``: its
    slices over the model axis (``tp.shard_params``, as the
    tensor-parallel engine cuts them, and its experts' slice of the MoE
    banks, which the engine keeps whole), then its cut of each leaf's
    ``embed`` dim over the data axis (``fsdp.shard_params``); the params
    themselves on one rank. A tree that is already the rank's comes back
    as it is."""
    params = TP.shard_params(params, param_axes(cfg), tp_context(cfg, mesh),
                             units=TP.head_units(cfg), experts=True)
    return FSDP.shard_params(params, FSDP.make_context(cfg, mesh))


def full_params(cfg: ModelConfig, params, mesh):
    """The whole leaves of a rank's ``params`` (or of an AdamW moment of
    the same tree): gathered over the data axis, then the model axis.
    Every rank of the mesh must call it."""
    params = FSDP.full_params(params, FSDP.make_context(cfg, mesh))
    return TP.unshard_params(params, param_axes(cfg), tp_context(cfg, mesh),
                             units=TP.head_units(cfg),
                             shapes=T.init_model(cfg, device="meta"),
                             experts=True)


def _map_state(fn, state):
    """``fn`` over the params-shaped parts of a training state: ``params``
    and the optimizer's ``mu`` and ``nu`` (the ``step`` as it is)."""
    opt = state["opt"]
    return {"params": fn(state["params"]),
            "opt": dict(opt, mu=fn(opt["mu"]), nu=fn(opt["nu"]))}


def full_state(cfg: ModelConfig, state, mesh):
    """A rank's ``{"params", "opt"}`` with every leaf at its full shape
    (the reference's checkpoint, ``repro/train/checkpoint.py``): a
    collective, which every rank must enter; rank 0 writes the result."""
    return _map_state(lambda t: full_params(cfg, t, mesh), state)


def rank_state(cfg: ModelConfig, state, mesh):
    """The rank's cut of a whole ``{"params", "opt"}`` (a checkpoint
    written on any mesh, or on one device)."""
    return _map_state(lambda t: rank_params(cfg, t, mesh), state)


def _cuts(grads, shapes, fsctx: Optional[FSDP.FSDPContext]):
    """(gradient, its cut over data or None, whether the model axis cuts
    it) of every leaf."""
    for (g, cut), full in zip(FSDP.leaves_with_cuts(grads, fsctx),
                              tree_leaves(shapes)):
        yield g, cut, any(g.shape[i] != full.shape[i] for i in range(g.dim())
                          if cut is None or i != cut.dim)


def _sum_whole_over_model(grads, shapes, tpctx: TP.TPContext,
                          fsctx: Optional[FSDP.FSDPContext]):
    """Under sequence parallelism: the gradients of the leaves that the
    model axis does not cut (norms, whole weights, a row-parallel bias),
    each rank's the share of its rows, summed over the model group in one
    all-reduce of their fp32 concatenation."""
    whole = [g for g, _, on_model in _cuts(grads, shapes, fsctx)
             if not on_model]
    if not whole:
        return grads
    flat = TP.all_reduce(torch.cat([t.reshape(-1).float() for t in whole]),
                         tpctx.group)
    new, i = {}, 0
    for t in whole:
        new[id(t)] = flat[i:i + t.numel()].reshape(t.shape).to(t.dtype)
        i += t.numel()
    return tree_map(lambda g: new.get(id(g), g), grads)


def _grad_norm(grads, shapes, tpctx: Optional[TP.TPContext],
               fsctx: Optional[FSDP.FSDPContext]) -> torch.Tensor:
    """The global norm of the whole gradients from a rank's: each leaf's
    squares summed over the axes that cut it — data and model, one of
    them, or (a leaf replicated on both) none, counted once."""
    sums = {(d, m): [] for d in (False, True) for m in (False, True)}
    for g, cut, on_model in _cuts(grads, shapes, fsctx):
        sums[cut is not None, on_model].append(torch.sum(g.float() ** 2))
    dev = tree_leaves(grads)[0].device
    part = {k: torch.stack(v).sum() if v else
            torch.zeros((), dtype=torch.float32, device=dev)
            for k, v in sums.items()}
    both = torch.stack([part[True, False], part[True, True]])
    if fsctx is not None:
        both = TP.all_reduce(both, fsctx.group)
    on_model = torch.stack([part[False, True], both[1]])
    if tpctx is not None:
        on_model = TP.all_reduce(on_model, tpctx.group)
    return torch.sqrt(part[False, False] + both[0] + on_model.sum())


def _average_over_batch(grads, extra, fsctx: FSDP.FSDPContext):
    """The gradients of the global batch from a rank's, and ``extra``
    (the loss and metrics), averaged over the n = pod x data ranks: a
    leaf cut over data holds its reduce-scattered sum over data already,
    and the cuts are summed over pod in one all-reduce; the rest go in one
    all-reduce over pod x data (:func:`all_reduce_mean`)."""
    pairs = FSDP.leaves_with_cuts(grads, fsctx)
    whole = [g for g, cut in pairs if cut is None]
    whole, extra = all_reduce_mean((whole, extra), fsctx.batch_group,
                                   fsctx.batch_size)
    # a cut's gradient is its reduce-scatter's own output: divided in place
    cuts = [g.div_(fsctx.size) for g, cut in pairs if cut is not None]
    mesh = fsctx.mesh
    cuts = all_reduce_mean(cuts, mesh.group("pod"), mesh.axis_size("pod"))
    it_whole, it_cut = iter(whole), iter(cuts)
    new = {id(g): next(it_whole if cut is None else it_cut)
           for g, cut in pairs}
    return tree_map(lambda g: new[id(g)], grads), extra


def _layer_leaves(layer, path=()):
    """(path, leaf) of every leaf of one layer's params."""
    if isinstance(layer, dict):
        return [x for k in sorted(layer)
                for x in _layer_leaves(layer[k], path + (k,))]
    return [(path, layer)]


def _grad_amax(grads, tpctx: Optional[TP.TPContext],
               fsctx: Optional[FSDP.FSDPContext]):
    """The amax that int8 compression scales each gradient leaf by, as
    the reference's per-tensor quantization sees its tensor: the whole
    leaf's, from a rank's cut of it (the rank's amaxes, one max-reduce
    over data and one over model: a leaf that an axis does not cut has
    the same gradient on every rank of it, so the max over that axis
    leaves its amax as it is); and for a layer's leaf, the max over every
    layer's, since the reference stacks ``params["layers"]`` into one
    tensor a leaf."""
    leaves = tree_leaves(grads)
    amax = torch.stack([g.detach().float().abs().max() for g in leaves])
    for ctx in (fsctx, tpctx):
        if ctx is not None:
            amax = TP.all_reduce_max(amax, ctx.group)
    by_id = {id(g): amax[i] for i, g in enumerate(leaves)}
    stacks: Dict[Tuple, list] = {}
    for layer in grads.get("layers", ()):
        for path, g in _layer_leaves(layer):
            stacks.setdefault(path, []).append(g)
    for gs in stacks.values():
        top = torch.stack([by_id[id(g)] for g in gs]).max()
        by_id.update((id(g), top) for g in gs)
    return tree_map(lambda g: by_id[id(g)], grads)


def _check_held(params, shapes, fsctx: FSDP.FSDPContext) -> None:
    for (p, cut), full in zip(FSDP.leaves_with_cuts(params, fsctx),
                              tree_leaves(shapes)):
        if cut is not None and p.shape[cut.dim] == full.shape[cut.dim]:
            raise ValueError(
                f"a whole {tuple(p.shape)} leaf on a mesh whose data axis "
                f"cuts it: hold the rank's params (steps.rank_params) and "
                f"adamw_init of them")


def _contexts(cfg: ModelConfig, mesh, overrides: Optional[Dict]):
    """The TP and FSDP contexts of a train step on ``mesh`` and the
    params' global shapes (``meta``; None on one device)."""
    tpctx = tp_context(cfg, mesh, overrides)
    fsctx = FSDP.make_context(cfg, mesh)
    shapes = None
    if tpctx is not None or fsctx is not None:
        shapes = T.init_model(cfg, device="meta")
    return tpctx, fsctx, shapes


def make_train_step_fn(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                       total_steps: int = 10000, microbatches: int = 1,
                       mesh=None, *, base_lr: Optional[float] = None,
                       warmup: int = 100, aux_weight: float = 0.01,
                       rules_overrides: Optional[Dict] = None):
    """One optimizer step: (params, opt_state, batch) → (params,
    opt_state, metrics). With ``microbatches`` > 1 the batch is split
    along its first dim and the gradients are summed in fp32 and averaged —
    the same math, the activations of one microbatch alive at a time.

    On a ``mesh`` ``batch`` is the global batch and ``params`` and
    ``opt_state`` are this rank's cuts (:func:`rank_params`; ``adamw_init``
    of them): each rank takes its rows (:func:`data_shard`), the forward
    and backward run under the mesh's FSDP and TP contexts, and the
    gradients and the loss are averaged over pod x data
    (:func:`_average_over_batch`) before AdamW, so the step is the global
    batch's, an MoE model's dispatch groups and load-balance loss included
    (``layers.moe``). int8 gradient compression quantizes each rank's cut
    with the whole tensor's per-tensor scale (:func:`_grad_amax`: a
    layer's leaf takes the scale of the reference's stacked tensor, on one
    device too), after the clip's norm is taken, as the reference
    quantizes the whole averaged gradient; as in the reference's step, no
    error is carried to the next step. The schedule takes ``base_lr``
    (default ``opt_cfg.lr``) and warms up over ``warmup`` steps, fixed at
    100 as in the reference (a reference caveat, ROADMAP.md; the
    ``Trainer`` passes its own); ``aux_weight`` scales the experts' loss.
    The multi-microbatch metrics report ``aux`` as 0.

    ``rules_overrides`` layer on the config's own rules
    (:func:`merged_overrides`): ``{"act_seq": "model"}`` runs the step
    sequence-parallel wherever the batch's sequence divides over the
    model axis (:func:`_sum_whole_over_model`); an ``act_batch`` rule
    raises."""
    opt_cfg = opt_cfg or AdamWConfig()
    base_lr = opt_cfg.lr if base_lr is None else base_lr
    tpctx, fsctx, shapes = _contexts(cfg, mesh, rules_overrides)
    grads_of = _grads_fn(cfg, microbatches, mesh, tpctx, fsctx, shapes,
                         aux_weight)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grads_of(params, batch)
        lr = cosine_schedule(opt_state["step"], base_lr=base_lr,
                             warmup=warmup, total=total_steps)
        gnorm = None if shapes is None else _grad_norm(grads, shapes,
                                                       tpctx, fsctx)
        amax = _grad_amax(grads, tpctx, fsctx) if opt_cfg.compress_grads \
            else None
        params, opt_state, om, _ = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr, gnorm=gnorm,
                                                amax=amax)
        return params, opt_state, dict(metrics, loss=loss, lr=lr, **om)

    return train_step


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1, mesh=None, *,
                 aux_weight: float = 0.01,
                 rules_overrides: Optional[Dict] = None):
    """The gradients that :func:`make_train_step_fn`'s AdamW takes:
    (params, batch) → ((loss, metrics), grads), the global batch's on a
    ``mesh`` (``params`` this rank's cuts, ``batch`` the global batch),
    each rank holding its cut of each leaf's gradient."""
    return _grads_fn(cfg, microbatches, mesh,
                     *_contexts(cfg, mesh, rules_overrides), aux_weight)


def _grads_fn(cfg: ModelConfig, microbatches: int, mesh,
              tpctx: Optional[TP.TPContext],
              fsctx: Optional[FSDP.FSDPContext], shapes, aux_weight: float):
    """:func:`make_grad_fn` under contexts the caller built
    (:func:`_contexts`)."""

    def grad_of(params, batch):
        with TP.use_tp(tpctx), FSDP.use_fsdp(fsctx):
            return value_and_grad(
                lambda p: T.lm_loss(p, cfg, batch, aux_weight=aux_weight),
                params)

    def grads_of(params, batch):
        if fsctx is not None:
            _check_held(params, shapes, fsctx)
        batch = data_shard(batch, mesh)
        if microbatches == 1:
            (loss, metrics), grads = grad_of(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                (loss_mb, _), g = grad_of(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + loss_mb
            scale = 1.0 / microbatches
            grads = tree_map(lambda g: g * scale, grads)
            loss = loss * scale
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        with TP.use_tp(tpctx):
            sp = T.seq_parallel(cfg, batch)
        if sp:
            grads = _sum_whole_over_model(grads, shapes, tpctx, fsctx)
        if fsctx is not None:
            grads, (loss, metrics) = _average_over_batch(
                grads, (loss, metrics), fsctx)
        return (loss, metrics), grads

    return grads_of


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------

def _tree(fn, node, path=()):
    if isinstance(node, dict):
        return {k: _tree(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree(fn, v, path + (i,))
                          for i, v in enumerate(node))
    return fn(path, node)


def batch_shardings(batch_specs, rules: shd.ShardingRules):
    """tokens/labels (B, S[, CB]) and embeds (B, N, D) shard the batch
    over DP; a leaf is a tensor (on the ``meta`` device for abstract
    specs, ``launch/specs.py``)."""
    def one(_, leaf):
        shape = tuple(leaf.shape)
        return rules.spec(["act_batch"] + [None] * (len(shape) - 1), shape)
    return _tree(one, batch_specs)


def cache_shardings(cache_specs, rules: shd.ShardingRules):
    """Right-aligned role-based specs by each leaf's innermost key
    (``sharding.CACHE_DIM_RULES``, ``sharding.cache_spec``); leading dims
    replicate, and a leaf with no rule replicates whole. A contiguous KV
    cache's ``k``/``v`` sequence is cut on the axis this gives
    ``act_kv_seq`` (``tp.seq_cut``, ``transformer.init_caches``)."""
    def one(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        return shd.cache_spec(rules, name, tuple(leaf.shape))
    return _tree(one, cache_specs)


def model_shardings(cfg: ModelConfig, params_abs, axes,
                    rules: shd.ShardingRules):
    """The reference's placement of the params: a tree of specs, equal to
    the reference's. A training rank holds what :func:`rank_params` cuts:
    the same dims of the same spec over ``model`` (``tp.param_cut``) and
    over ``data`` (``fsdp.make_plan``), and so the same bytes, but where
    a rank, which cannot reshard, parts from GSPMD:

      * SwiGLU's gate ‖ up weight: a rank holds the same chunk of each half
        over ``model`` (the spec's contiguous halves would give one rank
        the gate and the other the up) — other columns, the same bytes;
      * a head dim whose heads do not divide over the model axis (MQA's
        single KV head): whole on the rank where the spec splits its
        columns;
      * the MoE ``wo`` bank's d_model dim, which the reference's axes
        leave unnamed (whole over ``data``), is cut over ``data`` as well
        (``fsdp.make_plan``), beside the spec's cut of its experts over
        ``model``;
      * the SSD blocks and the audio family's per-codebook tables (3-D)
        stay whole over ``model``, as the reference's ``tp.linear`` runs
        them unsharded.

    Serving holds the params whole over ``data``, and the MoE banks whole
    over ``model``, as the reference's serving does."""
    return shd.param_specs(axes, params_abs, rules)


def opt_shardings(param_shardings_tree, rules: shd.ShardingRules):
    return {"mu": param_shardings_tree, "nu": param_shardings_tree,
            "step": ()}


def serve_context(cfg: ModelConfig, mesh, shape: Optional[ShapeCell] = None,
                  extra_overrides: Optional[Dict] = None
                  ) -> Optional[TP.TPContext]:
    """The TP context of serving ``cfg`` on ``mesh`` under the rules of
    ``shape``'s cell (:func:`make_rules`: ``long_500k`` cuts the KV caches'
    sequence over data), whatever the model axis's size; None without a
    mesh. ``init_caches(tpctx=)`` and the serving steps take it."""
    if mesh is None:
        return None
    return TP.TPContext(mesh=mesh,
                        rules=make_rules(cfg, mesh, shape, extra_overrides),
                        policy=ShardingPolicy())


def make_rules(cfg: ModelConfig, mesh, shape: Optional[ShapeCell] = None,
               extra_overrides: Optional[Dict] = None) -> shd.ShardingRules:
    """The rules of ``cfg`` on ``mesh`` for ``shape``'s cell, with
    ``extra_overrides`` on top; an ``act_batch`` rule raises
    (:func:`check_ported_rules`)."""
    overrides = cfg.overrides_dict()
    if shape is not None and shape.name == "long_500k":
        # the huge decode context: the KV caches' sequence over data (the
        # SSD state keeps act_heads, which this does not touch)
        overrides.setdefault("act_kv_seq", "data")
    if extra_overrides:
        overrides.update(extra_overrides)
    check_ported_rules(overrides)
    return shd.ShardingRules(mesh, overrides)
