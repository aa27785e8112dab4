"""The optimizer step of the training launcher and the sharding trees of
its meshes (``repro/launch/steps.py``).

The trees map a config's params, optimizer state, batch and caches to
specs (``distributed/sharding.py``: a tuple per tensor, the counterpart of
the reference's ``PartitionSpec``); where the ranks' params part from
:func:`model_shardings`' tree, its docstring says how.

Training runs over a ``(data, model)`` mesh. Each rank of the ``data``
axis takes its slice of the global batch, and the gradients are averaged
by one all-reduce over the data group before AdamW. Along the ``model``
axis each rank holds its slices of the params (:func:`rank_params`, the
cut of tensor-parallel serving) and runs the forward and backward
tensor-parallel (``distributed/tp.py``'s collectives under autograd); the
clip's global gradient norm sums the sliced leaves over the model group.
So every rank of a data line applies the same update to the same params,
and a replicated leaf (a norm) gets the same gradient on every model rank.
The reference's FSDP over ``data`` (params and optimizer state sharded
there too) is not ported: they stay replicated over ``data`` (ROADMAP.md
queue 1).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import ShapeCell
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


def data_shard(batch: Dict[str, torch.Tensor], mesh, axis: str = "data"
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: the ``axis`` coordinate's
    contiguous 1/n of every leaf's first dim (the reference's
    ``act_batch`` → data sharding)."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1:
        return batch
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows; the "
                             f"{axis} axis of {n} ranks must divide them")
    return {k: TP.shard_dim(v, 0, mesh.coords[axis], n)
            for k, v in batch.items()}


def all_reduce_mean(tree, group, n: int):
    """Every leaf averaged over ``group`` (n ranks) in one all-reduce of
    their fp32 concatenation; each leaf keeps its dtype."""
    if n == 1:
        return tree
    leaves = tree_leaves(tree)
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    flat = TP.all_reduce(flat, group) / n
    out, i = {}, 0
    for t in leaves:
        out[id(t)] = flat[i:i + t.numel()].reshape(t.shape).to(t.dtype)
        i += t.numel()
    return tree_map(lambda t: out[id(t)], tree)


def tp_context(cfg: ModelConfig, mesh) -> Optional[TP.TPContext]:
    """The TP context of a mesh whose ``model`` axis spans more than one
    rank, under the config's own sharding overrides; else None."""
    if mesh is None or mesh.axis_size("model") == 1:
        return None
    return TP.make_context(mesh, overrides=cfg.overrides_dict())


def rank_params(cfg: ModelConfig, params, mesh):
    """This rank's slices of whole ``params`` (or of their ``meta``
    stand-ins) on ``mesh``'s model axis: ``tp.shard_params``, as the
    tensor-parallel engine cuts them; the params themselves without a
    model axis."""
    ctx = tp_context(cfg, mesh)
    return TP.shard_params(params, param_axes(cfg), ctx,
                           units=TP.head_units(cfg))


def _tp_grad_norm(grads, shapes, ctx: TP.TPContext) -> torch.Tensor:
    """The global norm of the whole gradients from a rank's: the squares
    of the sliced leaves summed over the model group, those of the
    replicated leaves (the same on every rank) once."""
    sliced, whole = [], []
    for g, full in zip(tree_leaves(grads), tree_leaves(shapes)):
        sq = torch.sum(g.float() ** 2)
        (whole if tuple(g.shape) == tuple(full.shape) else sliced).append(sq)
    total = torch.stack(whole).sum() if whole else 0.0
    if sliced:
        total = total + TP.all_reduce(torch.stack(sliced).sum(), ctx.group)
    return torch.sqrt(total)


def make_train_step_fn(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                       total_steps: int = 10000, microbatches: int = 1,
                       mesh=None):
    """One optimizer step: (params, opt_state, batch) → (params,
    opt_state, metrics). With ``microbatches`` > 1 the batch is split along
    its first dim and the gradients are summed in fp32 and averaged — the
    same math, the activations of one microbatch alive at a time.

    With a ``mesh`` whose ``data`` axis spans n > 1 ranks, ``batch`` is the
    global batch: each rank takes its rows (:func:`data_shard`), and the
    gradients and the loss are averaged over the data group (one
    all-reduce, :func:`all_reduce_mean`) before AdamW. For a dense model
    that is the global batch's step; an MoE model's load-balance aux loss
    is taken per rank's rows. With a ``model`` axis of m > 1 ranks,
    ``params`` and ``opt_state`` are this rank's slices
    (:func:`rank_params`; ``adamw_init`` of them) and the step runs
    tensor-parallel; int8 gradient compression, whose per-tensor scale a
    slice cannot reproduce, raises there. As in the reference, the
    schedule's warmup is fixed at 100 steps here (a reference caveat,
    ROADMAP.md), and the multi-microbatch metrics report ``aux`` as 0."""
    opt_cfg = opt_cfg or AdamWConfig()
    group = None if mesh is None else mesh.group("data")
    n_data = 1 if mesh is None else mesh.axis_size("data")
    tpctx = tp_context(cfg, mesh)
    shapes = None
    if tpctx is not None:
        if opt_cfg.compress_grads:
            raise NotImplementedError(
                "compress_grads under a model axis: a slice's per-tensor "
                "int8 scale is not the whole gradient's")
        shapes = T.init_model(cfg, device="meta")

    def grad_of(params, batch):
        with TP.use_tp(tpctx):
            return value_and_grad(lambda p: T.lm_loss(p, cfg, batch), params)

    def train_step(params, opt_state, batch):
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
        if n_data > 1:
            grads, (loss, metrics) = all_reduce_mean(
                (grads, (loss, metrics)), group, n_data)
        lr = cosine_schedule(opt_state["step"], base_lr=opt_cfg.lr,
                             warmup=100, total=total_steps)
        gnorm = None if tpctx is None else _tp_grad_norm(grads, shapes,
                                                         tpctx)
        params, opt_state, om, _ = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr, gnorm=gnorm)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


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


_CACHE_DIM_RULES = {
    "k": ("act_batch", "act_kv_seq", "act_kv_heads", None),
    "v": ("act_batch", "act_kv_seq", "act_kv_heads", None),
    "ckv": ("act_batch", "act_kv_seq", None),
    "krope": ("act_batch", "act_kv_seq", None),
    "len": ("act_batch",),
    "x": ("act_batch", None, "act_mlp"),      # conv state
    "B": ("act_batch", None, None),
    "C": ("act_batch", None, None),
    "state": ("act_batch", "act_heads", None, None),
}


def cache_shardings(cache_specs, rules: shd.ShardingRules):
    """Right-aligned role-based specs by each leaf's innermost key; leading
    dims replicate, and a leaf with no rule replicates whole."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        dims = _CACHE_DIM_RULES.get(name)
        if dims is None:
            return (None,) * len(shape)
        pad = (None,) * (len(shape) - len(dims))
        return rules.spec(pad + tuple(dims), shape)
    return _tree(one, cache_specs)


def model_shardings(cfg: ModelConfig, params_abs, axes,
                    rules: shd.ShardingRules):
    """The reference's placement of the params: a tree of specs, equal to
    the reference's. The ranks of a mesh hold what ``tp.shard_params``
    cuts, the same dim of the same spec (``tp.param_cut``) but for two
    cases where a rank, which cannot reshard, parts from GSPMD: SwiGLU's
    gate ‖ up weight, of which a rank holds the same chunk of each half
    (the spec's contiguous halves would give one rank the gate and the
    other the up), and a head dim whose heads do not divide over the model
    axis (MQA's single KV head), which a rank holds whole where the spec
    splits its columns."""
    return shd.param_specs(axes, params_abs, rules)


def opt_shardings(param_shardings_tree, rules: shd.ShardingRules):
    return {"mu": param_shardings_tree, "nu": param_shardings_tree,
            "step": ()}


def make_rules(cfg: ModelConfig, mesh, shape: Optional[ShapeCell] = None,
               extra_overrides: Optional[Dict] = None) -> shd.ShardingRules:
    overrides = cfg.overrides_dict()
    if shape is not None and shape.name == "long_500k":
        # SP for the huge decode context: shard cache seq + SSM state heads
        overrides.setdefault("act_kv_seq", "data")
    if extra_overrides:
        overrides.update(extra_overrides)
    return shd.ShardingRules(mesh, overrides)
