"""FSDP over the ``data`` axis: a rank holds its cut of the params and
optimizer state, gathers a leaf where it is used and reduce-scatters the
gradient.

The reference's rules map every weight's ``embed`` dim to ``data``
(``repro/distributed/sharding.py:32``), and its AdamW moments inherit each
param's sharding (``repro/optim/adamw.py:4-6``): GSPMD holds 1/n_data of
such a weight on each rank, gathers it before use and reduce-scatters its
gradient. Every rank here runs its own program, so this module does that
by hand:

  * :func:`make_plan` — for each leaf, the dim a rank cuts over data: the
    one whose logical axis the rules put on the data axis (``embed``),
    where the data axis divides it; otherwise the leaf stays replicated,
    as the reference's rules fall back. One departure: an MoE ``wo`` bank
    (E, f, d) has no ``embed`` axis (the reference's ``expert_bank`` names
    its d_model dim ``None``), so the reference cuts it only by its
    experts over ``model`` and holds it whole over ``data``. The port cuts
    that d_model dim over data as well, as the ``embed`` dim of every
    other weight: held whole over data, dbrx-132b's ``wo`` banks alone
    would take ~25 GB a rank of the 16 x 16 mesh;
  * :func:`shard_params` — a rank's cut, composing with
    ``tp.shard_params``' cut over ``model`` (always another dim; the MoE
    banks' experts under expert parallelism, so a rank holds ``wi`` as
    (E/mp, d/n, 2f) and ``wo`` as (E/mp, f, d/n));
  * :func:`gather` — an autograd Function: the forward all-gathers the
    whole leaf over the data group, the backward reduce-scatters its
    gradient (summed over data; the step divides by n_data);
    :func:`gathered` applies it to a block's leaves where the model uses
    them (``models/transformer.py``), so under remat the gathered weights
    are freed after the forward and gathered again in the recompute;
  * :func:`mean_over_data` — a statistic of the rank's rows averaged over
    the batch's ranks, for MoE's load-balance loss (``models/layers.py``).

The batch is cut over ``pod`` × ``data``, pod major (the reference's
``act_batch``); the params are cut over ``data`` only and replicated over
``pod``. A mesh with a pod axis but one data rank has a context whose
plan cuts nothing: only its batch spans ranks.

A :class:`FSDPContext` is carried thread-local (:func:`use_fsdp`) like
``tp.py``'s context; training sets it (``launch/steps.py``), serving
never does (the reference replicates weights along ``data`` at
inference), and without it every function here is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import ShardingRules, tree_map_axes
from repro_torch.kernels.forward_only import needs_grad

__all__ = ["Cut", "FSDPContext", "make_plan", "make_context", "use_fsdp",
           "current_fsdp", "leaves_with_cuts", "shard_params", "gather",
           "gathered", "full_params", "mean_over_data"]


@dataclasses.dataclass(frozen=True)
class Cut:
    """The dim of a leaf that the data ranks cut, and its full size."""

    dim: int
    full: int


def _leaf_cut(rules: ShardingRules, names, shape, axis: str, n: int,
              d_model: int) -> Optional[Cut]:
    """The dim of a leaf (logical ``names``, global ``shape``) that ``n``
    ranks of the data ``axis`` cut, with its full size, or None."""
    for d, axes in enumerate(rules.spec(tuple(names), tuple(shape))):
        if axis in ((axes,) if isinstance(axes, str) else (axes or ())):
            return Cut(d, int(shape[d]))
    if (len(names) == 3 and names[0] == "experts" and "embed" not in names
            and shape[-1] == d_model and d_model % n == 0):
        return Cut(len(shape) - 1, int(shape[-1]))    # the MoE wo bank
    return None


def make_plan(cfg, mesh, axis: str = "data"):
    """A tree beside ``transformer.init_model(cfg)``'s: each leaf's cut
    over ``axis`` of ``mesh`` (a :class:`Cut`, or None), under the
    config's own sharding overrides."""
    from repro_torch.models import transformer as T
    from repro_torch.models.module import param_axes
    rules = ShardingRules(mesh, cfg.overrides_dict())
    n = mesh.axis_size(axis)
    return tree_map_axes(
        lambda a, full: None if n == 1 else _leaf_cut(
            rules, a, full.shape, axis, n, cfg.d_model),
        param_axes(cfg), T.init_model(cfg, device="meta"))


BATCH_AXES = ("pod", "data")        # the reference's act_batch


@dataclasses.dataclass
class FSDPContext:
    """A mesh's data axis and the plan of one config's params on it, and
    the axes its batch is cut over (:data:`BATCH_AXES`)."""

    mesh: Any
    plan: Any
    axis: str = "data"

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def rank(self) -> int:
        return int(self.mesh.coords.get(self.axis, 0))

    @property
    def group(self):
        return self.mesh.group(self.axis)

    @property
    def batch_size(self) -> int:
        """The ranks the batch is cut over: pod x data."""
        return self.mesh.span(BATCH_AXES)[1]

    @property
    def batch_group(self):
        return self.mesh.group(tuple(a for a in BATCH_AXES
                                     if a in self.mesh.shape))

    def at(self, *path):
        """The plan of the subtree at ``path`` (keys and list indices)."""
        node = self.plan
        for k in path:
            node = node[k]
        return node


def make_context(cfg, mesh, axis: str = "data") -> Optional[FSDPContext]:
    """The FSDP context of ``cfg`` on ``mesh``: None without a mesh or
    with one rank on the batch's axes (pod x data)."""
    if mesh is None or mesh.span(BATCH_AXES)[1] == 1:
        return None
    return FSDPContext(mesh=mesh, plan=make_plan(cfg, mesh, axis), axis=axis)


_state = threading.local()


def current_fsdp() -> Optional[FSDPContext]:
    return getattr(_state, "fsdp", None)


@contextlib.contextmanager
def use_fsdp(ctx: Optional[FSDPContext]):
    """Pin the active FSDP context for the enclosed region
    (thread-local)."""
    prev = getattr(_state, "fsdp", None)
    _state.fsdp = ctx
    try:
        yield ctx
    finally:
        _state.fsdp = prev


def _map(fn, params, plan):
    if isinstance(params, dict):
        return {k: _map(fn, v, plan[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_map(fn, v, c) for v, c in zip(params, plan))
    return fn(params, plan)


def leaves_with_cuts(params, ctx: Optional[FSDPContext]
                     ) -> List[Tuple[torch.Tensor, Optional[Cut]]]:
    """(leaf, its cut or None) in ``optim.adamw.tree_leaves``' order (dict
    keys sorted); every cut None without a context."""
    out = []

    def rec(p, c):
        if isinstance(p, dict):
            for k in sorted(p):
                rec(p[k], None if c is None else c[k])
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                rec(v, None if c is None else c[i])
        else:
            out.append((p, c))
    rec(params, None if ctx is None else ctx.plan)
    return out


def shard_params(params, ctx: Optional[FSDPContext]):
    """The rank's cut of ``params`` (whole over data, or already the
    rank's cut: it comes back as it is) on ``ctx``'s data axis."""
    if ctx is None:
        return params

    def one(p, cut):
        if cut is None:
            return p
        d, full = cut.dim, cut.full
        if p.shape[d] == full:
            return TP.shard_dim(p, d, ctx.rank, ctx.size)
        if p.shape[d] * ctx.size != full:
            raise ValueError(f"a {tuple(p.shape)} param is neither whole "
                             f"nor its cut over {ctx.size} data ranks on "
                             f"dim {d} (of {full})")
        return p
    return _map(one, params, ctx.plan)


class _Gather(torch.autograd.Function):
    """All-gather over the data group forward; reduce-scatter of the
    gradient backward: each rank's cut gets the sum over the data ranks
    of their gradients of the whole leaf."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return TP.all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return TP.reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather(t: torch.Tensor, dim: int, ctx: FSDPContext) -> torch.Tensor:
    """The whole of dim ``dim`` of a leaf from the data ranks' cuts; under
    autograd its gradient is reduce-scattered back (:class:`_Gather`)."""
    if needs_grad(t):
        return _Gather.apply(t, dim, ctx.group)
    return TP.all_gather(t, dim, ctx.group)


def gathered(params, *path):
    """``params`` (the subtree at ``path`` of the model's params) with
    every leaf that the active context cuts gathered whole over data;
    ``params`` itself without a context."""
    ctx = current_fsdp()
    if ctx is None:
        return params
    return _map(lambda p, cut: p if cut is None else gather(p, cut.dim, ctx),
                params, ctx.at(*path))


def full_params(params, ctx: Optional[FSDPContext]):
    """Every leaf of a params-shaped tree (params or an AdamW moment)
    gathered whole over data, without autograd (checkpoints)."""
    if ctx is None:
        return params
    return _map(lambda p, cut: p if cut is None
                else TP.all_gather(p.detach(), cut.dim, ctx.group),
                params, ctx.plan)


class _MeanOverData(torch.autograd.Function):
    """The mean over the batch's group forward; backward, each rank gets
    the whole gradient g of the mean, n times its own share g / n: the
    step then averages the gradients over the n ranks (÷ n), which makes
    the sum of the shares. (``tp._SumOverRanks``' identity backward of a
    sum would leave 1/n of it.)"""

    @staticmethod
    def forward(ctx, t, group, n):
        return TP.all_reduce(t.clone(memory_format=torch.contiguous_format),
                             group) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def mean_over_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` — a statistic of the rank's rows, each rank holding as many —
    averaged over the active context's batch group (pod x data): the
    statistic of the global batch. ``t`` itself without a context."""
    ctx = current_fsdp()
    if ctx is None:
        return t
    if needs_grad(t):
        return _MeanOverData.apply(t, ctx.batch_group, ctx.batch_size)
    return TP.all_reduce(t.clone(memory_format=torch.contiguous_format),
                         ctx.batch_group) / ctx.batch_size
