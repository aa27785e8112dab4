"""Tensor-parallel execution over a group of processes
(``repro/distributed/tp.py``).

The reference is one controller: ``shard_map`` over global arrays, and
GSPMD re-gathers wherever a sharded value meets an unsharded consumer.
Here every rank runs the same Python on its own slice (the mesh is a
process group, ``launch/mesh.py``), so this module holds the rank's slice
of every model-sharded weight (:func:`shard_params`) and issues every
collective itself:

  * **column-parallel** projections (QKV, MLP up/gate, LM head): the rank
    holds its N slice (and its bias slice) and computes its output columns
    from the full K; the output stays local. SwiGLU's gate ‖ up weight
    (``blocks=2``) slices each half alike, so the activation is local too.
  * **row-parallel** projections (attention out, MLP down): the rank holds
    its K slice, contracts its slice of x through the GEMM with an fp32
    output (int32 for int8), an ``all_reduce`` over the model group sums
    the partials, and then comes the cast and the bias, added once.
  * **attention** runs on the rank's head slice; paged pools and int8
    scales hold the rank's KV heads (:func:`head_sharding`). A contiguous
    KV cache whose sequence the cache rules cut (``act_kv_seq``: over
    ``data`` for the ``long_500k`` cells) holds the rank's columns
    (:func:`seq_cut`); attention runs K3 over them with its log-sum-exp
    and merges the ranks' partials over that axis's group (one
    ``all_gather``). MLA's latent cache is cut alike; where its cut and
    the query heads share the model axis, a rank holds the up-projection
    ``wkv_b`` whole (:func:`latent_up_whole`), gathers the queries and
    runs every head over its own columns.
  * **experts** (training only): a rank holds its experts' slice of the
    MoE banks, runs them on its experts' slots of the dispatch buffer and
    sums its part of the combine over the model group
    (:func:`expert_slice`, ``models/layers.py::moe``).
  * **sequence parallelism** (the rules put ``act_seq`` on the model
    axis, :func:`seq_parallel`): the residual stream between blocks is
    the rank's contiguous 1/mp of the sequence. A block gathers its
    normed input over the sequence (:func:`seq_gather`: an
    ``all_gather``, whose backward reduce-scatters), runs its interior as
    above on every row, and returns the rank's rows: a row-parallel
    output is reduce-scattered over the sequence (:func:`sum_to_rows`,
    whose backward all-gathers), a whole weight's output is cut to the
    rank's rows (:func:`rows`). Inside a block each rank's gradient of a
    replicated activation is then its share, which the gather's
    reduce-scatter sums, so :func:`to_ranks` sums nothing there; a leaf
    that every rank holds whole gets the gradient of the rank's rows,
    which the train step sums over the model group
    (``launch/steps.py``).
  * **gathers**, where a sharded output meets an unsharded consumer: the
    LM head's vocab slice before sampling, a Q/K/V projection whose
    columns shard while attention stays replicated (:func:`conform_heads`)
    and the vocab-sharded embedding table. A gather is an ``all_reduce``
    of a zero-filled buffer into which each rank wrote its own slice:
    adding zeros is exact.

Every collective is an ``all_reduce`` (a sum, or the max that the
vocab-parallel loss takes of its rows), a ``broadcast``, an
``all_gather`` or a ``reduce_scatter`` (FSDP's, ``distributed/fsdp.py``):
gloo runs each on CUDA tensors as on CPU ones (torch 2.11 on the H100,
``scripts/torch_gloo_probe.py``). Each counts its calls and the bytes of
its result in :data:`collectives`, as the reference counts the result
shapes of its HLO's collectives (``repro/roofline/analysis.py``): the
whole tensor for an all-reduce and an all-gather, the rank's part for a
reduce-scatter; also by the axes of the mesh's group it went over
(:meth:`Collectives.by_axes`). Nothing gives way to a single-rank path: a
collective that fails raises. Over an abstract mesh's group
(``launch/mesh.py::Mesh.abstract``) a collective of ``meta`` tensors is
counted and returns without calling ``torch.distributed`` (the dry run);
any other tensor there raises, and so does a ``meta`` tensor over a real
group.

Training runs the same call sites under autograd: the collectives are
``torch.autograd.Function`` s (:class:`_SumOverRanks`, :class:`_ToRanks`,
:class:`_Gather`, :class:`_SeqGather`, :class:`_SeqScatter`) whose
backward is the collective a rank's gradient needs, issued through the
counted functions above.

Without a context, or with a model axis of 1, every wrapper is the plain
``api`` call, so the model code routes through this module unconditionally.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import api
from repro_torch.core.plan import PackedWeight, QuantizedPackedWeight, \
    ShardingPolicy
from repro_torch.distributed.sharding import ShardingRules, cache_spec
from repro_torch.kernels.forward_only import needs_grad
from repro_torch.launch.mesh import AbstractGroup
from repro_torch.models.module import is_axis_leaf

__all__ = [
    "TPContext", "make_context", "use_tp", "current_tp", "head_sharding",
    "kv_group_slice", "take_kv_heads",
    "linear", "matmul", "attention", "embed", "conform_heads",
    "param_cut", "shard_params", "unshard_params", "shard_caches",
    "SeqCut", "seq_cut", "seq_group", "cut_attention", "merge_partials",
    "merge_stack", "latent_up_whole",
    "seq_parallel", "with_seq_parallel", "seq_gather", "sum_to_rows",
    "rows", "row_mask", "row_mean",
    "head_units", "all_reduce",
    "all_reduce_max", "all_gather", "reduce_scatter", "broadcast", "gather",
    "on_slice", "to_ranks", "sum_over_ranks", "expert_slice",
    "collectives", "vocab_parallel_nll",
]


# ---------------------------------------------------------------------------
# Counted collectives
# ---------------------------------------------------------------------------

class Collectives:
    """Calls and bytes of every collective issued, by kind."""

    KINDS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {k: 0 for k in self.KINDS}
        self.bytes = {k: 0 for k in self.KINDS}
        self._by_group: Dict[Tuple[str, Any], Dict[str, int]] = {}

    def add(self, kind: str, t: torch.Tensor, group) -> None:
        n = t.numel() * t.element_size()
        self.calls[kind] += 1
        self.bytes[kind] += n
        tally = self._by_group.setdefault((kind, group),
                                          {"calls": 0, "bytes": 0})
        tally["calls"] += 1
        tally["bytes"] += n

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}

    def by_axes(self, mesh) -> Dict[str, Dict[str, int]]:
        """Calls and bytes by ``"kind:axes"``, the axes of ``mesh``'s group
        each went over (``Mesh.axes_of``: "pod", "pod+data", ...)."""
        out: Dict[str, Dict[str, int]] = {}
        for (kind, group), v in self._by_group.items():
            axes = mesh.axes_of(group) if mesh is not None else None
            tally = out.setdefault(f"{kind}:{axes}", {"calls": 0, "bytes": 0})
            for k in tally:
                tally[k] += v[k]
        return out


collectives = Collectives()


def _group_size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, AbstractGroup):
        return group.size()
    return dist.get_world_size(group)


def _is_real(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` over ``group`` goes to
    ``torch.distributed``: not over an abstract group, where it is only
    counted and only ``meta`` tensors may come; a ``meta`` tensor never
    reaches a real group of more than one rank."""
    abstract = isinstance(group, AbstractGroup)
    if abstract and t.device.type != "meta":
        raise ValueError(f"a {t.device.type} tensor under an abstract mesh: "
                         f"Mesh.abstract counts collectives of meta tensors "
                         f"only (launch/dryrun.py)")
    if not abstract and t.device.type == "meta" and _group_size(group) > 1:
        raise ValueError("a meta tensor cannot reach torch.distributed: run "
                         "the dry run under Mesh.abstract")
    return not abstract


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a no-op on a group of one): in place
    when ``t`` is contiguous, else into a contiguous copy — a strided view
    (a GEMM's output cut from its padded tiles) would be reduced wrongly.
    Use the returned tensor."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, as :func:`all_reduce`
    (counted as an all-reduce); no gradient flows through it."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    real = _is_real(t, group)
    if _group_size(group) > 1:
        t = t.contiguous()
        collectives.add("all_reduce", t, group)
        if real:
            dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in the
    group's rank order (``t`` itself on a group of one)."""
    n = _group_size(group)
    real = _is_real(t, group)
    if n == 1:
        return t
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    collectives.add("all_gather", out, group)
    if real:
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n along ``dim`` of ``t`` summed over ``group`` (n
    ranks; the group's rank order gives the chunks): the sum of an
    :func:`all_reduce`, cut as :func:`shard_dim` cuts it, with 1/n of its
    result moved. ``t`` itself on a group of one."""
    n = _group_size(group)
    real = _is_real(t, group)
    if n == 1:
        return t
    dim = dim % t.dim()
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide over {n} ranks")
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    collectives.add("reduce_scatter", out, group)
    if real:
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``; ``t``
    must be contiguous (it is received in place)."""
    real = _is_real(t, group)
    if _group_size(group) > 1:
        if not t.is_contiguous():
            raise ValueError("broadcast receives in place: pass a "
                             "contiguous tensor")
        collectives.add("broadcast", t, group)
        if real:
            dist.broadcast(t, src=src, group=group)
    return t


# ---------------------------------------------------------------------------
# The collectives under autograd
# ---------------------------------------------------------------------------

def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that a collective may reduce in place (autograd
    may hand the same gradient buffer to two consumers)."""
    return t.clone(memory_format=torch.contiguous_format)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce forward, identity backward: a row-parallel partial
    product or the vocab-parallel embedding's rows, summed over the model
    group. The sum is replicated, so every rank gets the same gradient of
    it, which is the gradient of its own part."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(_fresh(t), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToRanks(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated input that each
    rank consumes only in part (a column-parallel GEMM's x, a whole tensor
    cut to the rank's slice). Each rank's gradient of it is partial; their
    sum is the gradient of the replicated input."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_fresh(g), ctx.group), None


class _Gather(torch.autograd.Function):
    """The exact gather of :func:`gather` forward; backward, the rank's
    slice of the (replicated, so identical) gradient of the whole — under
    sequence parallelism each rank's gradient of the whole is its share,
    so the shares are summed first."""

    @staticmethod
    def forward(ctx, t, dim, full, ctx_tp, blocks):
        ctx.cut = (dim, ctx_tp.rank, ctx_tp.model_size, blocks)
        ctx.group = ctx_tp.group if ctx_tp.seq_parallel else None
        return _gather(t, dim, full, ctx_tp, blocks)

    @staticmethod
    def backward(ctx, g):
        if ctx.group is not None:
            g = all_reduce(_fresh(g), ctx.group)
        return shard_dim(g, *ctx.cut), None, None, None, None


class _SeqGather(torch.autograd.Function):
    """All-gather over the sequence (dim 1) forward, reduce-scatter
    backward: the rank's rows of the residual stream, whole for a block's
    interior; each rank's gradient of the whole is its share."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather(t, 1, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, 1, ctx.group), None


class _SeqScatter(torch.autograd.Function):
    """Reduce-scatter over the sequence (dim 1) forward, all-gather
    backward: a rank's partial sum over every row (a row-parallel
    product) to the rank's rows of the sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return reduce_scatter(t, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 1, ctx.group), None


def _sum_over_ranks(t: torch.Tensor, group) -> torch.Tensor:
    return _SumOverRanks.apply(t, group) if needs_grad(t) \
        else all_reduce(t, group)


def _to_ranks(t: torch.Tensor, ctx: "TPContext") -> torch.Tensor:
    if ctx.seq_parallel or not needs_grad(t):
        return t        # each rank's gradient stays its share (SP)
    return _ToRanks.apply(t, ctx.group)


def to_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t``, replicated over the active context's model group, as an
    input that each rank consumes only in part: identity forward, its
    gradient summed over the group backward (:class:`_ToRanks`); ``t``
    itself without an active model axis, and under sequence parallelism,
    where a block's gradients are each rank's share until the gather that
    began it sums them."""
    ctx = current_tp()
    return _to_ranks(t, ctx) if _active(ctx) else t


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t``, a rank's part of a sum, summed over the active context's
    model group: all-reduce forward, identity backward
    (:class:`_SumOverRanks`); ``t`` itself without an active model
    axis."""
    ctx = current_tp()
    return _sum_over_ranks(t, ctx.group) if _active(ctx) else t


def expert_slice(n_experts: int, held: int) -> Tuple[int, int]:
    """(first, count) of the experts whose banks this rank holds, ``held``
    of the ``n_experts``: all of them where the banks are whole (no active
    model axis, serving, or experts that do not divide the model axis);
    the rank's contiguous 1/mp under expert parallelism
    (:func:`shard_params` with ``experts=True``)."""
    if held == n_experts:
        return 0, n_experts
    ctx = current_tp()
    if not _active(ctx) or held * ctx.model_size != n_experts:
        raise ValueError(f"tp: an expert bank of {held} experts is neither "
                         f"all {n_experts} nor this rank's slice of them")
    return ctx.rank * held, held


def on_slice(params, sliced: bool):
    """``params`` (a dict of replicated tensors: a q/k norm) as used on
    the rank's slice of the heads when ``sliced``: each rank's gradient of
    them then covers its heads only, and the backward sums it over the
    model group (:class:`_ToRanks`), so every rank gets the whole one."""
    if not sliced:
        return params
    return {k: to_ranks(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TPContext:
    """A mesh and its resolved sharding rules, carried thread-local
    (:func:`use_tp`)."""

    mesh: Any
    rules: ShardingRules
    policy: ShardingPolicy
    # the residual stream is the rank's rows of the sequence: set for one
    # forward by ``transformer.forward`` (:func:`with_seq_parallel`)
    seq_parallel: bool = False

    @property
    def model_axis(self) -> str:
        return self.policy.model_axis

    @property
    def data_axis(self) -> str:
        return self.policy.data_axis

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape.get(self.model_axis, 1))

    @property
    def rank(self) -> int:
        """This rank's coordinate on the model axis."""
        return int(self.mesh.coords.get(self.model_axis, 0))

    @property
    def group(self):
        return self.mesh.group(self.model_axis)

    def wants_model(self, logical: Optional[str]) -> bool:
        """True when the rule for ``logical`` resolves to the model axis."""
        if logical is None:
            return False
        axes = self.rules._resolve(self.rules.rules.get(logical))
        if axes is None:
            return False
        axes = (axes,) if isinstance(axes, str) else axes
        return self.model_axis in axes


def make_context(mesh, policy: Optional[ShardingPolicy] = None,
                 overrides: Optional[Dict[str, Any]] = None
                 ) -> Optional[TPContext]:
    """A TPContext (None mesh → None, the single-device no-op).
    ``overrides`` layer on top of the policy's own (model configs pass
    ``cfg.overrides_dict()`` — e.g. smollm pins heads replicated)."""
    if mesh is None:
        return None
    policy = policy if policy is not None else ShardingPolicy()
    merged = policy.overrides_dict()
    if overrides:
        merged.update(overrides)
    return TPContext(mesh=mesh, rules=ShardingRules(mesh, merged),
                     policy=policy)


_state = threading.local()


def current_tp() -> Optional[TPContext]:
    return getattr(_state, "tp", None)


@contextlib.contextmanager
def use_tp(ctx: Optional[TPContext]):
    """Pin the active TP context for the enclosed region (thread-local)."""
    prev = getattr(_state, "tp", None)
    _state.tp = ctx
    try:
        yield ctx
    finally:
        _state.tp = prev


def _active(ctx: Optional[TPContext]) -> bool:
    return ctx is not None and ctx.model_size > 1


# ---------------------------------------------------------------------------
# Sequence parallelism (act_seq over the model axis)
# ---------------------------------------------------------------------------

def seq_parallel(ctx: Optional[TPContext], S: int, B: int = 1,
                 D: int = 1) -> bool:
    """Whether the rules cut a (B, S, D) residual stream's sequence over
    the model axis: ``ctx.rules.spec(("act_batch", "act_seq",
    "act_embed"), (B, S, D))`` names it for the sequence — so a sequence
    that does not divide (decode's S = 1) stays whole, as the spec's
    fallback keeps it. A sequence cut over another axis raises."""
    if not _active(ctx):
        return False
    axes = ctx.rules.spec(("act_batch", "act_seq", "act_embed"),
                          (B, S, D))[1]
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    if axes and axes != (ctx.model_axis,):
        raise NotImplementedError(
            f"act_seq -> {axes}: the port cuts the sequence over the model "
            f"axis alone (the reference's seqpar arm)")
    return bool(axes)


def with_seq_parallel(ctx: TPContext) -> TPContext:
    """``ctx`` for a forward whose residual stream is the rank's rows."""
    return dataclasses.replace(ctx, seq_parallel=True)


def _sp() -> Optional[TPContext]:
    ctx = current_tp()
    return ctx if ctx is not None and ctx.seq_parallel else None


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence (dim 1) of the residual stream from the rank's
    rows under sequence parallelism (:class:`_SeqGather`); ``x`` itself
    otherwise."""
    ctx = _sp()
    if ctx is None:
        return x
    if needs_grad(x):
        return _SeqGather.apply(x, ctx.group)
    return all_gather(x, 1, ctx.group)


def sum_to_rows(t: torch.Tensor) -> torch.Tensor:
    """A rank's part of a sum over the model group, (B, S, ...) over every
    row, as the residual stream holds it: the rank's rows of the sum under
    sequence parallelism (a reduce-scatter over the sequence,
    :class:`_SeqScatter`), else the whole sum (an all-reduce)."""
    ctx = current_tp()
    if not _active(ctx):
        return t
    if not ctx.seq_parallel:
        return _sum_over_ranks(t, ctx.group)
    if needs_grad(t):
        return _SeqScatter.apply(t, ctx.group)
    return reduce_scatter(t, 1, ctx.group)


def rows(t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a whole (B, S, ...) tensor that every rank
    computed alike, under sequence parallelism (no collective; the
    gradient of the other rows is zero here, and theirs on their ranks);
    ``t`` itself otherwise."""
    ctx = _sp()
    if ctx is None:
        return t
    return shard_dim(t, 1, ctx.rank, ctx.model_size)


def row_mask(S: int, device) -> torch.Tensor:
    """(S,) True on the rank's rows of a sequence of S cut over the
    active context's model axis."""
    ctx = current_tp()
    n = S // ctx.model_size
    j = torch.arange(S, device=device)
    return (j >= ctx.rank * n) & (j < (ctx.rank + 1) * n)


def row_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over dims (0, 1) of a whole (B, S, ...) tensor that every
    rank computed alike. Under sequence parallelism it is the sum of the
    ranks' sums over their own rows (an all-reduce, identity backward), so
    each rank's gradient reaches only its rows, as a block's gradients
    are each rank's share."""
    ctx = _sp()
    if ctx is None:
        return t.mean(dim=(0, 1))
    n = t.shape[0] * t.shape[1]
    return _sum_over_ranks(rows(t).sum(dim=(0, 1)), ctx.group) / n



# ---------------------------------------------------------------------------
# Sharding decisions and slices
# ---------------------------------------------------------------------------

def head_sharding(ctx: Optional[TPContext], H: int, Hkv: int
                  ) -> Tuple[bool, bool]:
    """(shard_q, shard_kv) over the model axis for an (H, Hkv) layer.

    Both shard when both divide the model-axis size (rep = H/Hkv is then
    preserved per shard). Query heads shard alone only for MQA (Hkv == 1):
    the kernels compute the GQA grouping from local shapes, so a GQA query
    slice over replicated KV heads would regroup wrongly — replicate
    instead.
    """
    if ctx is None:
        return False, False
    mp = ctx.model_size
    if mp <= 1 or not ctx.wants_model("heads") or H % mp:
        return False, False
    if H == Hkv:
        return True, True         # MHA/MLA: one head set, one rule
    if ctx.wants_model("kv_heads") and Hkv % mp == 0:
        return True, True
    if Hkv == 1:
        return True, False        # MQA replication fallback
    return False, False


def kv_group_slice(ctx: Optional[TPContext], H: int, Hkv: int
                   ) -> Optional[Tuple[int, int]]:
    """(first, count) of the KV heads that this rank's query heads read,
    where :func:`head_sharding` keeps a GQA layer's attention replicated
    because its KV heads do not shard (a config pins them, as qwen3-8b's
    ``kv_heads`` override does), but the query heads do and each rank's
    query slice covers whole groups or lies inside one; else None. A
    cache-less attention (training) then runs on the rank's query heads
    over that slice of the replicated K/V, as GSPMD places the reference's
    activations (``act_heads`` over model): the grouping the kernels
    compute from local shapes is the global one. Cached attention stays
    replicated: its caches hold every KV head."""
    if ctx is None or head_sharding(ctx, H, Hkv) != (False, False):
        return None
    mp = ctx.model_size
    if mp <= 1 or not ctx.wants_model("heads") or H % mp or H == Hkv:
        return None
    per, rep = H // mp, H // Hkv
    if per % rep == 0:
        return ctx.rank * (per // rep), per // rep
    if rep % per == 0:
        return ctx.rank * per // rep, 1
    return None


def take_kv_heads(t: torch.Tensor, kv_slice: Tuple[int, int]
                  ) -> torch.Tensor:
    """KV heads ``kv_slice`` (:func:`kv_group_slice`) of the replicated
    ``t`` (B, S, Hkv, D): each rank's gradient of ``t`` covers its slice,
    and the backward sums it over the model group (:class:`_ToRanks`)."""
    first, n = kv_slice
    return to_ranks(t).narrow(2, first, n) \
        .clone(memory_format=torch.contiguous_format)


def param_cut(ctx: TPContext, names: Sequence[Optional[str]],
              shape: Sequence[int], units: Optional[Dict[str, int]] = None,
              blocks: int = 1) -> Optional[Tuple[int, int]]:
    """(dim, blocks) of the one dim of a weight, bias or table (logical
    ``names``, global ``shape``) of which each rank holds a slice, or None:
    the one place that decides what :func:`shard_params` keeps and what
    :func:`linear` and :func:`embed` take.

    The dim is the one whose :meth:`ShardingRules.spec` names the model
    axis — so the reference's sharding trees (``launch/steps.py``) and the
    ranks agree on the dim — with two refinements that a rank needs and
    GSPMD does not, since no rank can reshard its neighbour's slice:

      * ``units`` maps a name to its count of indivisible groups (whole
        heads): a dim whose groups do not divide over the model axis stays
        whole (MQA's single KV head, which the spec splits by columns);
      * ``blocks`` > 1 cuts each of the last dim's equal blocks alike
        (SwiGLU's gate ‖ up: the rank holds its chunk of the gate and the
        same chunk of the up, where the spec's contiguous halves would give
        one rank the gate and the other the up), and every block must
        divide.
    """
    spec = ctx.rules.spec(tuple(names), tuple(shape))
    mp = ctx.model_size
    for d, axes in enumerate(spec):
        if ctx.model_axis not in ((axes,) if isinstance(axes, str)
                                  else (axes or ())):
            continue
        b = blocks if d == len(shape) - 1 else 1
        u = (units or {}).get(names[d])
        if shape[d] % (mp * b) or (u is not None and u % mp):
            return None
        return d, b
    return None


def shard_dim(t: torch.Tensor, dim: int, rank: int, n: int,
              blocks: int = 1) -> torch.Tensor:
    """Rank ``rank``'s 1/n of dim ``dim`` of ``t``: the same chunk of each
    of its ``blocks`` equal blocks (one contiguous chunk when 1), in a
    tensor of its own — never a view that would keep all of ``t``
    alive."""
    dim = dim % t.dim()
    size = t.shape[dim]
    chunk = size // (blocks * n)
    parts = [t.narrow(dim, b * (size // blocks) + rank * chunk, chunk)
             for b in range(blocks)]
    if blocks > 1:
        return torch.cat(parts, dim)
    return parts[0].clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, dim: int, full: int, ctx: TPContext,
           blocks: int = 1) -> torch.Tensor:
    """The whole of dim ``dim`` (``full`` wide) from every rank's slice of
    it (:func:`shard_dim`'s layout): an all-reduce of a zero-filled buffer
    into which this rank wrote its own slice. Under autograd the gradient
    of a rank's slice is its slice of the whole's (:class:`_Gather`)."""
    if needs_grad(t):
        return _Gather.apply(t, dim % t.dim(), full, ctx, blocks)
    return _gather(t, dim, full, ctx, blocks)


def _gather(t: torch.Tensor, dim: int, full: int, ctx: TPContext,
            blocks: int = 1) -> torch.Tensor:
    dim = dim % t.dim()
    shape = list(t.shape)
    shape[dim] = full
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    chunk = t.shape[dim] // blocks
    for b in range(blocks):
        buf.narrow(dim, b * (full // blocks) + ctx.rank * chunk,
                   chunk).copy_(t.narrow(dim, b * chunk, chunk))
    return all_reduce(buf, ctx.group)


def conform_heads(t: torch.Tensor, n_heads: int, local: bool
                  ) -> torch.Tensor:
    """Bring the head dim (axis 2) of ``t`` — the rank's slice or all
    ``n_heads`` — to what its consumer takes: the rank's slice when
    ``local``, else all heads (gathered)."""
    ctx = current_tp()
    if not _active(ctx) or (t.shape[2] == n_heads) != local:
        return t
    if local:
        return shard_dim(_to_ranks(t, ctx), 2, ctx.rank, ctx.model_size)
    return gather(t, 2, n_heads, ctx)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor, dim: int, full: int, ctx: TPContext,
           what: str) -> torch.Tensor:
    """``t`` itself when dim ``dim`` is the rank's slice of ``full``;
    raises for anything else — a whole operand would be cut by a copy on
    every call."""
    if t.shape[dim] * ctx.model_size != full:
        raise ValueError(
            f"tp: the {what} is {tuple(t.shape)}, not this rank's slice of "
            f"the {full} wide dim {dim}; hold the rank's params "
            f"(tp.shard_params) and caches (init_*caches(tpctx=))")
    return t


def linear(x: torch.Tensor, w, bias=None, *,
           axes: Sequence[Optional[str]],
           full: Tuple[int, int],
           units: Optional[int] = None,
           blocks: int = 1,
           gather_out: bool = False,
           seq_out: bool = False,
           policy=None) -> torch.Tensor:
    """y = x @ w (+ bias) over the active TP context.

    ``axes`` are the weight's logical axis names and ``full`` its global
    (K, N); :func:`param_cut` decides which dim shards (``units`` bounds
    the split to whole head groups, ``blocks`` splits each of N's equal
    blocks alike). ``w`` and ``bias`` are what this rank holds
    (:func:`shard_params`) — a whole weight on a sharded dim raises. N
    sharded → column-parallel: the rank's output columns (gathered whole
    with ``gather_out``). K sharded → row-parallel: the partial product of
    the rank's slice of x (cut here when x is whole — attention that stays
    replicated) in fp32 (int32 for integer operands), summed over the
    model group, then cast, then the bias once. Falls back to
    :func:`api.linear` with no context, a model axis of 1, a packed
    weight, a weight that is not 2-D, or no dim to shard.

    ``seq_out``: y is a block's output to the residual stream, (B, S, N)
    over the whole sequence. Under sequence parallelism it comes back as
    the rank's rows: a row-parallel product's partial sums reduce-scattered
    over the sequence (:func:`sum_to_rows`), a whole weight's product cut
    to them (:func:`rows`); x is then already the whole sequence (the
    block gathered it).
    """
    ctx = current_tp()
    if (not _active(ctx)
            or isinstance(w, (PackedWeight, QuantizedPackedWeight))
            or getattr(w, "ndim", 0) != 2):
        y = api.linear(x, w, bias, policy=policy)
        return rows(y) if seq_out else y
    K, N = full
    cut = param_cut(ctx, axes, full,
                    None if units is None else dict.fromkeys(axes, units),
                    blocks)

    if cut is not None and cut[0] == 1:
        # column parallel: the full-K contraction of the rank's columns
        if seq_out and ctx.seq_parallel:
            raise ValueError("tp: a column-parallel output is no block's "
                             "output to the residual stream")
        w = _local(w, 1, N, ctx, "weight")
        if bias is not None:
            bias = _local(bias, 0, N, ctx, "bias")
        y = api.linear(_to_ranks(x, ctx), w, bias, policy=policy)
        return gather(y, -1, N, ctx, blocks) if gather_out else y

    if cut is not None:
        # row parallel: partial products summed in fp32 before the cast
        if ctx.seq_parallel and not seq_out:
            raise ValueError("tp: under sequence parallelism a row-parallel "
                             "product is a block's output (seq_out)")
        w = _local(w, 0, K, ctx, "weight")
        if x.shape[-1] == K:
            x = shard_dim(_to_ranks(x, ctx), -1, ctx.rank, ctx.model_size)
        x = _local(x, -1, K, ctx, "input")
        out_dtype = torch.promote_types(x.dtype, w.dtype)
        acc = torch.float32 if out_dtype.is_floating_point else None
        y = sum_to_rows(api.matmul(x, w, policy=policy, out_dtype=acc))
        if acc is not None:
            y = y.to(out_dtype)
        return y if bias is None else y + bias

    if tuple(w.shape) != (K, N):
        raise ValueError(f"tp: a replicated weight is whole: got "
                         f"{tuple(w.shape)} for {(K, N)}")
    y = api.linear(x, w, bias, policy=policy)
    return rows(y) if seq_out else y


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           axes: Sequence[Optional[str]],
           full: Tuple[int, int],
           units: Optional[int] = None,
           policy=None) -> torch.Tensor:
    """Bias-less :func:`linear`."""
    return linear(a, b, None, axes=axes, full=full, units=units,
                  policy=policy)


def embed(table: torch.Tensor, tokens: torch.Tensor, *, vocab: int,
          prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[tokens]`` (B, S, D) for a ``("vocab", "embed")`` table of
    ``vocab`` rows, as this rank holds it, after ``prefix`` (B, S_e, D)
    columns when given (the VLM's image embeddings): with the vocab
    sharded, each rank looks up the tokens of its slice, zeros elsewhere,
    and an all-reduce sums the rows — exact, every row comes from one
    rank. Under sequence parallelism the result is the rank's rows of the
    sequence: the sum is a reduce-scatter over it (the prefix added on the
    model group's first rank alone), and a whole table's lookup is cut to
    them (:func:`rows`)."""
    ctx = current_tp()
    if not _active(ctx) or param_cut(
            ctx, ("vocab", "embed"), (vocab, table.shape[1])) is None:
        out = table[tokens]
        if prefix is not None:
            out = torch.cat([prefix.to(out.dtype), out], dim=1)
        return rows(out)
    n = _local(table, 0, vocab, ctx, "embedding table").shape[0]
    local = tokens - ctx.rank * n
    inside = (local >= 0) & (local < n)
    found = table[local.clamp(0, n - 1)]
    found = torch.where(inside[..., None], found, torch.zeros_like(found))
    if prefix is None:
        return sum_to_rows(found)
    if not ctx.seq_parallel:
        return torch.cat([prefix.to(found.dtype), sum_to_rows(found)], dim=1)
    prefix = prefix.to(found.dtype)
    if ctx.rank:
        prefix = torch.zeros_like(prefix)
    return sum_to_rows(torch.cat([prefix, found], dim=1))


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """-log softmax(logits)[label] in fp32, each rank of the model group
    holding its contiguous slice of the vocab columns (the column-parallel
    head's output, ``linear(..., gather_out=False)``): the row max over
    the group (an all-reduce max, detached: the loss does not depend on
    the shift), the sum of ``exp`` over the group (an all-reduce under
    autograd), and the label's logit from the rank whose slice holds it
    (masked to the rank's range, then summed over the group). The
    whole-vocab logits are never formed."""
    ctx = current_tp()
    lg = logits.float()
    n = lg.shape[-1]
    m = all_reduce_max(lg.detach().amax(dim=-1), ctx.group)
    z = lg - m[..., None]
    sumexp = _sum_over_ranks(torch.exp(z).sum(dim=-1), ctx.group)
    local = labels.long() - ctx.rank * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(z, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = _sum_over_ranks(
        torch.where(inside, picked, torch.zeros_like(picked)), ctx.group)
    return (torch.log(sumexp) - picked)[..., None]


# ---------------------------------------------------------------------------
# Attention (heads over model; per-rank paged pools)
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, kv_valid_len: torch.Tensor,
              heads: Tuple[int, int],
              causal: bool = True, scale: Optional[float] = None,
              soft_cap: Optional[float] = None,
              block_tables: Optional[torch.Tensor] = None,
              kv_scales=None,
              kv_slice: Optional[Tuple[int, int]] = None,
              seq_offset: Optional[torch.Tensor] = None,
              policy=None) -> torch.Tensor:
    """api.attention with heads sharded over the model axis and, with
    ``seq_offset``, keys cut over the sequence.

    q is (B, Sq, H, D); k/v are dense (B, T, Hkv, D) or, with
    ``block_tables``, page pools (P, page_size, Hkv, D): the head dim is
    axis 2 either way. ``heads`` is the layer's global (H, Hkv). Where
    :func:`head_sharding` shards them, q, k, v and an int8 pool's
    ``kv_scales`` ((P, Hkv) each, heads last) are the rank's slices
    (:func:`conform_heads`, ``init_*caches(tpctx=)``), else whole; anything
    else raises. With ``kv_slice`` (:func:`kv_group_slice`: a cache-less
    GQA layer whose KV heads stay replicated) q is the rank's query heads
    and k/v the KV heads of its groups. The output holds the rank's query
    heads when they shard, else all of them.

    ``seq_offset`` (the 0-d ``seq_offset`` of a cache cut by
    :func:`seq_cut`) says that k/v hold the rank's columns ``[offset,
    offset + T/n)`` of the T: :func:`cut_attention` over the group of the
    axes that cut the cache (:func:`seq_group`).
    """
    ctx = current_tp()
    H, Hkv = heads
    shard_q, shard_kv = head_sharding(ctx, H, Hkv)
    if kv_slice is not None:
        shard_q = True
        if k.shape[2] != kv_slice[1] or v.shape[2] != kv_slice[1]:
            raise ValueError(f"tp: attention over KV heads {kv_slice} got "
                             f"{k.shape[2]} / {v.shape[2]} heads")
    if shard_q:
        _local(q, 2, H, ctx, "query")
    elif q.shape[2] != H:
        raise ValueError(f"tp: attention over all {H} heads got "
                         f"{q.shape[2]} query heads")
    for t, what in ((k, "key"), (v, "value")) if kv_slice is None else ():
        if shard_kv:
            _local(t, 2, Hkv, ctx, what)
        elif t.shape[2] != Hkv:
            raise ValueError(f"tp: attention over all {Hkv} KV heads got "
                             f"{t.shape[2]} {what} heads")
    if shard_kv and kv_scales is not None:
        for s in kv_scales:
            _local(s, -1, Hkv, ctx, "int8 pool scale")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if seq_offset is None:
        return api.attention(q, k, v, q_positions=q_positions,
                             kv_valid_len=kv_valid_len, causal=causal,
                             scale=scale, soft_cap=soft_cap,
                             block_tables=block_tables, kv_scales=kv_scales,
                             policy=policy)
    if block_tables is not None:
        raise ValueError("tp: page pools are never cut over the sequence")
    group = seq_group(ctx, "k", (k.shape[0], k.shape[1], Hkv, k.shape[3]))
    return cut_attention(q, k, v, q_positions=q_positions,
                         kv_valid_len=kv_valid_len, seq_offset=seq_offset,
                         group=group, causal=causal, scale=scale,
                         soft_cap=soft_cap, policy=policy)


def cut_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, kv_valid_len: torch.Tensor,
                  seq_offset: torch.Tensor, group, causal: bool = True,
                  scale: Optional[float] = None,
                  soft_cap: Optional[float] = None,
                  policy=None) -> torch.Tensor:
    """Attention of q over every rank's keys, from the rank's columns of
    a cache cut over the sequence: k/v (B, T/n, Hkv, D) hold the columns
    ``[offset, offset + T/n)`` (``seq_offset``, 0-d), ``kv_valid_len`` and
    ``q_positions`` are global. Attention runs over the rank's columns
    with the local valid length ``clamp(len - offset, 0, T/n)`` and
    positions ``q_pos - offset`` (all on the device), returning its
    log-sum-exp, and the ranks' partials merge over ``group``
    (:func:`merge_partials`). The heads are whatever q, k and v hold."""
    cols = k.shape[1]
    off = seq_offset.to(kv_valid_len.dtype)
    local_len = torch.clamp(kv_valid_len - off, 0, cols)
    local_pos = q_positions - seq_offset.to(q_positions.dtype)
    out, lse = api.attention(q, k, v, q_positions=local_pos,
                             kv_valid_len=local_len, causal=causal,
                             scale=scale, soft_cap=soft_cap, policy=policy,
                             return_lse=True)
    return merge_partials(out, lse, group)


# ---------------------------------------------------------------------------
# Placement: each rank keeps its own slice
# ---------------------------------------------------------------------------

def head_units(cfg) -> Dict[str, int]:
    """The indivisible groups of a config's head dims: whole heads."""
    return {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads}


_WHOLE_SUBTREES = ("ssd",)   # models/ssm.py runs its params whole
_LATENT_UP = "wkv_b"         # MLA's up-projection of the latent cache


def latent_up_whole(ctx: Optional[TPContext]) -> bool:
    """Whether a rank holds MLA's up-projection ``wkv_b`` whole: the rules
    cut the latent cache's sequence (``act_kv_seq``) over the model axis,
    which the query heads take too, so each rank up-projects every head
    over its own columns (``models/layers.py::mla_attention``). The
    reference's GSPMD placement keeps it cut by heads."""
    return _active(ctx) and ctx.wants_model("act_kv_seq")


def _whole_keys(ctx: TPContext) -> Tuple[str, ...]:
    """The param keys whose subtree a rank holds whole."""
    return _WHOLE_SUBTREES + ((_LATENT_UP,) if latent_up_whole(ctx)
                              else ())


def _cut_bank(axes, experts: bool) -> bool:
    """Whether a leaf of three or more dims is an MoE expert bank that
    expert parallelism cuts (its first logical axis ``experts``)."""
    return experts and tuple(axes)[0] == "experts"


def shard_params(params, axes_tree, ctx: Optional[TPContext], *,
                 units: Optional[Dict[str, int]] = None, shapes=None,
                 experts: bool = False):
    """The rank's params: every model-sharded dim of a weight, bias or the
    embedding table cut to the rank's slice (:func:`shard_dim`), the rest
    kept whole. ``units`` maps a logical name to its count of indivisible
    groups (``{"heads": H, "kv_heads": Hkv}``), as :func:`linear`'s call
    sites bound their splits. ``shapes`` is the tree of the global params
    (default ``params``: they are whole; meta tensors will do), so a
    tree that is already the rank's slice comes back as it is. Tensors of
    three or more dims (audio's per-codebook tables) and the SSD blocks'
    params stay whole: no TP call site consumes them, as in the
    reference, whose ``tp.linear`` passes any weight with ``ndim != 2``
    to the unsharded path. The MoE expert banks stay whole too (the
    reference's TP serving runs them unsharded) unless ``experts``: then
    a rank holds its experts' slice of each bank where the rules put
    ``experts`` on the model axis and it divides them (expert
    parallelism, a training placement: ``launch/steps.py::rank_params``;
    ``models/layers.py::moe``)."""
    if not _active(ctx):
        return params
    units = units or {}
    mp, r = ctx.model_size, ctx.rank
    whole_keys = _whole_keys(ctx)

    def rec(p, a, full, whole):
        if is_axis_leaf(a):
            if whole or (p.dim() > 2 and not _cut_bank(a, experts)):
                return p
            cut = param_cut(ctx, tuple(a), tuple(full.shape), units,
                            getattr(a, "blocks", 1))
            if cut is None:
                return p
            d, blocks = cut
            if p.shape[d] == full.shape[d]:
                return shard_dim(p, d, r, mp, blocks)
            if p.shape[d] * mp != full.shape[d]:
                raise ValueError(
                    f"a {tuple(p.shape)} param is neither the whole "
                    f"{tuple(full.shape)} nor its rank slice over {mp}")
            return p
        if isinstance(a, dict):
            return {k: rec(p[k], v, full[k], whole or k in whole_keys)
                    for k, v in a.items()}
        return [rec(pi, ai, fi, whole) for pi, ai, fi in zip(p, a, full)]

    return rec(params, axes_tree, params if shapes is None else shapes,
               False)


def unshard_params(params, axes_tree, ctx: Optional[TPContext], *,
                   units: Optional[Dict[str, int]] = None, shapes,
                   experts: bool = False):
    """The inverse of :func:`shard_params` (``experts`` as there): every
    leaf that a rank holds a slice of gathered whole over the model group
    (:func:`gather`, without autograd), the others as they are.
    ``shapes`` is the tree of the global params (meta tensors will do).
    Every rank of the group must call it (checkpoints,
    ``launch/steps.py::full_state``)."""
    if not _active(ctx):
        return params
    units = units or {}
    whole_keys = _whole_keys(ctx)

    def rec(p, a, full, whole):
        if is_axis_leaf(a):
            if whole or (p.dim() > 2 and not _cut_bank(a, experts)):
                return p
            cut = param_cut(ctx, tuple(a), tuple(full.shape), units,
                            getattr(a, "blocks", 1))
            if cut is None or p.shape[cut[0]] == full.shape[cut[0]]:
                return p
            return _gather(p.detach(), cut[0], full.shape[cut[0]], ctx,
                           cut[1])
        if isinstance(a, dict):
            return {k: rec(p[k], v, full[k], whole or k in whole_keys)
                    for k, v in a.items()}
        return [rec(pi, ai, fi, whole) for pi, ai, fi in zip(p, a, full)]

    return rec(params, axes_tree, shapes, False)


_KV_LEAVES = ("k", "v", "kp", "vp")
_KV_SCALE_LEAVES = ("k_scale", "v_scale")
_LATENT_LEAVES = ("ckv", "krope")


# ---------------------------------------------------------------------------
# KV caches cut over the sequence (act_kv_seq)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqCut:
    """A contiguous cache's sequence cut over mesh ``axes``: this rank,
    ``index`` of ``n``, holds the columns ``[index * cols, (index + 1) *
    cols)`` of the ``n * cols``, then a sink column of its own."""

    axes: Tuple[str, ...]
    index: int
    n: int
    cols: int

    @property
    def offset(self) -> int:
        return self.index * self.cols


def seq_group(ctx: Optional[TPContext], name: str, local: Sequence[int]):
    """The group over which attention merges on a rank's cut of a cache:
    that of the axes :func:`seq_cut` cut its leaf ``name`` over. ``local``
    is the leaf's shape as the rank holds it, global but for its columns
    (dim 1: "k" (B, columns, global KV heads, D), "ckv" (B, columns,
    kv_lora_rank)); its global length is stated as one every span of the
    mesh divides, so the axes are the cut's own."""
    cut = None if ctx is None or ctx.mesh is None else seq_cut(
        ctx, name, (local[0], local[1] * ctx.mesh.size, *local[2:]))
    if cut is None:
        raise ValueError("tp: a KV cache cut over the sequence, but the "
                         "active rules give its act_kv_seq no mesh axis "
                         "of its own")
    group = ctx.mesh.group(cut.axes)
    if group is None:
        raise ValueError(f"tp: the mesh has no group of axes {cut.axes}")
    return group


def seq_cut(ctx: Optional[TPContext], name: str, shape: Sequence[int]
            ) -> Optional[SeqCut]:
    """How the rank holds a contiguous cache leaf ``name`` ("k", "v", or
    MLA's "ckv", "krope") of the reference's global ``shape`` (B, T, ...):
    cut over the axes that ``steps.cache_shardings`` (``sharding.
    cache_spec``) gives its ``act_kv_seq`` dim, else None (no context, no
    axis, T not divisible, or the axis taken by the KV heads, which the
    spec's duplicate-axis rule ranks first)."""
    if ctx is None or ctx.mesh is None:
        return None
    axes = cache_spec(ctx.rules, name, shape)[1]
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    index, n = ctx.mesh.span(axes)
    if n == 1:
        return None
    return SeqCut(axes, index, n, shape[1] // n)


def cut_sequence(t: torch.Tensor, cut: SeqCut) -> torch.Tensor:
    """The rank's columns of a whole (B, T + 1, ...) cache leaf (the last
    column the sink) and a sink column of its own, in a tensor of its
    own."""
    return torch.cat([t[:, cut.offset:cut.offset + cut.cols],
                      t[:, -1:]], dim=1)


def seq_offset_tensor(cut: SeqCut, device) -> torch.Tensor:
    """A cut cache's ``seq_offset`` entry: the first global column it
    holds, 0-d int32 on the cache's device (the cache update and attention
    shift positions by it without reading it on the host)."""
    return torch.tensor(cut.offset, dtype=torch.int32, device=device)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, group
                   ) -> torch.Tensor:
    """The attention over every rank's keys from each rank's attention
    over its own (``out`` (B, Sq, H, Dv), ``lse`` (B, Sq, H) fp32): one
    ``all_gather`` of both, then in fp32 ``L = logsumexp_r lse_r`` and
    ``o = Σ_r exp(lse_r - L) o_r`` in rank order, cast to ``out``'s dtype.
    Every rank computes the same from the same gathered bits; a rank whose
    rows see no key (lse = -inf) adds nothing, and a row no rank sees is
    zeros."""
    if _group_size(group) == 1:
        return out
    both = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    parts = all_gather(both, 0, group)                # (n, B, Sq, H, Dv + 1)
    return merge_stack(parts[..., :-1], parts[..., -1]).to(out.dtype)


def merge_stack(o_r: torch.Tensor, lse_r: torch.Tensor) -> torch.Tensor:
    """The merge of :func:`merge_partials` over the leading dim of (n, B,
    Sq, H, Dv) partial outputs and their (n, B, Sq, H) log-sum-exps, in
    fp32."""
    o_r, lse_r = o_r.float(), lse_r.float()
    top = lse_r.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse_r - top)                        # exp(-inf) = 0
    total = w.sum(dim=0)
    return (w[..., None] * o_r).sum(dim=0) / total.clamp(min=1e-30)[..., None]


def shard_caches(caches, ctx: Optional[TPContext], *, shard_kv: bool):
    """The rank's caches, from whole ones: K/V leaves (dense ``k``/``v``
    or paged ``kp``/``vp``) cut to the rank's KV heads (axis -2) when
    ``shard_kv``, int8 pools' ``k_scale``/``v_scale`` on theirs (the last
    axis); a contiguous cache's ``k``/``v``, or MLA's latent ``ckv`` /
    ``krope``, also cut to the rank's columns where :func:`seq_cut` cuts
    them (then the cache gains its ``seq_offset``); lengths and SSM state
    stay whole. ``shard_kv`` must be the :func:`head_sharding` decision
    for the model's (H, Hkv)."""
    heads = _active(ctx) and shard_kv
    if ctx is None:
        return caches
    mp, r = ctx.model_size, ctx.rank

    def cut_node(node):
        out = {}
        cut, cols = None, ()
        if "k" in node and "v" in node and node["k"].dim() == 4:
            cols = ("k", "v")
        elif all(n in node for n in _LATENT_LEAVES):
            cols = _LATENT_LEAVES
        if cols:
            t = node[cols[0]]
            cut = seq_cut(ctx, cols[0], (t.shape[0], t.shape[1] - 1,
                                         *t.shape[2:]))
        for key, val in node.items():
            if isinstance(val, (dict, list)):
                out[key] = rec(val)
                continue
            if cut is not None and key in cols:
                val = cut_sequence(val, cut)
            if heads and key in _KV_LEAVES and val.dim() >= 4:
                val = shard_dim(val, -2, r, mp)
            elif heads and key in _KV_SCALE_LEAVES and val.dim() >= 2:
                val = shard_dim(val, -1, r, mp)
            out[key] = val
        if cut is not None:
            out["seq_offset"] = seq_offset_tensor(cut, node[cols[0]].device)
        return out

    def rec(node):
        if isinstance(node, list):
            return [rec(v) for v in node]
        return cut_node(node)

    return rec(caches)
