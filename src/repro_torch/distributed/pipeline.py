"""GPipe-style pipeline parallelism over a ``stage`` mesh axis
(``repro/distributed/pipeline.py``).

Rank s of the ``stage`` axis is stage s and holds only its slice of the
layers (:func:`stack_for_stages` cuts them). Microbatches stream through
on the GPipe schedule of μ + S − 1 ticks: at tick t, stage s processes
microbatch t − s when 0 ≤ t − s < μ. Every tick each stage hands its last
output to the next one: a ``broadcast`` in the two neighbours' group, one
group per adjacent pair (the reference's ``collective_permute``). The last
stage's outputs reach every rank through an ``all_reduce`` of a buffer
that only it filled, as the reference does (``psum`` of a masked buffer).

Differentiable end to end: the hop is an ``autograd.Function`` whose
backward sends the gradient the other way (stage s + 1 to s), and the
final sum's backward keeps the gradient on the last stage only — the loss
every rank computes from the same outputs counts once. As in the
reference, every stage runs its layers on every tick (inactive ticks on a
placeholder, masked out), so every rank issues the same collectives in
the same order, forward and backward.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist

from repro_torch.distributed import tp as TP
from repro_torch.optim.adamw import tree_map


def stack_for_stages(layer_params, n_stages: int):
    """Layers → stage-major: a list of L per-layer params becomes S lists
    of L/S; a tree of (L, ...) stacked tensors becomes (S, L/S, ...)."""
    if isinstance(layer_params, list):
        L = len(layer_params)
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        per = L // n_stages
        return [layer_params[s * per:(s + 1) * per] for s in range(n_stages)]

    def resplit(t):
        L = t.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return t.reshape((n_stages, L // n_stages) + tuple(t.shape[1:]))
    return tree_map(resplit, layer_params)


class _Stages:
    """This rank's place on the stage axis and the neighbour groups: one
    ``dist.new_group`` per adjacent pair of every stage line, created in
    the same order on every rank."""

    def __init__(self, mesh, axis: str):
        self.n = mesh.axis_size(axis)
        self.stage = mesh.coords[axis]
        self.group = mesh.group(axis)
        line = mesh.group_ranks[axis]            # global ranks, by stage
        self.ranks = line
        self.pairs: Dict[int, Any] = {}
        names = mesh.axis_names
        i = names.index(axis)
        sizes = [mesh.shape[a] for a in names]
        grid = torch.arange(mesh.size).reshape(sizes).movedim(i, -1)
        for row in grid.reshape(-1, self.n).tolist():
            for s in range(self.n - 1):
                g = dist.new_group([row[s], row[s + 1]])
                if tuple(row) == tuple(line):
                    self.pairs[s] = g

    def shift(self, t: torch.Tensor, forward: bool) -> torch.Tensor:
        """Each stage's ``t`` to the next stage (``forward``) or the
        previous one; the stage at the open end receives zeros."""
        out = torch.zeros_like(t)
        s = self.stage
        for i in range(self.n - 1):
            if s not in (i, i + 1):
                continue
            src = i if forward else i + 1
            if s == src:
                # a copy: the collective writes its buffer in place on the
                # sender too, and autograd may still need t's values
                TP.broadcast(t.clone(memory_format=torch.contiguous_format),
                             self.ranks[src], self.pairs[i])
            else:
                out = TP.broadcast(torch.empty_like(t), self.ranks[src],
                                   self.pairs[i])
        return out


class _Hop(torch.autograd.Function):
    """One tick's hand-over: forward, stage s − 1's output arrives at
    stage s; backward, the gradient goes from stage s to s − 1."""

    @staticmethod
    def forward(ctx, y, stages):
        ctx.stages = stages
        return stages.shift(y, forward=True)

    @staticmethod
    def backward(ctx, g):
        return ctx.stages.shift(g, forward=False), None


class _LastStageSum(torch.autograd.Function):
    """The last stage's buffer on every rank (an all-reduce of a buffer
    only it filled); backward keeps the gradient on the last stage."""

    @staticmethod
    def forward(ctx, buf, stages):
        ctx.last = stages.stage == stages.n - 1
        mine = buf if ctx.last else torch.zeros_like(buf)
        return TP.all_reduce(mine.clone(), stages.group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def _stages(mesh, axis: str) -> _Stages:
    """The mesh's neighbour groups along ``axis``, made at the first
    pipeline_apply (every rank calls it together) and kept on the mesh."""
    kept = mesh.__dict__.setdefault("_pipeline_stages", {})
    if axis not in kept:
        kept[axis] = _Stages(mesh, axis)
    return kept[axis]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params, x: torch.Tensor, *, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run x through the S stages of ``mesh``'s ``axis``; returns the (μ,
    mb, ...) outputs, in microbatch order, on every rank.

    ``stage_params`` is this rank's own stage slice (``stack_for_stages``'
    entry s); ``stage_fn(stage_params, x_mb)`` applies one stage's layers
    to one microbatch. ``x`` (μ, mb, ...) is the whole microbatched input
    on every rank; only stage 0 consumes it. Every rank of the mesh calls
    this together.
    """
    st = _stages(mesh, axis)
    mu = x.shape[0]
    first = torch.tensor(st.stage == 0, device=x.device)
    prev = torch.zeros_like(x[0])
    outs: List[torch.Tensor] = []
    for t in range(mu + st.n - 1):
        recv = _Hop.apply(prev, st) if t else prev
        mb = t - st.stage
        active = 0 <= mb < mu
        feed = torch.where(first, x[min(max(mb, 0), mu - 1)], recv)
        y = stage_fn(stage_params, feed)
        y = y if active else y * 0       # keeps the tick in the graph
        if active and st.stage == st.n - 1:
            outs.append(y)
        prev = y
    if st.stage == st.n - 1:
        buf = torch.stack(outs)
    else:
        # the other stages add zeros; (prev * 0) keeps the graph connected
        buf = (prev * 0).unsqueeze(0).expand(mu, *prev.shape).contiguous()
    return _LastStageSum.apply(buf, st)
