"""Meshes over ``torch.distributed`` (``repro/launch/mesh.py``).

The reference's mesh is one controller's grid of devices. Here every rank
is a process that runs the same program on its own slice, so a
:class:`Mesh` is this rank's view of the grid: the axis names and sizes,
this rank's coordinates, and one process group per axis — the ranks that
share every other coordinate. Rank r sits at the row-major coordinates of
r in the grid (the reference's device order). Every rank creates every
group, in the same order, as ``dist.new_group`` requires. A mesh with a
``pod`` and a ``data`` axis also has the group of the two together (the
reference's ``act_batch``, pod major), :meth:`Mesh.group` of
``("pod", "data")``.

Without an initialised process group the world is this one process: a
mesh of size 1 whose groups are None (no collective is ever issued on it).

:meth:`Mesh.abstract` is one rank's view of a grid with no processes
behind it: its groups are :class:`AbstractGroup` s, over which
``distributed/tp.py`` counts a collective of ``meta`` tensors (the dry
run, ``launch/dryrun.py``) and raises for any other tensor, so no real
run can take the counting path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


class AbstractGroup:
    """The ranks of one axis line of an abstract mesh: a group with no
    process group behind it."""

    def __init__(self, ranks: Tuple[int, ...]):
        self.ranks = ranks

    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"AbstractGroup({self.ranks})"


class Mesh:
    """This rank's view of an (axis_names, shape) grid of ranks."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self._grid(shape, axis_names)
        world = world_size()
        if self.size != world:
            raise ValueError(f"a mesh of shape {self.dims} needs {self.size} "
                             f"ranks; the world has {world}")
        self._place(dist.get_rank() if dist.is_initialized() else 0,
                    abstract=False)

    @classmethod
    def abstract(cls, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0) -> "Mesh":
        """Rank ``rank``'s coordinates and groups in a grid of ``shape``,
        with no process behind it, whatever the world."""
        mesh = cls.__new__(cls)
        mesh._grid(shape, axis_names)
        if not 0 <= rank < mesh.size:
            raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
        mesh._place(rank, abstract=True)
        return mesh

    def _grid(self, shape: Sequence[int], axis_names: Sequence[str]) -> None:
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.dims = tuple(int(s) for s in shape)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} does not name every "
                             f"axis of {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.dims))
        self.size = int(np.prod(self.dims))

    def _place(self, rank: int, *, abstract: bool) -> None:
        self.rank, self.is_abstract = rank, abstract
        dims = self.dims
        grid = np.arange(self.size).reshape(dims)
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, dims))))
        self.groups: Dict[Any, Optional[dist.ProcessGroup]] = {}
        self.group_ranks: Dict[Any, Tuple[int, ...]] = {}
        keys = [(name,) for name in self.axis_names]
        if "pod" in self.shape and "data" in self.shape:
            keys.append(("pod", "data"))
        for key in keys:
            idx = [self.axis_names.index(a) for a in key]
            n = int(np.prod([dims[i] for i in idx]))
            last = list(range(-len(idx), 0))
            lines = np.moveaxis(grid, idx, last).reshape(-1, n)
            for line in lines:
                ranks = tuple(int(r) for r in line)
                if abstract:
                    g = AbstractGroup(ranks)
                else:
                    # every rank takes part in every new_group call
                    g = dist.new_group(list(ranks)) \
                        if dist.is_initialized() else None
                if self.rank in ranks:
                    name = key[0] if len(key) == 1 else key
                    self.groups[name], self.group_ranks[name] = g, ranks

    def group(self, axis) -> Optional[dist.ProcessGroup]:
        """The group of ``axis``, or of a tuple of axes taken together
        (one axis: its own group; ``("pod", "data")``)."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        return self.groups.get(axis)

    def axes_of(self, group) -> Optional[str]:
        """The axis names of this rank's ``group``, joined by "+"
        ("pod+data"), or None for a group this mesh did not make."""
        for name, g in self.groups.items():
            if g is not None and g is group:
                return name if isinstance(name, str) else "+".join(name)
        return None

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def span(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(this rank's index, the count) along ``axes`` taken together,
        row major (the first axis major); axes the mesh lacks count 1."""
        index, count = 0, 1
        for a in axes:
            index = index * self.axis_size(a) + self.coords.get(a, 0)
            count *= self.axis_size(a)
        return index, count

    def __repr__(self) -> str:
        kind = "abstract " if self.is_abstract else ""
        return (f"Mesh({kind}{self.shape}, rank={self.rank}, "
                f"coords={self.coords})")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def production_mesh_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the production mesh: 16×16 = 256 ranks per
    pod; multi_pod adds a leading 2-pod axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 ranks per pod; multi_pod adds a leading 2-pod axis.
    Raises unless the world has that many ranks (the dry run takes
    ``Mesh.abstract(*production_mesh_shape())`` instead)."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    need = int(np.prod(shape))
    if world_size() != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks; the world has {world_size()}")
    return Mesh(shape, axes)


def make_host_mesh(*, pod: int = 1, model: int = 1) -> Mesh:
    """Every rank of the world as a (data, model) mesh, or with ``pod`` >
    1 a (pod, data, model) one.

    ``model`` is the model-axis (tensor-parallel) factor and ``pod`` the
    pod axis; the data axis takes the rest, and an impossible split fails
    loudly."""
    n = world_size()
    for name, f in (("pod", pod), ("model", model)):
        if f < 1:
            raise ValueError(f"{name} axis factor must be >= 1, got {f}")
    if n % (pod * model):
        raise ValueError(
            f"cannot build a (pod, data, model) host mesh: {n} rank(s) not "
            f"divisible by pod={pod} x model={model}; pick factors of {n} "
            f"(or start more ranks: repro_torch/distributed/launch.py)")
    if pod == 1:
        return Mesh((n // model, model), ("data", "model"))
    return Mesh((pod, n // (pod * model), model), ("pod", "data", "model"))
