"""Logical-axis sharding rules (``repro/distributed/sharding.py``).

Params carry *logical* axis names (``models/module.py::param_axes``);
these rules map each name to mesh axes, with a divisibility fallback, so
one model definition serves every mesh and every architecture (smollm's 9
heads fall back to replicated attention while its d_ff still shards).

Conventions:
  pod    — pure data parallelism across pods (gradient all-reduce only)
  data   — data parallel (the batch dim)
  model  — tensor parallel (heads / d_ff / vocab) and expert parallel

A spec is a tuple with one entry per dim — None, a mesh axis name, or a
tuple of names — the counterpart of the reference's ``PartitionSpec``.
Every rank holds only its own slice of a tensor (``distributed/tp.py``),
so the reference's ``shard()`` activation constraint has no counterpart.
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.models.module import AxisLeaf, is_axis_leaf

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# Logical axis → mesh axes. Params use bare names; activations use act_*.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # parameter axes
    "layers": None,
    "embed": "data",        # FSDP/ZeRO: weights' d_model dim sharded over data
    "mlp": "model",         # TP: FFN hidden
    "heads": "model",       # TP: fused (n_heads·d_head) projection dim
    "kv_heads": "model",    # TP: fused KV projection dim (falls back for MQA)
    "vocab": "model",       # TP: embedding / LM head vocab dim
    "experts": "model",     # EP: MoE expert dim
    "kv_lora": None,        # MLA latent dims stay replicated
    "conv": None,
    "state": None,
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": None,         # flipped to "model" under sequence parallelism
    "act_embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_state": None,
}


# A cache leaf's logical axes by its name, right-aligned: the reference's
# ``launch/steps.py::_CACHE_DIM_RULES``. ``act_kv_seq`` (the sequence of a
# contiguous KV cache, or of MLA's latent cache) maps to no mesh axis by
# default; the ``long_500k`` cells put it on ``data`` and the ``kvseq``
# perf arm on ``model`` (``launch/steps.py::make_rules``).
CACHE_DIM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
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


def cache_spec(rules: "ShardingRules", name: Optional[str],
               shape: Sequence[int]) -> Spec:
    """The spec of cache leaf ``name`` of the reference's ``shape`` (a
    contiguous cache's sequence without the port's sink column), right
    aligned by :data:`CACHE_DIM_RULES`; leading dims replicate, and a
    leaf with no rule replicates whole."""
    dims = CACHE_DIM_RULES.get(name)
    if dims is None:
        return (None,) * len(shape)
    pad = (None,) * (len(shape) - len(dims))
    return rules.spec(pad + tuple(dims), tuple(shape))


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of any mesh with ``axis_names`` and ``shape`` (a
    mapping of name to size, or sizes in axis order)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.axis_names, (int(s) for s in shape)))


class ShardingRules:
    def __init__(self, mesh, overrides: Optional[Dict[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)

    def _mesh_size(self, axes: MeshAxes) -> int:
        if axes is None or self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        return n

    def _resolve(self, axes: MeshAxes) -> MeshAxes:
        """Drop mesh axes that don't exist on the current mesh (e.g. 'pod'
        on the single-pod mesh)."""
        if axes is None or self.mesh is None:
            return None
        names = set(self.mesh.axis_names)
        if isinstance(axes, str):
            return axes if axes in names else None
        kept = tuple(a for a in axes if a in names)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """The spec of the given logical axes, with divisibility fallback
        when ``shape`` is provided.

        A mesh axis may appear at most once in a spec. When two dims
        resolve to the same mesh axis (e.g. sequence parallelism's
        act_seq→model colliding with a TP feature dim), the feature dim
        wins and the sequence dim replicates — Megatron-SP semantics.
        """
        parts = []
        for i, name in enumerate(logical):
            axes = self._resolve(self.rules.get(name)) if name else None
            if axes is not None and shape is not None:
                if shape[i] % max(self._mesh_size(axes), 1) != 0:
                    axes = None  # fallback: replicate this dim
            parts.append(axes)

        def axes_set(a):
            return set((a,) if isinstance(a, str) else (a or ()))
        # duplicate-axis resolution: act_seq yields first, then earlier dims
        seq_dims = [i for i, n in enumerate(logical) if n == "act_seq"]
        order = seq_dims + [i for i in range(len(parts)) if i not in
                            seq_dims]
        used: set = set()
        for i in reversed(order):      # last in order = highest precedence
            a = axes_set(parts[i])
            if a & used:
                parts[i] = None
            else:
                used |= a
        return tuple(parts)


_state = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def tree_map_axes(fn, axes_tree, *rest):
    """``fn(axes_leaf, *leaves)`` over an axes tree (dicts and lists of
    AxisLeaf) and trees of the same structure beside it."""
    if is_axis_leaf(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_map_axes(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def param_specs(axes_tree, shapes_tree, rules: ShardingRules):
    """Map the (axes, shapes) trees to a tree of specs; a shapes leaf is a
    tensor (or anything with ``.shape``) or a shape tuple."""
    def one(axes_leaf, shape):
        shp = tuple(shape.shape) if hasattr(shape, "shape") else shape
        return rules.spec(tuple(axes_leaf), shp)
    return tree_map_axes(one, axes_tree, shapes_tree)


def stack_axes(axes_tree):
    """Prepend the 'layers' axis to every axes leaf (stacked params)."""
    def one(a):
        leaf = AxisLeaf(("layers",) + tuple(a))
        leaf.blocks = a.blocks
        return leaf
    return tree_map_axes(one, axes_tree)
