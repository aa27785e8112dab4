"""The port's sharding rules, logical axes, meshes and abstract specs
against the live JAX package.

* ``distributed/sharding.py``: ``ShardingRules.spec`` equals the
  reference's ``spec`` (as a tuple) on the grids of ``tests/test_sharding.py``
  and ``tests/test_sharding_props.py`` — mesh sizes faked by overriding
  ``_mesh_size``, the reference tests' own trick — plus a seeded sweep of
  logical names × widths × mesh sizes × overrides; ``param_specs``,
  ``stack_axes`` and ``use_rules`` likewise;
* ``models/module.py::param_axes`` equals the reference's axes tree, leaf
  for leaf (its stacked ``layers`` axis dropped), for every config of the
  registry, and the port's param tree has exactly those leaves;
* ``launch/steps.py``'s sharding trees equal the reference's specs;
* ``launch/specs.py`` (the counterpart of ``tests/test_system.py``'s
  abstract-spec tests): the abstract params equal a concrete init's tree
  and shapes, and ``input_specs`` cover the train, prefill and decode
  cells with the reference's token shapes;
* ``launch/mesh.py``: the host mesh and the production mesh's refusal.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import registry as jregistry
from repro.distributed import sharding as jshd
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.models.module import ax as jax_ax
from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.module import ax, param_axes

LOGICALS = sorted(jshd.DEFAULT_RULES)
AXIS_VALUES = (None, "data", "model", "pod", ("pod", "data"))


def jmesh(axes=("data", "model")):
    dev = np.array(jax.devices()[:1]).reshape((1,) * len(axes))
    return JMesh(dev, axes)


def sized(module, sizes, overrides=None, axes=("data", "model")):
    """The rules class of ``module`` over a one-device mesh whose axis
    sizes are reported as ``sizes`` (tests/test_sharding_props.py)."""
    class Sized(module.ShardingRules):
        def _mesh_size(self, a):
            if a is None:
                return 1
            n = 1
            for name in ((a,) if isinstance(a, str) else a):
                n *= sizes.get(name, 1)
            return n
    return Sized(jmesh(axes), overrides)


def both(sizes, overrides=None, axes=("data", "model")):
    return (sized(jshd, sizes, overrides, axes),
            sized(shd, sizes, overrides, axes))


def same_spec(ref_rules, rules, logical, shape=None):
    want = tuple(ref_rules.spec(logical, shape))
    got = rules.spec(logical, shape)
    assert got == want, (logical, shape, got, want)
    return got


# ---------------------------------------------------------------------------
# ShardingRules.spec
# ---------------------------------------------------------------------------

def test_spec_examples_match_reference():
    """tests/test_sharding.py's and tests/test_sharding_props.py's
    explicit cases."""
    r, p = both({})
    assert same_spec(r, p, ("embed", "mlp")) == ("data", "model")
    assert same_spec(r, p, ("vocab", "embed")) == ("model", "data")
    assert same_spec(r, p, (None, "heads")) == (None, "model")
    assert same_spec(r, p, ("act_batch",)) == ("data",)   # pod dropped
    r, p = both({"model": 16})
    assert same_spec(r, p, ("embed", "heads"), (576, 9 * 64)) == ("data",
                                                                  "model")
    assert same_spec(r, p, (None, "heads"), (1, 9)) == (None, None)
    r, p = both({"data": 4, "model": 16})
    assert same_spec(r, p, ("embed", "heads"), (576, 9 * 64)) == ("data",
                                                                  "model")
    r, p = both({}, {"heads": None})
    assert same_spec(r, p, ("embed", "heads")) == ("data", None)
    cfg = registry.get_config("smollm-135m")
    r, p = both({}, cfg.overrides_dict())
    assert same_spec(r, p, ("embed", "heads")) == ("data", None)
    assert same_spec(r, p, ("embed", "mlp")) == ("data", "model")
    r, p = both({"data": 2, "model": 2}, {"act_seq": "model"})
    assert same_spec(r, p, ("act_batch", "act_seq", "act_mlp"),
                     (4, 8, 8)) == ("data", None, "model")


@pytest.mark.parametrize("mesh_axes", [("data", "model"),
                                       ("pod", "data", "model")])
def test_spec_sweep_matches_reference(mesh_axes):
    """A seeded sweep: 1–4 logical names (or None), widths 1–96, data and
    model sizes {1, 2, 3, 4, 16}, pod {1, 2}, with and without one
    override — the property tests' space."""
    rng = np.random.default_rng(0)
    names = LOGICALS + [None]
    for _ in range(300):
        n = int(rng.integers(1, 5))
        logical = tuple(names[i] for i in rng.integers(0, len(names), n))
        shape = tuple(int(d) for d in rng.integers(1, 97, n))
        sizes = {"data": int(rng.choice([1, 2, 3, 4, 16])),
                 "model": int(rng.choice([1, 2, 3, 4, 16])),
                 "pod": int(rng.choice([1, 2]))}
        over = None
        if rng.random() < 0.5:
            over = {LOGICALS[int(rng.integers(len(LOGICALS)))]:
                    AXIS_VALUES[int(rng.integers(len(AXIS_VALUES)))]}
        r, p = both(sizes, over, mesh_axes)
        same_spec(r, p, logical, shape)
        same_spec(r, p, logical)
        assert p.rules == r.rules
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


def test_rules_take_a_mesh_with_names_and_shape():
    """The unfaked sizes come from the mesh: a jax Mesh, the port's Mesh,
    anything with ``axis_names`` and ``shape``."""
    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}
    rules = shd.ShardingRules(FakeMesh())
    assert rules.spec(("embed", "heads"), (6, 8)) == ("data", "model")
    assert rules.spec(("embed", "heads"), (6, 6)) == ("data", None)
    rules = shd.ShardingRules(make_host_mesh())
    assert rules.spec(("act_batch", "act_mlp"), (3, 5)) == ("data", "model")


def test_param_specs_stack_axes_and_use_rules():
    r, p = both({"data": 2, "model": 4})
    axes = {"w": ax("embed", "mlp"), "b": ax("mlp"),
            "nested": {"v": ax("vocab", "embed")}}
    jaxes = {"w": jax_ax("embed", "mlp"), "b": jax_ax("mlp"),
             "nested": {"v": jax_ax("vocab", "embed")}}
    shapes = {"w": (128, 256), "b": (256,), "nested": {"v": (512, 128)}}
    want = jshd.param_specs(jaxes, jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple)), r)
    got = shd.param_specs(axes, {"w": torch.empty(128, 256),
                                 "b": torch.empty(256),
                                 "nested": {"v": torch.empty(512, 128)}}, p)
    assert got == {"w": tuple(want["w"]), "b": tuple(want["b"]),
                   "nested": {"v": tuple(want["nested"]["v"])}}
    assert tuple(shd.stack_axes(axes)["w"]) == tuple(
        jshd.stack_axes(jaxes)["w"]) == ("layers", "embed", "mlp")
    assert shd.current_rules() is None
    with shd.use_rules(p):
        assert shd.current_rules() is p
    assert shd.current_rules() is None


# ---------------------------------------------------------------------------
# param_axes and the model's sharding trees
# ---------------------------------------------------------------------------

def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, pre + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, pre + (i,))
    else:
        yield pre, tree


def _ref_unstacked(tree, n_layers):
    """The reference's tree with ``layers`` unstacked into a list of
    n_layers copies, each leaf's leading (stacked layers) entry
    dropped."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = [jax.tree_util.tree_map(
        lambda a: tuple(a)[1:], tree["layers"],
        is_leaf=lambda x: isinstance(x, tuple))] * n_layers
    return out


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_param_axes_and_specs_match_reference(arch):
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jaxes = JT.model_axes(jcfg)
    jparams = jax.eval_shape(lambda k: JT.init_model(k, jcfg)[0],
                             jax.random.PRNGKey(0))
    n = cfg.n_layers - cfg.first_dense_layers
    want = dict(_flat(_ref_unstacked(
        jax.tree_util.tree_map(tuple, jaxes,
                               is_leaf=lambda x: isinstance(x, tuple)), n)))
    axes = param_axes(cfg)
    got = {k: tuple(v) for k, v in _flat(axes)}
    assert got == want
    params = T.init_model(cfg, device="meta")
    assert set(dict(_flat(params))) == set(got)
    # the model's spec tree under a (2, 4) mesh: the reference's, with its
    # stacked layers entry (always replicated) dropped
    r, p = both({"data": 2, "model": 4}, cfg.overrides_dict())
    jspecs = jshd.param_specs(jaxes, jparams, r)
    want = dict(_flat(_ref_unstacked(jax.tree_util.tree_map(
        tuple, jspecs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)), n)))
    got = dict(_flat(ST.model_shardings(cfg, params, axes, p)))
    assert {k: tuple(v) for k, v in got.items()} == want
    opt = ST.opt_shardings(ST.model_shardings(cfg, params, axes, p), p)
    assert set(opt) == {"mu", "nu", "step"} and opt["step"] == ()


def test_batch_and_cache_shardings_match_reference():
    jcfg = jregistry.get_smoke_config("qwen3-8b")
    cfg = registry.get_smoke_config("qwen3-8b")
    r, p = both({"data": 2, "model": 2}, cfg.overrides_dict())
    batch = {"tokens": (4, 16), "embeds": (4, 3, 8)}
    want = JST.batch_shardings(
        {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in batch.items()}, r)
    got = ST.batch_shardings({k: torch.empty(s, device="meta")
                              for k, s in batch.items()}, p)
    assert got == {k: tuple(v.spec) for k, v in want.items()} == \
        {"tokens": ("data", None), "embeds": ("data", None, None)}
    # caches: the same role rules, right-aligned, by the innermost key
    names = ("k", "v", "len", "ckv", "krope", "x", "B", "C", "state")
    shapes = {"k": (2, 4, 8, 2, 16), "v": (2, 4, 8, 2, 16), "len": (2, 4),
              "ckv": (4, 8, 6), "krope": (4, 8, 4), "x": (4, 3, 6),
              "B": (4, 3, 2), "C": (4, 3, 2), "state": (4, 2, 3, 3)}
    jtree = {k: jax.ShapeDtypeStruct(shapes[k], jnp.float32) for k in names}
    want = jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                  JST.cache_shardings(jtree, r))
    got = ST.cache_shardings([{k: torch.empty(shapes[k], device="meta")
                               for k in names}], p)[0]
    assert got == {k: want[k] + (None,) * (len(shapes[k]) - len(want[k]))
                   for k in names}
    assert ST.make_rules(cfg, make_host_mesh(),
                         registry.SHAPES["long_500k"]).rules[
        "act_kv_seq"] == "data"


# ---------------------------------------------------------------------------
# launch/specs.py and the registry's shape cells (tests/test_system.py)
# ---------------------------------------------------------------------------

def test_abstract_specs_match_concrete_init():
    cfg = registry.get_smoke_config("qwen3-8b")
    abs_p, axes = SP.abstract_params_and_axes(cfg)
    concrete = T.init_model(cfg, device="cpu")
    a, c = dict(_flat(abs_p)), dict(_flat(concrete))
    assert set(a) == set(c) == set(dict(_flat(axes)))
    for k in a:
        assert a[k].device.type == "meta"
        assert a[k].shape == c[k].shape and a[k].dtype == c[k].dtype, k


def test_shape_cells_match_reference():
    assert {k: tuple(vars(v).values()) for k, v in registry.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jregistry.SHAPES.items()}
    for arch in registry.ARCHS:
        for name, cell in registry.SHAPES.items():
            assert registry.cell_applicable(registry.get_config(arch), cell) \
                == jregistry.cell_applicable(jregistry.get_config(arch),
                                             jregistry.SHAPES[name])
    assert list(registry.all_cells()) and len(list(registry.all_cells())) \
        == len(list(jregistry.all_cells()))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_input_specs_cover_cells(shape_name):
    for arch in ("qwen2-1.5b", "musicgen-medium", "internvl2-76b",
                 "mamba2-1.3b"):
        cfg = registry.get_config(arch)
        cell = registry.SHAPES[shape_name]
        specs = SP.input_specs(cfg, cell)
        leaves = [t for _, t in _flat(specs)]
        assert leaves and all(t.device.type == "meta" for t in leaves)
        want = JSP.input_specs(jregistry.get_config(arch),
                               jregistry.SHAPES[shape_name])
        toks = specs["batch"] if cell.kind != "decode" else specs
        jtoks = want["batch"] if cell.kind != "decode" else want
        for k in ("tokens", "embeds", "positions"):
            if k in jtoks:
                assert tuple(toks[k].shape) == tuple(jtoks[k].shape), k
        if cell.kind == "train":
            assert specs["batch"]["tokens"].shape[0] == cell.batch
        else:
            assert len(specs["caches"]) >= cfg.n_layers


def test_meshes():
    mesh = make_host_mesh()
    assert mesh.axis_names == ("data", "model")
    assert mesh.coords == {"data": 0, "model": 0} and mesh.size == 1
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# What a rank holds against the spec trees
# ---------------------------------------------------------------------------

class _RankOfTwo:
    """Rank ``r``'s view of a (1, 2) (data, model) mesh — enough for
    placement, which issues no collective."""
    axis_names = ("data", "model")

    def __init__(self, r):
        self.shape = {"data": 1, "model": 2}
        self.coords = {"data": 0, "model": r}

    def group(self, axis):
        return None


# arch → the leaves whose rank placement parts from model_shardings' tree:
# (logical names, spec, tp.param_cut); every other leaf agrees.
PLACEMENT_PARTINGS = {
    # SwiGLU's gate ‖ up: the spec's dim, cut block by block
    "qwen3-8b": [(("embed", "mlp"), ("data", "model"), (1, 2))],
    # MQA: the spec splits the one KV head's columns; ranks keep it whole
    "granite-20b": [(("embed", "kv_heads"), ("data", "model"), None)] * 2,
}


@pytest.mark.parametrize("arch", sorted(PLACEMENT_PARTINGS))
def test_rank_placement_parts_from_spec_trees_only_where_documented(arch):
    """tp.param_cut takes the dim that launch/steps.py's model_shardings
    tree shards over the model axis, and tp.shard_params holds it, except
    in the two cases model_shardings' docstring names: SwiGLU's wi (each
    rank the same chunk of gate and up) and MQA's wk/wv (whole)."""
    from repro_torch.distributed import tp as TP
    cfg = registry.get_smoke_config(arch, n_layers=1, vocab=64,
                                    sharding_overrides=())
    params = T.init_model(cfg, device="cpu")
    axes = param_axes(cfg)
    ctxs = [TP.make_context(_RankOfTwo(r), overrides=cfg.overrides_dict())
            for r in range(2)]
    specs = ST.model_shardings(cfg, params, axes, ctxs[0].rules)
    units = TP.head_units(cfg)
    rows = []

    def one(a, spec, p):
        names = tuple(a)
        cut = TP.param_cut(ctxs[0], names, tuple(p.shape), units, a.blocks)
        dims = [d for d, s in enumerate(spec)
                if "model" in ((s,) if isinstance(s, str) else (s or ()))]
        rows.append((names, spec, cut, dims))
    shd.tree_map_axes(one, axes, specs, params)
    parted = [(n, s, c) for n, s, c, dims in rows
              if (c is None and dims) or (c is not None
                                          and (dims != [c[0]] or c[1] != 1))]
    assert parted == PLACEMENT_PARTINGS[arch]
    assert any(c is not None for _, _, c, _ in rows)   # something shards

    held = [TP.shard_params(params, axes, ctx, units=units) for ctx in ctxs]
    lp, h0, h1 = (t["layers"][0] for t in (params, *held))
    if arch == "qwen3-8b":
        wi, f = lp["mlp"]["wi"], cfg.d_ff
        for r, h in enumerate((h0, h1)):
            want = torch.cat([wi[:, r * f // 2:(r + 1) * f // 2],
                              wi[:, f + r * f // 2:f + (r + 1) * f // 2]], 1)
            assert torch.equal(h["mlp"]["wi"], want)
            # not the spec's contiguous half (the gate alone on rank 0)
            assert not torch.equal(h["mlp"]["wi"],
                                   wi[:, r * f:(r + 1) * f])
    else:
        for h in (h0, h1):
            for k in ("wk", "wv"):
                assert torch.equal(h["attn"][k], lp["attn"][k])
            assert h["attn"]["wq"].shape[1] * 2 == lp["attn"]["wq"].shape[1]


def test_tp_wrappers_take_rank_slices_and_refuse_whole_operands():
    """Under an active model axis tp.linear, tp.embed and tp.attention take
    what the rank holds and raise for a whole weight, table or head set,
    rather than cut it by a copy on every call; a column-parallel call on
    the rank's slice (no collective) is that slice's product."""
    from repro_torch.core import api
    from repro_torch.distributed import tp as TP
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 8, generator=g), torch.randn(8, 6, generator=g)
    for r in range(2):
        ctx = TP.make_context(_RankOfTwo(r))
        with TP.use_tp(ctx):
            got = TP.linear(x, w[:, 3 * r:3 * r + 3], axes=("embed", "mlp"),
                            full=(8, 6))
            assert torch.equal(got, api.linear(x, w[:, 3 * r:3 * r + 3]))
            with pytest.raises(ValueError, match="rank's slice"):
                TP.linear(x, w, axes=("embed", "mlp"), full=(8, 6))
            with pytest.raises(ValueError, match="rank's slice"):
                TP.linear(x.T, w.T, axes=("mlp", "embed"), full=(6, 8))
            with pytest.raises(ValueError, match="rank's slice"):
                TP.embed(torch.randn(6, 4, generator=g),
                         torch.tensor([[1, 5]]), vocab=6)
            q, kv = torch.randn(1, 2, 4, 8), torch.randn(1, 5, 2, 8)
            with pytest.raises(ValueError, match="rank's slice"):
                TP.attention(q, kv, kv, q_positions=torch.tensor([[3, 4]]),
                             kv_valid_len=torch.tensor([5]), heads=(4, 2))
