"""Dry run of every (arch × shape × mesh) cell on ``meta`` tensors
(``repro/launch/dryrun.py``), and the roofline of one step.

The reference lowers and compiles each cell's step for the production
mesh on 512 placeholder host devices and reads XLA's ``memory_analysis``,
``cost_analysis`` and the collectives of the optimized HLO. The port has
no compiler between it and the card, so it runs the cell's real step
function — the train step with AdamW, the prefill step or the decode step
— once, eagerly, on ``meta`` tensors (shapes and dtypes, no storage) at
one rank's shapes: rank 0 of ``Mesh.abstract`` of the 16×16 (or 2×16×16)
mesh, its params cut by ``tp.shard_params`` (a train cell's also over
data, and its MoE banks by their experts over model:
``steps.rank_params``), its caches holding its KV heads and, where the
cell's rules cut a KV cache's sequence (``long_500k``: ``act_kv_seq`` over
data), its columns, its rows of the batch (over pod x data). A train
cell runs under the config's ``remat_policy`` ("dots" keeps every
product's output for the recompute: no K1 launch there, and the saved
outputs count among the temporaries). Nothing is allocated and nothing
launches,
so this entry point needs no card: ``meta`` is asked for by name, which
keeps the port's rule that an entry point runs on the card unless the
caller asks for another device.

What is counted:

  * every kernel launch the card would make: each wrapper takes the
    card's route on ``meta`` and records the launch and its least work
    (``roofline.launch_cost``) in the active cost ledger (the wrappers'
    own launch counters move only where a kernel really launches);
  * every other aten op (views excluded), through a ``TorchDispatchMode``:
    the bytes of its tensor inputs and outputs — an op that writes into a
    tensor in place counts what it writes, at most what it reads besides
    (a cache scatter writes rows, not the pool) — and its FLOPs as XLA's
    cost analysis counts them: the products by ``torch.utils.
    flop_counter``'s formulas (the MoE banks'), one FLOP an element of
    the elementwise ops and reductions, transcendentals apart
    (:class:`OpCounter`);
  * the collectives of ``distributed/tp.py`` over the abstract mesh's
    groups, by kind and bytes, and by the axes each went over (the train
    step's all-reduce over ``pod``; its amax reduces under
    ``--compress-grads``; at ``long_500k`` the ``all_gather`` over ``data``
    that merges each cut cache's attention);
  * memory: the arguments the rank holds (params, optimizer state, its
    batch and caches; ``kv_cache_bytes``, its K/V alone), the step's
    outputs, and the peak of the bytes the step allocates while it runs
    (``temp_size_in_bytes``).

The eager port walks every layer, so the reference's depth-1 / depth-2
body probe (XLA counts a scanned body once) is not needed, and
``--skip-body-probe`` is accepted and ignored. The result keeps the
reference's keys — arch, shape, mesh, kind, n_chips, n_params, memory,
cost{"flops", "bytes accessed", "transcendentals"}, collectives{"total"},
collective_counts,
roofline — and adds ``launches`` by kernel and route (K1's batched and
backward launches besides in ``launches_marked``), ``fsdp`` (whether the
rank holds its cut of the params and moments over ``data``: a train cell
on a data axis of more than one rank) and ``parts_from_reference``: where
what the rank holds or runs parts from the reference's GSPMD
placement. Attention's
FLOPs and bytes take every key in memory (positions and lengths are
data), a bound on what a run's data needs; the launch counts are exact.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out cells.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.configs.registry import (SHAPES, all_cells, cell_applicable,
                                          get_config)
from repro_torch.core import api
from repro_torch.core.plan import (UNFUSED, AttentionPolicy, PackedWeight,
                                   QuantizedPackedWeight)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as TP
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_axes
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.roofline import analysis as RA
from repro_torch.serving.engine import make_decode_step, make_prefill_step

META = SP.META
aten = torch.ops.aten
# Ops that move no data: allocations without a fill, and aliases.
_NO_DATA = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
            aten.new_empty_strided, aten.detach, aten.lift_fresh, aten.alias}
# XLA's HloCostAnalysis counts these elementwise ops under
# "transcendentals" and not under "flops", one an output element.
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                   aten.log2, aten.log10, aten.tanh, aten.sigmoid,
                   aten.rsqrt, aten.sqrt, aten.pow, aten.erf, aten.sin,
                   aten.cos, aten.tan, aten.atan2}
# Pointwise aten ops that XLA lowers to a transcendental and a FLOP an
# element (x · logistic(x); the gradient's own).
_TRANSCENDENTAL_PLUS_ONE = {aten.silu, aten.silu_backward}
# Softmax and its gradient, which torch runs as one aten op and XLA as
# its parts: (FLOPs, transcendentals) an element of the input — a max
# reduce, a subtraction, exp, a sum reduce and a division (log_softmax:
# the log's subtraction, and a log a row); the gradient's product, sum
# reduce, subtraction and product (log_softmax's: exp, sum, product,
# subtraction).
_SOFTMAX = {aten._softmax: (4, 1), aten._log_softmax: (4, 1),
            aten._softmax_backward_data: (4, 0),
            aten._log_softmax_backward_data: (3, 1)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Bytes and FLOPs of the aten ops run while it is active (views and
    the ops in ``_NO_DATA`` excluded), and the peak of the bytes their
    outputs allocate, each storage counted until it is freed.

    FLOPs are counted as XLA's cost analysis counts them, so the port's
    count stands beside the reference's: an op with a
    ``torch.utils.flop_counter`` formula (the products) by it; a pointwise
    op (``torch.Tag.pointwise``) one FLOP an output element, a reduction
    (``torch.Tag.reduction``) one an input element, softmax as its parts
    (``_SOFTMAX``), the transcendental ones apart
    (``transcendentals``). The elementwise FLOPs run on the CUDA cores:
    they are filed under ``float32``, whose peak bounds them."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.elementwise_flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._alive = set()

    def _free(self, key: int, n: int) -> None:
        self._alive.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket in _NO_DATA:
            self._track(out, ())
            return out
        ins = _tensors((args, kwargs))
        written = {id(t) for t in _mutated(func, args, kwargs)}
        read = sum(_nbytes(t) for t in ins if id(t) not in written)
        if written:
            w = sum(_nbytes(t) for t in ins if id(t) in written)
            n = read + (min(w, read) if read else w)
        else:
            n = read + sum(_nbytes(t) for t in _tensors(out))
        self.bytes += n
        self.ops += 1
        formula = flop_counter.flop_registry.get(func.overloadpacket)
        if formula is not None:
            dt = RA.dtype_name(ins[0].dtype) if ins else "float32"
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) \
                + float(formula(*args, **kwargs, out_val=out))
        else:
            self._elementwise(func, ins, out)
        self._track(out, ins)
        return out

    def _elementwise(self, func, ins, out) -> None:
        packet = func.overloadpacket
        outs = _tensors(out)
        n_out = float(outs[0].numel()) if outs else 0.0
        if packet in _SOFTMAX:
            f, t = _SOFTMAX[packet]
            n = float(ins[0].numel())
            flops, trans = f * n, t * n
        elif packet in _TRANSCENDENTAL:
            flops, trans = 0.0, n_out
        elif packet in _TRANSCENDENTAL_PLUS_ONE:
            flops, trans = n_out, n_out
        elif torch.Tag.pointwise in func.tags:
            flops, trans = n_out, 0.0
        elif torch.Tag.reduction in func.tags and ins:
            flops, trans = float(ins[0].numel()), 0.0
        else:
            return
        self.elementwise_flops += flops
        self.transcendentals += trans
        self.flops_by_dtype["float32"] = \
            self.flops_by_dtype.get("float32", 0.0) + flops

    def _track(self, out, ins) -> None:
        held = {id(t.untyped_storage()) for t in ins}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._alive:
                continue
            n = st.nbytes()
            self._alive.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)


def _mutated(func, args, kwargs) -> List[torch.Tensor]:
    """The tensor arguments ``func`` writes in place (its schema's
    ``Tensor(a!)`` arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += _tensors(v)
    return out


def _tree_bytes(tree) -> int:
    """Bytes of every tensor of ``tree``, a packed weight's blocks (and an
    int8 one's scales) included."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, (PackedWeight, QuantizedPackedWeight)):
        return _nbytes(tree.data) + _tree_bytes(getattr(tree, "scales", None))
    return 0


def _leaves_named(tree, name: str) -> List:
    """Every leaf of ``tree`` held under the key ``name``, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in ([v] if k == name else _leaves_named(v, name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_named(v, name)]
    return []


def _kv_bytes(caches) -> int:
    """Bytes of the caches' K/V (contiguous ``k``/``v`` with their sink
    column, MLA's latent, page pools), as the rank holds them."""
    return sum(_nbytes(t) for c in caches or () for name, t in c.items()
               if name in ("k", "v", "ckv", "krope", "kp", "vp"))


def _sink_bytes(caches) -> int:
    """Bytes of the caches' write sinks: the column past ``max_len`` of a
    contiguous cache, the page past the pool of a paged one (and its int8
    scale rows), which the reference's caches do not hold."""
    n = 0
    for c in caches or ():
        for name, t in c.items():
            if name in ("k", "v", "ckv", "krope"):
                n += _nbytes(t) // t.shape[1]
            elif name in ("kp", "vp", "k_scale", "v_scale"):
                n += _nbytes(t) // t.shape[0]
    return n


# ---------------------------------------------------------------------------
# Parameter counts (the reference's names and results)
# ---------------------------------------------------------------------------

def count_params_abstract(params_abs) -> int:
    return int(sum(int(np.prod(t.shape)) for t in tree_leaves(params_abs)))


def count_params_abstract_cfg(cfg: ModelConfig) -> int:
    params_abs, _ = SP.abstract_params_and_axes(cfg)
    return count_params_abstract(params_abs)


def active_params(cfg: ModelConfig, n_params: int) -> float:
    """6·N_active·D for MoE: discount inactive routed experts."""
    if not cfg.is_moe:
        return float(n_params)
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    routed = n_moe_layers * cfg.n_experts * per_expert
    active = n_moe_layers * cfg.n_experts_active * per_expert
    return float(n_params - routed + active)


def describe_memory(mem: Optional[Dict[str, int]]) -> dict:
    """The reference's summary of a memory analysis (here a dict of its
    ``*_size_in_bytes`` fields), ``total_gb_per_device`` as it computes
    it: arguments plus temporaries."""
    if not mem:
        return {}
    out = {k: int(v) for k, v in mem.items() if v is not None}
    out["total_gb_per_device"] = round(
        (out.get("argument_size_in_bytes", 0)
         + out.get("temp_size_in_bytes", 0)) / 2**30, 3)
    return out


# ---------------------------------------------------------------------------
# One step on meta
# ---------------------------------------------------------------------------

def _placement_parts(cfg: ModelConfig, mesh, shape_name, kind, batch,
                     n_rows) -> List[Dict[str, str]]:
    """Where the rank parts from the reference's GSPMD placement."""
    parts = []
    if mesh is None:
        return parts
    if mesh.axis_size("data") > 1 and kind != "train":
        parts.append(dict(part="params", detail=(
            "replicated over the data axis, as the reference's TP serving "
            "holds them (repro/distributed/tp.py:331); the reference's dry "
            "run places a serving cell's params by the training spec, "
            "embed over data")))
    mp = mesh.axis_size("model")
    if mp > 1:
        if cfg.is_moe and (kind != "train" or cfg.n_experts % mp):
            parts.append(dict(part="MoE expert banks", detail=(
                "whole over the model axis, as the reference's TP serving "
                "runs 3-D weights unsharded (repro/distributed/tp.py:331); "
                "the reference's dry run places them by the training spec, "
                "experts over model" if kind != "train" else
                f"whole over the model axis: {cfg.n_experts} experts do not "
                f"divide over {mp} ranks")))
        if kind == "train" and cfg.n_codebooks:
            parts.append(dict(part="whole-vocab loss", detail=(
                "the audio head's columns (vocab x n_codebooks) are not "
                "whole vocab slices of each codebook: the loss gathers the "
                "logits over the model axis, where the reference keeps "
                "them sharded over act_vocab")))
        if cfg.family in T.SSD_FAMILIES:
            parts.append(dict(part="SSD blocks", detail=(
                "whole on every rank, as the reference's tp.linear runs "
                "them unsharded")))
    if n_rows == batch and batch > 1 and batch % (mesh.size // mp):
        parts.append(dict(part="batch", detail=(
            f"{batch} rows do not divide over the data axes: every rank "
            f"holds them all")))
    return parts


def _seq_parts(cfg: ModelConfig, ctx, batch: int, seq: int
               ) -> List[Dict[str, str]]:
    """Under sequence parallelism (``tp.seq_parallel``): each interior
    tensor that the reference constrains by its rules (``shard(...)`` at
    the sites named) and the port places otherwise. The port gathers a
    block's input over the sequence and runs the interior on every row,
    cut by heads, d_ff or vocab where its weights are (Megatron SP), while
    the reference's spec cuts the sequence wherever the feature dim leaves
    the model axis free."""
    if ctx is None or not TP.seq_parallel(ctx, seq, batch, cfg.d_model):
        return []
    rules, m = ctx.rules, ctx.model_axis
    b = rules.spec(("act_batch",), (batch,))[0]
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shard_q, shard_kv = TP.head_sharding(ctx, H, Hkv)
    kv_slice = TP.kv_group_slice(ctx, H, Hkv)
    ssd = cfg.family in T.SSD_FAMILIES
    blocks = not ssd or cfg.attn_every        # attention + MLP blocks
    sites = []
    if blocks and not cfg.is_mla:
        q_cut = m if shard_q or kv_slice is not None else None
        sites += [("q", "models/layers.py:216",
                   ("act_batch", "act_seq", "act_heads", None),
                   (batch, seq, H, dh), (b, None, q_cut, None))]
        sites += [(n, f"models/layers.py:{line}",
                   ("act_batch", "act_seq", "act_kv_heads", None),
                   (batch, seq, Hkv, dh), (b, None, m if shard_kv else None,
                                           None))
                  for n, line in (("k", 217), ("v", 218))]
    if blocks and (not cfg.is_moe or cfg.n_shared_experts
                   or cfg.first_dense_layers):
        f = cfg.d_ff
        glu = 2 if cfg.mlp_act == "swiglu" else 1
        h_cut = TP.param_cut(ctx, ("embed", "mlp"), (D, glu * f),
                             blocks=glu) is not None
        sites.append(("MLP hidden h", "models/layers.py:454",
                      ("act_batch", "act_seq", "act_mlp"), (batch, seq, f),
                      (b, None, m if h_cut else None)))
    if ssd:
        sites += [(f"SSD {n}", f"models/ssm.py:{line}",
                   ("act_batch", "act_seq", "act_mlp"),
                   (batch, seq, cfg.d_inner), (b, None, None))
                  for n, line in (("xc", 169), ("y", 197))]
    V = cfg.vocab * max(cfg.n_codebooks, 1)
    v_cut = TP.param_cut(ctx, ("embed", "vocab"), (D, V)) is not None
    sites.append(("logits", "models/transformer.py:307",
                  ("act_batch", "act_seq", "act_vocab"), (batch, seq, V),
                  (b, None, m if v_cut else None)))
    parts = []
    for name, site, logical, shape, port in sites:
        ref = tuple(rules.spec(logical, shape))
        if ref != port:
            how = (" (whole; each rank reads its query groups' KV heads, "
                   "tp.kv_group_slice)" if name in ("k", "v") and kv_slice
                   else "")
            parts.append(dict(part=f"sequence parallelism: {name}", detail=(
                f"the reference's spec at src/repro/{site} is {ref}; the "
                f"port gathers the block's input over the sequence and "
                f"holds {port}{how}")))
    return parts


def _check_batch_and_cache_specs(cfg: ModelConfig, ctx, mesh, batch: int,
                                 rows: int, seq: int) -> None:
    """Raise where the rank's rows of the batch (cut over pod x data) and
    its cut of a KV cache's sequence take the same mesh axis: the cache
    spec then holds every row whole (the sequence ranks first), the batch
    spec only the rank's."""
    if ctx is None or rows == batch:
        return
    leaf = T.cache_leaf(cfg, batch, seq)
    cut = TP.seq_cut(ctx, *leaf)
    batch_axes = {a for a in ("pod", "data") if mesh.axis_size(a) > 1}
    if cut is not None and set(cut.axes) & batch_axes:
        bspec = ctx.rules.spec(["act_batch", None], (batch, seq))
        cspec = shd.cache_spec(ctx.rules, *leaf)
        raise ValueError(
            f"the batch spec {bspec} cuts {batch} rows over {sorted(batch_axes)}"
            f" and the KV cache spec {cspec} cuts the sequence over "
            f"{cut.axes} with every row whole: both cannot hold")


def run_step(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
             mesh: Optional[Mesh] = None, shape_name: Optional[str] = None,
             rules_overrides=None, attention: Optional[AttentionPolicy] = None,
             pack_weights: bool = False, n_pages: Optional[int] = None,
             compress_grads: bool = False) -> dict:
    """One ``kind`` step ("train", "prefill", "decode"; "forward": an
    encoder's forward) of ``cfg`` at a global ``batch`` of ``seq`` tokens
    (decode: a ``seq``-token cache) on
    ``meta``, at the shapes of ``mesh``'s rank (None: one device). A
    paged ``attention`` policy gives the serving steps page pools of
    ``n_pages`` pages (default: every row's ``seq`` tokens) and block
    tables; ``pack_weights`` packs the GEMM weights block-major as the
    serving engine does; ``compress_grads`` turns on the train step's int8
    gradient compression. Returns memory, cost, collectives (also by the
    axes each went over), launches, roofline and the parts that differ
    from the reference."""
    model = 1 if mesh is None else mesh.axis_size("model")
    n_rows_axes = 1 if mesh is None else mesh.size // model
    # the cell's rules: long_500k cuts the KV caches' sequence over data
    ctx = ST.serve_context(cfg, mesh, SHAPES.get(shape_name),
                           rules_overrides)
    rows = batch // n_rows_axes if batch % n_rows_axes == 0 else batch
    parts = _placement_parts(cfg, mesh, shape_name, kind, batch, rows)
    if kind in ("prefill", "decode"):
        _check_batch_and_cache_specs(cfg, ctx, mesh, batch, rows, seq)
    fsdp = kind == "train" and mesh is not None and mesh.axis_size("data") > 1
    if kind == "train":            # FSDP over data, slices over model
        params = ST.rank_params(cfg, T.init_model(cfg, device=META), mesh)
    else:                          # serving: whole over data
        params = TP.shard_params(T.init_model(cfg, device=META),
                                 param_axes(cfg), ctx,
                                 units=TP.head_units(cfg))
    if cfg.is_mla and TP.latent_up_whole(ctx):
        held = _leaves_named(params, "wkv_b")
        parts.append(dict(part="MLA up-projection wkv_b", detail=(
            f"whole on every rank of the model axis, {_tree_bytes(held)} B "
            f"a rank ({len(held)} layers of {tuple(held[0].shape)}), where "
            f"the reference cuts it by heads: the rules cut the latent "
            f"cache's sequence over the model axis (act_kv_seq), which the "
            f"query heads take too, so a rank up-projects every head over "
            f"its own columns, gathers the queries and keeps its heads of "
            f"the merged attention")))
    if pack_weights:
        params = api.pack_model_weights(params)
    dt = cfg.param_dtype
    notes = ["attention counts every key in memory (positions and lengths "
             "are data): a bound on what a run's data needs"]

    if kind == "train":
        if cfg.family in T.SSD_FAMILIES:
            parts.append(dict(part="SSD scan under autograd", detail=(
                "the card has no backward of K6 (train/loop.py::"
                "check_trainable refuses it); counted as the plain scan, "
                "the CPU's training route")))
        # the step cuts its rows over pod x data
        parts += _seq_parts(cfg, ctx, batch, seq)
        glob = SP.token_specs(cfg, rows * n_rows_axes if rows != batch
                              else batch, seq)
        opt = adamw_init(params)
        step = ST.make_train_step_fn(
            cfg, AdamWConfig(compress_grads=compress_grads), mesh=mesh,
            rules_overrides=rules_overrides)
        args = (params, opt, ST.data_shard(glob, mesh))

        def call():
            with api.use_attention_policy(UNFUSED):
                return step(params, opt, glob)
        caches = None
    elif kind == "forward":            # the encoders: no cache, no loss
        b = SP.token_specs(cfg, rows, seq)
        args = (params, b)
        caches = None

        def call():
            with torch.no_grad():
                return T.encoder_forward(params, cfg, b)
    else:
        paged = attention is not None and attention.backend == "paged"
        if paged:
            ps = attention.page_size
            nb = -(-seq // ps)
            caches = T.init_paged_caches(
                cfg, rows, n_pages or rows * nb, ps, dt, META, tpctx=ctx,
                kv_dtype=attention.kv_dtype)
            tables = torch.empty((rows, nb), dtype=torch.int32, device=META)
        else:
            caches = T.init_caches(cfg, rows, seq, dt, META, tpctx=ctx)
            tables = None
        if kind == "prefill":
            b = dict(SP.token_specs(cfg, rows, seq))
            b["positions"] = torch.empty((rows, seq), dtype=torch.int32,
                                         device=META)
            if tables is not None:
                b["block_tables"] = tables
            step = make_prefill_step(cfg, attn=attention, tpctx=ctx)
            args = (params, b, caches)

            def call():
                with torch.no_grad():
                    return step(params, b, caches)
        else:
            tok = (rows, 1, cfg.n_codebooks) if cfg.n_codebooks else (rows, 1)
            toks = torch.empty(tok, dtype=torch.int32, device=META)
            pos = torch.empty((rows, 1), dtype=torch.int32, device=META)
            step = make_decode_step(cfg, attn=attention, tpctx=ctx)
            args = (params, toks, pos, caches, tables)

            def call():
                with torch.no_grad():
                    return step(params, toks, pos, caches, tables)
        sink = _sink_bytes(caches)
        if sink:
            parts.append(dict(part="cache write sink", bytes=sink, detail=(
                "one column past max_len of each contiguous cache, one page "
                "past each pool: masked positions write there (the "
                "reference drops those writes)")))

    argument = _tree_bytes(args)
    ledger = RA.CostLedger()
    counter = OpCounter()
    before, axes_before = TP.collectives.snapshot(), TP.collectives.by_axes(mesh)
    t0 = time.perf_counter()
    with RA.use_ledger(ledger), counter:
        out = call()
    run_s = time.perf_counter() - t0
    after = TP.collectives.snapshot()
    by_axes = {}
    for key, v in TP.collectives.by_axes(mesh).items():
        was = axes_before.get(key, {"calls": 0, "bytes": 0})
        if v["calls"] > was["calls"]:
            by_axes[key] = {k: v[k] - was[k] for k in v}
    coll = RA.collective_bytes_from_counts(
        {k: {kind_: after[k][kind_] - before[k][kind_] for kind_ in after[k]}
         for k in after})
    flops_by_dtype = dict(counter.flops_by_dtype)
    for d, f in ledger.flops_by_dtype.items():
        flops_by_dtype[d] = flops_by_dtype.get(d, 0.0) + f
    flops = sum(flops_by_dtype.values())
    nbytes = counter.bytes + ledger.bytes
    mem = describe_memory({"argument_size_in_bytes": argument,
                           "output_size_in_bytes": _tree_bytes(out),
                           "temp_size_in_bytes": counter.peak})
    n_params = count_params_abstract_cfg(cfg)
    n_chips = 1 if mesh is None else mesh.size
    n_tok = batch * (seq if kind != "decode" else 1)
    mf = RA.model_flops_estimate(active_params(cfg, n_params), n_tok,
                                 "train" if kind == "train" else "infer")
    terms = RA.roofline_terms({"flops": flops, "bytes accessed": nbytes,
                               "flops_by_dtype": flops_by_dtype},
                              coll["total"], model_flops=mf / n_chips)
    return {
        "kind": kind, "n_chips": n_chips, "n_params": n_params,
        "run_s": round(run_s, 2),
        "memory": mem,
        "cost": {"flops": flops, "bytes accessed": nbytes,
                 "transcendentals": counter.transcendentals
                 + ledger.transcendentals,
                 "flops_by_dtype": flops_by_dtype,
                 "kernel_flops": ledger.flops, "kernel_bytes": ledger.bytes,
                 "elementwise_flops": counter.elementwise_flops,
                 "aten_ops": counter.ops},
        "collectives": {"total": coll["total"],
                        **{k: v for k, v in coll.items()
                           if k not in ("total", "counts")}},
        "collective_counts": coll["counts"],
        "collectives_by_axes": by_axes,
        "launches": ledger.launches,
        "launches_marked": ledger.marked,
        "kv_cache_bytes": _kv_bytes(caches),
        "roofline": terms,
        "fsdp": fsdp,
        "parts_from_reference": parts,
        "notes": notes,
    }


def launch_counters(res: Dict) -> Dict[str, int]:
    """A result's launches under the names of the card's launch counters
    (``chip_smoke.py::kernel_wrappers``): ``kernel`` for the total,
    ``kernel_route`` by route, ``kernel_mark`` for a mark (K1's
    ``matrixflow_gemm_batched``, ``matrixflow_gemm_backward``)."""
    flat: Dict[str, int] = {}
    for kernel, by_route in res["launches"].items():
        flat[kernel] = sum(by_route.values())
        flat.update({f"{kernel}_{r}": n for r, n in by_route.items()})
    for kernel, by_mark in res["launches_marked"].items():
        flat.update({f"{kernel}_{m}": n for m, n in by_mark.items()})
    return flat


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                rules_overrides=None, verbose: bool = True,
                skip_body_probe: bool = False, compress_grads: bool = False):
    """The cell's step on ``meta`` at rank 0 of the abstract production
    mesh (``compress_grads``: a train cell's step compresses its
    gradients to int8). ``skip_body_probe`` is the reference's flag,
    accepted and ignored (the eager port walks every layer).
    ``rules_overrides`` layer on the config's rules, as the reference's
    ``benchmarks/hillclimb.py`` arms set them: ``{"act_seq": "model"}``
    (``seqpar``) runs a train cell sequence-parallel; an ``act_batch``
    rule (``batch2d``) raises NotImplementedError."""
    ST.check_ported_rules(dict(rules_overrides or {}))
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not cell_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch at 500k decode (DESIGN §3)"}
    mesh = Mesh.abstract(*production_mesh_shape(multi_pod=multi_pod))
    res = run_step(cfg, shape.kind, shape.batch, shape.seq, mesh=mesh,
                   shape_name=shape_name, rules_overrides=rules_overrides,
                   compress_grads=compress_grads)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16", **res}
    if verbose:
        terms, mem = res["roofline"], res["memory"]
        print(f"[dryrun] {arch} × {shape_name} × {result['mesh']}: "
              f"run {res['run_s']:.1f}s, bottleneck={terms['bottleneck']}, "
              f"t=({terms['t_compute_s']:.2e},{terms['t_memory_s']:.2e},"
              f"{terms['t_collective_s']:.2e})s "
              f"frac={terms['roofline_fraction']:.3f}")
        print(f"  memory: {mem}")
        print(f"  cost: flops={res['cost']['flops']:.3e}/chip "
              f"bytes={res['cost']['bytes accessed']:.3e}/chip "
              f"coll={res['collectives']['total']:.3e}B/chip; launches "
              f"{res['launches']}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-body-probe", action="store_true",
                    help="accepted and ignored: the eager port walks every "
                         "layer, so no body probe runs")
    ap.add_argument("--compress-grads", action="store_true",
                    help="train cells compress their gradients to int8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a, s in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results, failures = [], 0
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                r = dryrun_cell(arch, shape_name, multi_pod=mp,
                                compress_grads=args.compress_grads)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                r = {"arch": arch, "shape": shape_name,
                     "mesh": "2x16x16" if mp else "16x16",
                     "error": f"{type(e).__name__}: {e}"}
                failures += 1
            results.append(r)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
    print(f"[dryrun] {len(results)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
