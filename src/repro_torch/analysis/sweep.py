"""Contract sweep: every registered backend × the parity shape/dtype grid,
and every config of the registry at its published widths
(``repro/analysis/sweep.py``).

For each GEMM backend in the :mod:`repro_torch.core.plan` registry, the
``fused`` and ``paged`` attention backends, and each architecture in
:mod:`repro_torch.configs.registry`, resolve the launch the backend would
make on ``device`` — via :func:`plan` itself for GEMMs, via the wrappers'
own route choosers for attention and the SSD scan — and run its registered
:class:`~repro_torch.analysis.kernel_contracts.KernelContract` through
:func:`check_contract`. The default device is ``"cuda"``: the card's
routes, grids and clusters, worked out on any machine without a card.
Zero violations across the whole sweep is the gate
``python -m repro_torch.analysis --all-backends`` enforces.

The shape/dtype grids MIRROR ``tests/parity.py`` (SHAPES / DTYPES /
ATTN_CASES / ATTN_PAGE_SIZE), as the reference's do: the static pass
covers the cells the differential harness proves at runtime. On the card
the flash kernel is built only at :data:`~repro_torch.kernels.
flash_attention.HEAD_DIM_PAIRS`, so its parity cells run at each of those
head dims there instead of the parity grid's :data:`ATTN_HEAD_DIM` (which
the paged kernels' tensor-core instances take).
"""
from __future__ import annotations

import dataclasses
import sys
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.kernel_contracts import (ContractViolation,
                                                   check_contract,
                                                   get_contract_builder)

# -- mirrored from tests/parity.py (drift-guarded by the tests) -------------
GEMM_SHAPES = (
    (8, 8, 8),
    (64, 96, 48),
    (33, 17, 65),
    (1, 64, 128),
    (130, 24, 56),
)
GEMM_DTYPES = ("float32", "bfloat16", "int8")

# (name, B, Sq, T, H, Hkv) of every tests/parity.py AttnCase.
ATTN_CASES = (
    ("prefill_mha", 2, 32, 32, 4, 4),
    ("prefill_gqa_ragged", 2, 33, 33, 4, 2),
    ("decode_long_cache", 3, 1, 96, 4, 2),
    ("decode_masked_rows", 3, 1, 64, 2, 1),
    ("prefill_chunk_offset", 2, 8, 64, 2, 2),
    ("noncausal_ragged", 2, 17, 45, 2, 1),
)
# (causal, q_offsets, kv_lens) of the same cases: what a runtime probe of
# the cells needs besides their shapes.
ATTN_CASE_SEMANTICS = {
    "prefill_mha": (True, None, None),
    "prefill_gqa_ragged": (True, None, None),
    "decode_long_cache": (True, (5, 80, 37), (6, 81, 38)),
    "decode_masked_rows": (True, (12, -1, 3), (13, 0, 4)),
    "prefill_chunk_offset": (True, (24, 40), (32, 48)),
    "noncausal_ragged": (False, None, (45, 29)),
}
ATTN_PAGE_SIZE = 16
ATTN_BLOCK = 32                 # block_q/block_k of the parity cells
ATTN_HEAD_DIM = 16
ATTN_DTYPES = ("float32", "bfloat16")

# The configs' cells: prefill at CONFIG_PREFILL over CONFIG_SEQ keys (the
# reference's), a decode step over CONFIG_DECODE_KEYS keys (the split route
# and its clusters), the decode GEMMs at CONFIG_SLOTS rows, and the SSD
# scan at CONFIG_SEQ steps (walk) and CONFIG_LONG_SEQ (chunks).
CONFIG_SEQ = 256
CONFIG_PREFILL = 128
CONFIG_DECODE_KEYS = 2048
CONFIG_SLOTS = 8
CONFIG_LONG_SEQ = 2048
# K1's mma route is off the serving paths (every bf16 GEMM the port plans
# on the card takes bm 64, core/plan.py::bm_for): one config keeps its
# decode GEMM at bm 16 in the sweep; K2 takes mma at every config's decode.
MMA_ARCHS = ("smollm-135m",)

_TORCH_DTYPES = {"float32": "float32", "bfloat16": "bfloat16",
                 "int8": "int8"}


@dataclasses.dataclass(frozen=True)
class SweepEntry:
    """One checked contract instance."""

    kernel: str
    instance: str               # human-readable cell, e.g. "matrixflow f32 8x8x8"
    violations: Tuple[ContractViolation, ...]
    route: str = ""             # the launch's route ("" for the plain versions)
    # the builder's keyword arguments (with the cell's ``M, N, K`` or
    # ``case`` besides): what a runtime probe of the launch rebuilds
    cell: Dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def ok(self) -> bool:
        return not self.violations


def _dtype(name: str):
    import torch
    return getattr(torch, _TORCH_DTYPES[name])


def _entry(kernel: str, instance: str, contract, route: str,
           cell: Optional[Dict] = None) -> SweepEntry:
    return SweepEntry(kernel, instance, tuple(check_contract(contract)),
                      route, dict(cell or {}))


def _paged_block_tables(B: int, T: int,
                        page_size: int = ATTN_PAGE_SIZE,
                        seed: int = 0, n_distractors: int = 3) -> np.ndarray:
    """The shuffled page assignment of tests/parity.py::make_paged_operands
    (same rng stream), so the checked block table is the one the parity
    cells dispatch."""
    nb = -(-T // page_size)
    P = B * nb + n_distractors
    rng = np.random.default_rng(seed * 31 + B * 101 + T)
    return rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)


def _card(device: str) -> bool:
    import torch
    return torch.device(device).type != "cpu"


def gemm_route(dtype, bm: int, fused: bool, device: str) -> str:
    """The route K1 (K2 with ``fused``) takes for this launch ("" on the
    CPU, where the plain version runs)."""
    from repro_torch.kernels import matrixflow_gemm as MF
    return MF.route_for(dtype, bm, dequant=fused) if _card(device) else ""


def sweep_gemm(backends: Optional[Sequence[str]] = None,
               dtypes: Sequence[str] = GEMM_DTYPES,
               shapes: Sequence[Tuple[int, int, int]] = GEMM_SHAPES,
               device: str = "cuda") -> List[SweepEntry]:
    """Contract-check every layout-bearing GEMM backend's resolved plans on
    ``device``.

    Goes through :func:`repro_torch.core.plan.plan` itself — the sweep
    validates the block choices auto mode makes on that device, not
    hypothetical ones. int8 runs the W8A8 route (K2 on the card). The
    layout-free backend (torch) has no dataflow contract and is skipped.
    """
    from repro_torch.core import plan as P
    if backends is None:
        backends = P.registered_backends()
    entries: List[SweepEntry] = []
    for backend in backends:
        spec = P.get_backend_spec(backend)
        if not spec.needs_layout:
            continue
        builder_name = "blockflow" if backend == "blockflow" \
            else "matrixflow_gemm"
        builder = get_contract_builder(builder_name)
        for dtype in dtypes:
            dt = _dtype(dtype)
            fused = dtype == "int8"
            for (M, K, N) in shapes:
                pol = P.GemmPolicy(backend=backend,
                                   weight_dtype="int8" if fused else None)
                pln = P.plan(M, N, K, dt, pol, device)
                blk = pln.layout
                nbm, nbn, nbk = (-(-M // blk.bm), -(-N // blk.bn),
                                 -(-K // blk.bk))
                route = ""
                if backend == "blockflow":
                    cell = dict(nbm=nbm, nbn=nbn, nbk=nbk, device=device)
                else:
                    route = gemm_route(dt, blk.bm, fused, device)
                    cell = dict(a_shape=(nbm, nbk, blk.bm, blk.bk),
                                b_shape=(nbn, nbk, blk.bk, blk.bn),
                                blk=blk, fused=fused, device=device, dtype=dt)
                entries.append(_entry(
                    builder_name,
                    f"{backend} {dtype} {M}x{K}x{N} "
                    f"blk=({blk.bm},{blk.bn},{blk.bk})/{pln.mode}",
                    builder(**cell), route, dict(cell, M=M, N=N, K=K)))
    return entries


def attention_route(kernel: str, dtype, Sq: int, rep: int, kv_dtype,
                    device: str) -> str:
    from repro_torch.kernels import flash_attention as FA
    if not _card(device):
        return ""
    return FA.route_for(dtype, Sq, rep, kv_dtype)


def card_head_dims(device: str) -> Tuple[Tuple[int, int], ...]:
    """The (head_dim, v head_dim) pairs the flash cells run at: the parity
    grid's on the CPU, every pair the card's kernel is built for on it."""
    from repro_torch.kernels import flash_attention as FA
    if _card(device):
        return FA.HEAD_DIM_PAIRS
    return ((ATTN_HEAD_DIM, ATTN_HEAD_DIM),)


def sweep_attention(cases: Sequence[Tuple] = ATTN_CASES,
                    page_size: int = ATTN_PAGE_SIZE,
                    device: str = "cuda",
                    dtypes: Sequence[str] = ATTN_DTYPES) -> List[SweepEntry]:
    """Contract-check the ``fused`` (K3) and ``paged`` (K4, and K5 over
    int8 pages) attention kernels over the parity attention cases in each
    of ``dtypes`` (q's) — the paged cells against the same shuffled block
    tables the runtime parity cells scatter into."""
    flash = get_contract_builder("flash_attention")
    paged = get_contract_builder("paged_attention")
    entries: List[SweepEntry] = []
    for (name, B, Sq, T, H, Hkv) in cases:
        rep = H // Hkv
        for dtype in dtypes:
            dt = _dtype(dtype)
            for D, Dv in card_head_dims(device):
                cell = dict(B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=T, D=D, Dv=Dv,
                            block_q=ATTN_BLOCK, block_k=ATTN_BLOCK,
                            device=device, dtype=dt)
                entries.append(_entry(
                    "flash_attention", f"fused {dtype} {name} D={D}/{Dv}",
                    flash(**cell),
                    attention_route("flash_attention", dt, Sq, rep, dt,
                                    device), dict(cell, case=name)))
            bt = _paged_block_tables(B, T, page_size)
            P_pages = B * bt.shape[1] + 3
            for quantized in (False, True):
                cell = dict(B=B, Sq=Sq, H=H, Hkv=Hkv, D=ATTN_HEAD_DIM,
                            Dv=ATTN_HEAD_DIM, P=P_pages, page_size=page_size,
                            block_tables=bt, block_q=ATTN_BLOCK,
                            quantized=quantized, device=device, dtype=dt)
                suffix = " int8-kv" if quantized else ""
                entries.append(_entry(
                    "paged_attention", f"paged {dtype} {name}{suffix}",
                    paged(**cell),
                    attention_route("paged_attention", dt, Sq, rep,
                                    None if quantized else dt, device),
                    dict(cell, case=name)))
    return entries


def attention_geometry(cfg) -> Optional[Tuple[int, int, int, int]]:
    """(H, Hkv, q/k head dim, v head dim) of the attention a config serves
    with, as the port runs it: MLA's per-head (nope + rope, v) dims over
    its heads; None for a family without attention (mamba2)."""
    if cfg.family == "ssm":
        return None
    if cfg.is_mla:
        return (cfg.n_heads, cfg.n_heads,
                cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


def _config_gemms(cfg, device: str, builder) -> List[SweepEntry]:
    """A decode step's output projection (CONFIG_SLOTS rows, N = d_model,
    K = the heads' width) as the card plans it: K1 in bf16 (wgmma at bm
    64), K2 in int8 (mma, K split over a cluster); for MMA_ARCHS also K1
    at bm 16 (its mma route)."""
    import torch
    from repro_torch.core import layout as L
    from repro_torch.core import plan as P
    H, _, D, Dv = attention_geometry(cfg) or (cfg.ssm_heads, 0, 0,
                                             cfg.ssm_head_dim)
    M, N, K = CONFIG_SLOTS, cfg.d_model, H * Dv
    out = []
    cells = ((torch.bfloat16, False, None),
             (torch.bfloat16, False, L.BM_CHOICES[0]),
             (torch.int8, True, None))
    if not _card(device) or cfg.name not in MMA_ARCHS:
        cells = cells[::2]
    for dt, fused, bm in cells:
        pol = P.GemmPolicy(backend="matrixflow",
                           weight_dtype="int8" if fused else None)
        blk = P.plan(M, N, K, dt, pol, device).layout
        if bm is not None:
            blk = dataclasses.replace(blk, bm=bm)
        nbm, nbn, nbk = -(-M // blk.bm), -(-N // blk.bn), -(-K // blk.bk)
        cell = dict(a_shape=(nbm, nbk, blk.bm, blk.bk),
                    b_shape=(nbn, nbk, blk.bk, blk.bn), blk=blk,
                    fused=fused, device=device, dtype=dt)
        out.append(_entry(
            "matrixflow_gemm",
            f"config {cfg.name} decode {'int8 ' if fused else ''}"
            f"{M}x{K}x{N} bm={blk.bm}", builder(**cell),
            gemm_route(dt, blk.bm, fused, device),
            dict(cell, M=M, N=N, K=K)))
    return out


def sweep_configs(archs: Optional[Sequence[str]] = None,
                  device: str = "cuda") -> List[SweepEntry]:
    """Contract-check every architecture in the configs/ registry at its
    published widths: the attention each config serves with (K3 at a
    prefill and a decode step, K4 and K5 at the decode step over a paged
    cache), its decode GEMMs (K1, K2), and the SSD scan of the SSM and
    hybrid families (K6: each launch of the walk and chunks routes)."""
    import torch
    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.kernels import ssd_scan as K6
    flash = get_contract_builder("flash_attention")
    paged = get_contract_builder("paged_attention")
    gemm = get_contract_builder("matrixflow_gemm")
    ssd = get_contract_builder("ssd_scan")
    dt = torch.bfloat16 if _card(device) else torch.float32
    entries: List[SweepEntry] = []
    for arch in (archs if archs is not None else sorted(ARCHS)):
        cfg = get_config(arch)
        geo = attention_geometry(cfg)
        if geo is not None:
            H, Hkv, D, Dv = geo
            for tag, Sq, Sk in (("prefill", CONFIG_PREFILL, CONFIG_SEQ),
                                ("decode", 1, CONFIG_DECODE_KEYS)):
                cell = dict(B=1, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, Dv=Dv,
                            block_q=128, block_k=128, device=device,
                            dtype=dt)
                entries.append(_entry(
                    "flash_attention",
                    f"config {arch} {tag} H={H} Hkv={Hkv} D={D}/{Dv}",
                    flash(**cell),
                    attention_route("flash_attention", dt, Sq, H // Hkv, dt,
                                    device), cell))
            if not cfg.is_mla and cfg.family not in ("ssm", "hybrid"):
                ps = ATTN_PAGE_SIZE
                nb = CONFIG_DECODE_KEYS // ps
                bt = np.arange(nb, dtype=np.int32)[None]
                for quantized in (False, True):
                    cell = dict(B=1, Sq=1, H=H, Hkv=Hkv, D=D, Dv=Dv, P=nb,
                                page_size=ps, block_tables=bt,
                                quantized=quantized, device=device, dtype=dt)
                    entries.append(_entry(
                        "paged_attention",
                        f"config {arch} decode{' int8-kv' if quantized else ''}"
                        f" H={H} Hkv={Hkv} D={D}", paged(**cell),
                        attention_route("paged_attention", dt, 1, H // Hkv,
                                        None if quantized else dt, device),
                        cell))
        entries += _config_gemms(cfg, device, gemm)
        if cfg.ssm_state > 0:
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            # bf16 at both lengths (walk, chunks); fp32 (the CUDA cores on
            # the card) at the shorter
            cells = [(dt, CONFIG_SEQ), (dt, CONFIG_LONG_SEQ)]
            if _card(device):
                cells.append((torch.float32, CONFIG_SEQ))
            for sdt, S in cells:
                launches = (K6.route_launches(sdt, S, P, N)
                            if _card(device) else ("",))
                for launch in launches:
                    cell = dict(B=1, S=S, H=H, P=P, N=N, chunk=128,
                                device=device, dtype=sdt,
                                launch=launch or None)
                    route = (K6.route_for(sdt, S, P, N) if _card(device)
                             else "")
                    entries.append(_entry(
                        "ssd_scan",
                        f"config {arch} {str(sdt)[6:]} S={S} N={N} "
                        f"{launch}".rstrip(), ssd(**cell), route, cell))
    return entries


# K3 with its log-sum-exp at a rank's shape of a cut cache, on each route:
# the decode step (split), a 64-row prefill chunk (rows) and fp32 (the CUDA
# cores). The cells whose rules cut a cache's sequence: zamba2-2.7b at
# long_500k on the 16 x 16 mesh (2 of its 32 heads a rank, 32,768 of
# 524,288 keys) and deepseek-v2-236b's latent at decode_32k under the
# kvseq arm's act_kv_seq -> model (8 rows a rank, every one of its 128
# heads at (192, 128), 2,048 of 32,768 keys).
LSE_ARCH, LSE_SHAPE, LSE_PREFILL = "zamba2-2.7b", "long_500k", 64
LSE_CELLS = ((LSE_ARCH, LSE_SHAPE, None),
             ("deepseek-v2-236b", "decode_32k", {"act_kv_seq": "model"}))


def lse_rank_shape(arch: str = LSE_ARCH, shape_name: str = LSE_SHAPE,
                   overrides: Optional[Dict] = None):
    """(B, H, Hkv, D, keys) a rank of the production mesh attends with
    over its cut of the cell's KV caches (``tp.seq_cut``,
    ``tp.head_sharding``, the cell's rules with ``overrides``): its rows
    of the batch, its heads (MLA: every head where the latent's cut
    takes the model axis, ``tp.latent_up_whole``), the q/k head dim and
    its columns."""
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import Mesh, production_mesh_shape
    from repro_torch.models import transformer as T
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = Mesh.abstract(*production_mesh_shape())
    ctx = ST.serve_context(cfg, mesh, shape, overrides)
    cut = T.cache_seq_cut(cfg, shape.batch, shape.seq, ctx)
    rows = mesh.size // ctx.model_size
    B = shape.batch // rows if shape.batch % rows == 0 else shape.batch
    _, shard_kv = TP.head_sharding(ctx, cfg.n_heads, cfg.n_kv_heads)
    if cfg.is_mla:
        mp = 1 if TP.latent_up_whole(ctx) or not shard_kv \
            else ctx.model_size
        D = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    else:
        mp = ctx.model_size if shard_kv else 1
        D = cfg.head_dim
    return (B, cfg.n_heads // mp, cfg.n_kv_heads // mp, D,
            cut.cols if cut is not None else shape.seq)


def sweep_lse(device: str = "cuda") -> List[SweepEntry]:
    """Contract-check K3 with its log-sum-exp output at
    :func:`lse_rank_shape` of each of :data:`LSE_CELLS` on each route."""
    import torch
    from repro_torch.configs.registry import get_config
    flash = get_contract_builder("flash_attention")
    entries = []
    for arch, shape_name, overrides in LSE_CELLS:
        B, H, Hkv, D, keys = lse_rank_shape(arch, shape_name, overrides)
        cfg = get_config(arch)
        Dv = cfg.v_head_dim if cfg.is_mla else D
        for tag, Sq, dt in (("decode", 1, torch.bfloat16),
                            (f"prefill {LSE_PREFILL}", LSE_PREFILL,
                             torch.bfloat16),
                            ("decode fp32", 1, torch.float32)):
            if not _card(device) and dt != torch.float32:
                continue
            cell = dict(B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=keys, D=D, Dv=Dv,
                        block_q=128, block_k=128, device=device, dtype=dt,
                        lse=True)
            entries.append(_entry(
                "flash_attention",
                f"lse {arch} {shape_name} rank {tag} B={B} H={H} "
                f"Hkv={Hkv} D={D} Dv={Dv} keys={keys}", flash(**cell),
                attention_route("flash_attention", dt, Sq, H // Hkv, dt,
                                device),
                cell))
    return entries


def count_by_route(entries: Sequence[SweepEntry]) -> Dict[str, int]:
    """Contract instances by kernel and route ("kernel/route")."""
    return dict(sorted(Counter(
        f"{e.kernel}/{e.route or 'plain'}" for e in entries).items()))


def run_sweep(*, gemm_backends: Optional[Sequence[str]] = None,
              dtypes: Sequence[str] = GEMM_DTYPES,
              include_configs: bool = True, device: str = "cuda",
              out=sys.stdout) -> Tuple[List[SweepEntry], int]:
    """The full sweep on ``device``; prints the violation report and the
    count of instances by kernel and route, and returns (entries,
    total_violations)."""
    entries = sweep_gemm(gemm_backends, dtypes, device=device)
    entries += sweep_attention(device=device)
    if include_configs:
        entries += sweep_configs(device=device)
        entries += sweep_lse(device=device)
    n_bad = 0
    for e in entries:
        status = "OK " if e.ok else "FAIL"
        print(f"contract {status} {e.kernel:17s} {e.route or 'plain':10s} "
              f"{e.instance}", file=out)
        for viol in e.violations:
            n_bad += 1
            print(f"  {viol}", file=out)
    for key, n in count_by_route(entries).items():
        print(f"contracts {key}: {n}", file=out)
    print(f"analysis: {len(entries)} contract instances on {device}, "
          f"{n_bad} violation(s)", file=out)
    return entries, n_bad
