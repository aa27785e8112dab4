"""Paged (block-table) flash attention: wrapper of the CUDA kernels in
``csrc/paged_attention.cu``, which replace the Pallas TPU kernel
``repro/kernels/paged_attention.py::_kernel`` — for fp32/bf16 pools (K4)
and its int8 branch (K5: int8 pools with one fp32 scale per (page, kv
head)).

K/V live in a pool of fixed-size pages; each request owns a block table
mapping its logical key blocks to physical pages. The key-block size IS the
page size. ``cols`` are logical positions: the table redirects only the
fetch, never the masking. For tensors on the CPU :func:`paged_attention`
runs :func:`paged_attention_plain`, the same online-softmax recurrence in
PyTorch, one page at a time; for CUDA tensors it launches the kernel or
raises. ``paged_attention.launches`` counts K4's launches (fp pools) and
``paged_attention.launches_int8`` K5's (int8 pools).

K4 and K5 take the routes of K3 (``kernels/flash_attention.py::
route_for``, on the same tensor-core warp tile, ``csrc/attn_mma.cuh``) by
q's dtype, counted in ``paged_attention.launches_by_route`` (K4) and
``paged_attention.launches_int8_by_route`` (K5): bf16 q on ``split``
(decode: the keys of each (batch row, kv head) split over warps and
cluster CTAs, :func:`~repro_torch.kernels.flash_attention.split_count`)
or ``rows`` (prefill buckets, chunks), fp32 q on ``cuda_cores`` (over
bf16 pools, an fp32 model with a bf16 cache, on ``cuda_cores_bf16kv``;
bf16 q over fp32 pools is cast up to fp32 and its output back). On both
bf16 routes a CTA holds one m16 tile of rows and walks its keys the same
way, so a row gets the same bits on either (below 512 keys, where the
split route takes one CTA a tile): a preempted request's re-prefill and a
prefix-cache hit keep the stream a solo run gives. Rows are flat (query
position x the heads of a group), so any GQA group fits. Over int8 pools
the tensor-core kernels stage the int8 rows as they are and convert them
to bf16 in shared memory; p is not rounded before P·V.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) the wrapper takes
the route the card would take, records that launch and its least work
(``roofline.launch_cost``, every page of the table: lengths are data) in
the active cost ledger, and returns an empty ``meta`` result. Nothing
launches there, so the launch counters do not move: they count real
launches only.

:func:`paged_attention_contract` (registered as ``"paged_attention"``)
states each route's launch grid and the pages every CTA reads through the
block table, for the static checker (``analysis/kernel_contracts.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import (KernelContract,
                                                   OperandSpec, Precondition,
                                                   register_contract, require)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (MAX_SPLITS, MIXED_ROUTE,
                                                 ROUTES, _aligned,
                                                 attention_contract,
                                                 attention_preconditions,
                                                 check_dtypes, route_for,
                                                 split_count)
from repro_torch.kernels.forward_only import refuse_grad
from repro_torch.roofline import analysis as RA

NEG_INF = -1e30
# Limits of the kernels' tiling (csrc/paged_attention.cu).
MAX_PAGE_SIZE = 32
MAX_HEAD_DIM = 128
# The tensor-core instances (bf16 pools): page sizes, head dims a multiple
# of TC_HEAD_DIM_STEP up to MAX_HEAD_DIM, block-table entries a CTA copies.
TC_PAGE_SIZES = (8, 16, 32)
TC_HEAD_DIM_STEP = 16
MAX_TABLE = 4096

# The CUDA-core kernel's pool codes: fp32 and bf16 pages (K4), int8 (K5).
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if lib.paged_attention.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention.argtypes = [
            i, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            i, i, i, i, i, i, i, i, f, f, i, vp]
        lib.paged_attention.restype = ctypes.c_int
        lib.paged_attention_tc.argtypes = [
            i, i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, f, f,
            i, vp]
        lib.paged_attention_tc.restype = ctypes.c_int
        lib.pa_error_string.argtypes = [i]
        lib.pa_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_plain(q, k_pages, v_pages, block_tables, q_positions,
                          kv_valid_len, *, causal: bool, scale: float,
                          soft_cap: Optional[float],
                          kv_scales=None) -> torch.Tensor:
    """The kernels' recurrence in PyTorch (the plain version of K4 and K5).

    Arguments as :func:`paged_attention` after its defaults are resolved
    (``kv_valid_len`` clamped to nb * ps). Key block j is page
    ``block_tables[:, j]``; an int8 page is dequantized to fp32 by its
    (page, kv head) scales from ``kv_scales``; fp32 online softmax, p
    zeroed where invalid, p rounded to the dtype of the V block (the fp
    pool's; fp32 for a dequantized int8 page) before P·V, flush by
    max(l, 1e-30).
    """
    B, Sq, H, D = q.shape
    _, ps, Hkv, Dv = v_pages.shape
    rep = H // Hkv
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3)                      # (B, H, Sq, D)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=dev)
    l_sum = torch.zeros((B, H, Sq, 1), device=dev)
    acc = torch.zeros((B, H, Sq, Dv), device=dev)
    qpos = q_positions[:, None, :, None]                     # (B, 1, Sq, 1)
    kvlen = kv_valid_len[:, None, None, None]
    p_dtype = torch.float32 if kv_scales is not None else v_pages.dtype
    for j in range(block_tables.shape[1]):
        pages = block_tables[:, j].long()
        kb, vb = k_pages[pages], v_pages[pages]        # (B, ps, Hkv, D)
        if kv_scales is not None:
            kb = kb.float() * kv_scales[0][pages][:, None, :, None]
            vb = vb.float() * kv_scales[1][pages][:, None, :, None]
        kb = kb.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
        vb = vb.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
        s = torch.matmul(qf, kb.float().transpose(-1, -2)) * scale
        if soft_cap:
            s = soft_cap * torch.tanh(s / soft_cap)
        cols = j * ps + torch.arange(ps, device=dev)
        valid = cols < kvlen
        if causal:
            valid = valid & (cols <= qpos)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(p_dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def launch_preconditions(route: str, ps: int, D: int, Dv: int, nb: int,
                         splits: int = 1) -> Tuple[Precondition, ...]:
    """The geometry the card's kernels take: the CUDA-core kernel's limits,
    the tensor-core kernels' (K4 over bf16 pools, K5 over int8 pools, both
    with bf16 q) on their routes, and the split count. The guards the
    wrapper raises and the contract states."""
    tc = route in ("rows", "split")
    return (
        Precondition.check(
            "kernel limits", ps <= MAX_PAGE_SIZE and max(D, Dv) <= MAX_HEAD_DIM,
            f"page_size={ps}, head dims ({D}, {Dv}) exceed the kernel's "
            f"limits ({MAX_PAGE_SIZE}, {MAX_HEAD_DIM})"),
        Precondition.check(
            "tensor-core geometry",
            not tc or (ps in TC_PAGE_SIZES and not D % TC_HEAD_DIM_STEP
                       and Dv == D and nb <= MAX_TABLE),
            f"page_size={ps}, head dims ({D}, {Dv}), {nb} table entries: the "
            f"bf16 kernels take page_size in {TC_PAGE_SIZES}, equal head dims "
            f"a multiple of {TC_HEAD_DIM_STEP} up to {MAX_HEAD_DIM} and at "
            f"most {MAX_TABLE} entries"),
        Precondition.check(
            "split count", route != "split" or 1 <= splits <= MAX_SPLITS,
            f"split count {splits} outside 1..{MAX_SPLITS}"),
    )


def check_tc_geometry(route: str, ps: int, D: int, Dv: int, nb: int) -> None:
    """Raise unless the tensor-core kernels take this geometry; any
    geometry passes on ``cuda_cores``. No fallback: a bf16 call they
    refuse raises."""
    require(launch_preconditions(route, ps, D, Dv, nb)[1])


def paged_attention(
    q: torch.Tensor,             # (B, Sq, H, D) — model layout
    k_pages: torch.Tensor,       # (P, page_size, Hkv, D)
    v_pages: torch.Tensor,       # (P, page_size, Hkv, Dv)
    block_tables: torch.Tensor,  # (B, n_blocks) int32 physical page per block
    q_positions: Optional[torch.Tensor] = None,   # (B, Sq) int32; <0 → masked
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) int32; None → all keys
    *,
    kv_scales=None,   # int8 pools: (k_scales, v_scales), fp32 (P, Hkv) each
    causal: bool = True,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention reading K/V through a block table; returns
    (B, Sq, H, Dv) in q's dtype.

    Defaults as the TPU wrapper's: ``q_positions`` is ``arange(Sq)`` (NOT
    bottom-right aligned), ``kv_valid_len`` is nb * page_size and is
    clamped to it. An empty table (nb == 0) returns zeros without a launch.
    Block-table entries must be valid page ids; entries past a row's valid
    length are never read. int8 pools need ``kv_scales``: each page's
    (page, kv head) scale rides the same block-table indirection as the
    page, and the recurrence runs in fp32 on the dequantized values.
    Forward-only: it raises under autograd (``kernels/forward_only.py``).
    """
    refuse_grad("paged_attention (K4/K5)", q, k_pages, v_pages)
    B, Sq, H, D = q.shape
    P, ps, Hkv, Dv = v_pages.shape
    require(*attention_preconditions(H, Hkv))
    if tuple(k_pages.shape[:3]) != (P, ps, Hkv):
        raise ValueError(f"k_pages {tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} disagree on (P, ps, Hkv)")
    if k_pages.shape[3] != D:
        raise ValueError(f"q has head_dim {D}, k_pages {k_pages.shape[3]}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (v_pages.dtype == torch.int8):
        raise ValueError(f"k_pages/v_pages dtype mismatch: {k_pages.dtype} "
                         f"vs {v_pages.dtype}")
    if quantized:
        if kv_scales is None:
            raise ValueError(
                "int8 k_pages/v_pages need kv_scales=(k_scales, v_scales) "
                "per-page-per-head fp32 tensors of shape (P, Hkv)")
        for name, sc in zip(("k_scales", "v_scales"), kv_scales):
            if tuple(sc.shape) != (P, Hkv):
                raise ValueError(f"{name} has shape {tuple(sc.shape)}, "
                                 f"expected (P, Hkv) = {(P, Hkv)}")
        kv_scales = tuple(sc.float() for sc in kv_scales)
    elif kv_scales is not None:
        raise ValueError(
            f"kv_scales given but pages are {k_pages.dtype}, not int8")
    nb = block_tables.shape[1]
    dev = q.device
    if nb == 0:
        return torch.zeros((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    block_tables = block_tables.to(torch.int32)

    def resolve():
        qp = q_positions if q_positions is not None else \
            torch.arange(Sq, device=dev).expand(B, Sq)
        kvl = kv_valid_len if kv_valid_len is not None else \
            torch.full((B,), nb * ps, device=dev)
        return qp.to(torch.int32), torch.clamp(kvl.to(torch.int32),
                                               max=nb * ps)

    if dev.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     *resolve(), causal=causal, scale=scale,
                                     soft_cap=soft_cap, kv_scales=kv_scales)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"no paged attention kernel for device {dev}")
    if not quantized:
        check_dtypes(q, k_pages, v_pages, "paged attention")
    elif q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8 pools take fp32 or bf16 q, got {q.dtype}")
    rep = H // Hkv
    route = route_for(q.dtype, Sq, rep, None if quantized else
                      k_pages.dtype)
    tc = route in ("rows", "split")       # the tensor-core instances
    splits = split_count(B, Hkv, nb * ps) if route == "split" else 0
    require(*launch_preconditions(route, ps, D, Dv, nb, splits))
    out_dtype = q.dtype
    if route == "cuda_cores":
        q = q.float()                # bf16 q over fp32 pools: exact
    scales = kv_scales or ()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    *zip(("k_scales", "v_scales"), scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if dev.type == "meta":
        RA.record_launch("paged_attention", route,
                         name="paged_attention_int8" if quantized else None,
                         B=B, Sq=Sq, H=H, Hkv=Hkv,
                         D=D, page_size=ps, n_blocks=nb, dtype=out_dtype,
                         kv_dtype=k_pages.dtype,
                         kv_scales=None if kv_scales is None else tuple(
                             tuple(sc.shape) for sc in kv_scales))
        return torch.empty((B, Sq, H, Dv), dtype=out_dtype, device=dev)
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if tc:                               # read in 16-byte chunks
        q, k_pages, v_pages = (_aligned(t) for t in (q, k_pages, v_pages))
    ks, vs = (sc.contiguous() for sc in scales) if quantized else (None, None)
    ks_ptr, vs_ptr = (None, None) if ks is None else (ks.data_ptr(),
                                                      vs.data_ptr())
    block_tables = block_tables.to(dev).contiguous()
    # the tensor-core kernels take a missing q_positions or kv_valid_len as
    # its default, and clamp kv_valid_len themselves
    qpos, kvl = (q_positions, kv_valid_len) if tc else resolve()
    qpos, kvl = (None if t is None else
                 t.to(device=dev, dtype=torch.int32).contiguous()
                 for t in (qpos, kvl))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tc:
        err = lib.paged_attention_tc(
            D, ps, splits, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            ks_ptr, vs_ptr, block_tables.data_ptr(),
            None if qpos is None else qpos.data_ptr(),
            None if kvl is None else kvl.data_ptr(), out.data_ptr(), B, Sq, H,
            Hkv, nb, float(scale), float(soft_cap or 0.0), int(causal), stream)
    else:
        err = lib.paged_attention(
            _POOL_CODES[k_pages.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), ks_ptr, vs_ptr,
            block_tables.data_ptr(), qpos.data_ptr(), kvl.data_ptr(),
            out.data_ptr(), B, Sq, H, Hkv, D, Dv, ps, nb, float(scale),
            float(soft_cap or 0.0), int(causal), stream)
    if err:
        kind = "int8 pools, " if quantized else ""
        raise RuntimeError(f"paged_attention launch failed ({kind}{route} "
                           f"route): {lib.pa_error_string(err).decode()}")
    if quantized:
        paged_attention.launches_int8 += 1
        paged_attention.launches_int8_by_route[route] += 1
    else:
        paged_attention.launches += 1
        paged_attention.launches_by_route[route] += 1
    return out.to(out_dtype)


paged_attention.launches = 0        # K4: fp pools
paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
paged_attention.launches_int8 = 0   # K5: int8 pools (no bf16-K/V route)
paged_attention.launches_int8_by_route = dict.fromkeys(
    (r for r in ROUTES if r != MIXED_ROUTE), 0)



# ---------------------------------------------------------------------------
# The launch grids, stated for the static checker
# ---------------------------------------------------------------------------

def paged_preconditions(H, Hkv, k_pages_shape, v_pages_shape, nb):
    """The reference's entry guards (``repro/kernels/paged_attention.py::
    paged_preconditions``): GQA groups, one pool geometry for K and V, a
    populated block table (the wrapper returns zeros for nb == 0 without a
    launch)."""
    P, ps, Hkv_v = v_pages_shape[0], v_pages_shape[1], v_pages_shape[2]
    return attention_preconditions(H, Hkv) + (
        Precondition.check(
            "K/V pool agreement",
            tuple(k_pages_shape[:3]) == (P, ps, Hkv_v),
            f"k_pages {tuple(k_pages_shape)} and v_pages "
            f"{tuple(v_pages_shape)} disagree on (P, page_size, Hkv); the "
            f"pools must be allocated as one paged cache"),
        Precondition.check(
            "populated block table", nb > 0,
            f"block table has {nb} blocks: the grid's key axis would have "
            f"zero extent and the flush step would never run (the caller "
            f"must short-circuit nb == 0 to zeros)"),
    )


@register_contract("paged_attention")
def paged_attention_contract(*, B, Sq, H, Hkv, D, Dv, P, page_size,
                             block_tables, block_q: int = 128,
                             quantized: bool = False, device="cuda",
                             dtype: torch.dtype = torch.bfloat16,
                             kv_dtype: Optional[torch.dtype] = None
                             ) -> KernelContract:
    """Contract of :func:`paged_attention` for one concrete block table
    ``block_tables`` (B, nb): q of ``dtype`` over pools of ``kv_dtype``
    (default: int8 when ``quantized``, else q's dtype).

    The checker evaluates the index maps against the table, so an
    out-of-range page id is a bounds violation and pool coverage narrows
    to the pages the table references (distractor pages are dead by
    design); every entry is taken as read, lengths being data. For a CUDA
    device, the launch on the route :func:`route_for` names
    (``flash_attention.attention_contract``: the tensor-core routes hold
    one m16 tile a CTA and step through min(16, page_size) keys, the
    CUDA-core route a page; ``csrc/paged_attention.cu``:320, :357,
    :161-:167); for the CPU, the reference's grid (B, H, nq, nb) over
    ``block_q`` rows and pages."""
    bt = np.asarray(block_tables, dtype=np.int64)
    nb = bt.shape[1] if bt.ndim == 2 else 0
    rep = H // Hkv if Hkv >= 1 and H % Hkv == 0 else 1
    ps = page_size
    pre = paged_preconditions(H, Hkv, (P, ps, Hkv, D), (P, ps, Hkv, Dv), nb)
    referenced = frozenset(
        (int(bt[b, j]), 0, hk, 0)
        for b in range(bt.shape[0]) for j in range(nb) for hk in range(Hkv))
    scale_blocks = frozenset((p, hk) for (p, _z, hk, _w) in referenced)
    if torch.device(device).type == "cpu":
        bq = min(block_q, Sq)
        nq = -(-Sq // bq)
        operands = [
            OperandSpec("q_positions", "input", (B, nq, 1), (1, bq, 1),
                        lambda b, h, i, j: (b, i, 0)),
            OperandSpec("q", "input", (B, nq, H, 1), (1, bq, 1, D),
                        lambda b, h, i, j: (b, i, h, 0)),
            OperandSpec("k_pages", "input", (P, 1, Hkv, 1), (1, ps, 1, D),
                        lambda b, h, i, j: (bt[b, j], 0, h // rep, 0),
                        expected_blocks=referenced),
            OperandSpec("v_pages", "input", (P, 1, Hkv, 1), (1, ps, 1, Dv),
                        lambda b, h, i, j: (bt[b, j], 0, h // rep, 0),
                        expected_blocks=referenced),
            OperandSpec("o", "output", (B, nq, H, 1), (1, bq, 1, Dv),
                        lambda b, h, i, j: (b, i, h, 0),
                        reduction_axes=(3,)),
        ]
        if quantized:
            operands += [
                OperandSpec(name, "input", (P, Hkv), (1, 1),
                            lambda b, h, i, j: (bt[b, j], h // rep),
                            expected_blocks=scale_blocks)
                for name in ("k_scales", "v_scales")]
        return KernelContract(
            kernel="paged_attention", grid=(B, H, nq, nb),
            operands=tuple(operands),
            dimension_semantics=("parallel", "parallel", "parallel",
                                 "arbitrary"),
            preconditions=pre,
            description="plain block-table attention, one page a step")
    kv_dtype = kv_dtype or (torch.int8 if quantized else dtype)
    quantized = kv_dtype == torch.int8
    route = route_for(dtype, Sq, rep, None if quantized else kv_dtype)
    splits = split_count(B, Hkv, nb * ps) if route == "split" else 0
    pre += launch_preconditions(route, ps, D, Dv, nb, splits)

    def page(b, col0):
        return int(bt[b, col0 // ps])

    kv = [(name, (P, 1, Hkv, 1), (1, ps, 1, d),
           lambda b, g, col0: (page(b, col0), 0, g, 0), referenced)
          for name, d in (("k_pages", D), ("v_pages", Dv))]
    kv.append(("block_tables", (B, max(nb, 1)), (1, 1),
               lambda b, g, col0: (b, col0 // ps), None))
    if quantized:
        kv += [(name, (P, Hkv), (1, 1),
                lambda b, g, col0: (page(b, col0), g), scale_blocks)
               for name in ("k_scales", "v_scales")]
    return attention_contract(
        "paged_attention", B=B, H=H, Hkv=Hkv, Sq=Sq, D=D, Dv=Dv,
        route=route, splits=splits, n_keys=nb * ps, kv_operands=kv, pre=pre,
        page_size=ps)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                 max_len: Optional[int] = None) -> torch.Tensor:
    """Gather a (P, page_size, Hkv, D) pool back to dense (B, T, Hkv, D)
    caches through the block tables — the inverse of the paged layout, for
    tests and yardsticks; the serving path never calls it."""
    P, ps, Hkv, D = pages.shape
    B, nb = block_tables.shape
    dense = pages[block_tables.long()].reshape(B, nb * ps, Hkv, D)
    return dense if max_len is None else dense[:, :max_len]
