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
or ``rows`` (prefill buckets, chunks), fp32 q on ``cuda_cores``. Over int8
pools the tensor-core kernels stage the int8 rows as they are and convert
them to bf16 in shared memory; p is not rounded before P·V.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (MAX_SPLITS, ROUTES,
                                                 _aligned, route_for,
                                                 split_count)

NEG_INF = -1e30
# Limits of the kernels' tiling (csrc/paged_attention.cu).
MAX_PAGE_SIZE = 32
MAX_HEAD_DIM = 128
MAX_ROWS = 16                      # query positions x rep heads per CTA
# The tensor-core instances (bf16 pools): page sizes, head dims a multiple
# of TC_HEAD_DIM_STEP up to MAX_HEAD_DIM, block-table entries a CTA copies.
TC_PAGE_SIZES = (8, 16, 32)
TC_HEAD_DIM_STEP = 16
MAX_TABLE = 4096

_INT8_POOL = 2     # the CUDA-core kernel's pool code of int8 pages (K5)


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if lib.paged_attention.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention.argtypes = [
            i, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            i, i, i, i, i, i, i, i, i, f, f, i, vp]
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


def check_tc_geometry(route: str, ps: int, D: int, Dv: int, nb: int) -> None:
    """Raise unless the tensor-core kernels (K4 over bf16 pools, K5 over
    int8 pools, both with bf16 q) take this geometry; any geometry passes
    on ``cuda_cores``. No fallback: a bf16 call they refuse raises."""
    if route in ("rows", "split") and (
            ps not in TC_PAGE_SIZES or D % TC_HEAD_DIM_STEP or Dv != D
            or nb > MAX_TABLE):
        raise ValueError(
            f"page_size={ps}, head dims ({D}, {Dv}), {nb} table entries: the "
            f"bf16 kernels take page_size in {TC_PAGE_SIZES}, equal head dims "
            f"a multiple of {TC_HEAD_DIM_STEP} up to {MAX_HEAD_DIM} and at "
            f"most {MAX_TABLE} entries")


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
    """
    B, Sq, H, D = q.shape
    P, ps, Hkv, Dv = v_pages.shape
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} query heads must be a multiple of Hkv={Hkv}")
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
    if dev.type != "cuda":
        raise ValueError(f"no paged attention kernel for device {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            quantized or {k_pages.dtype, v_pages.dtype} == {q.dtype}):
        raise ValueError(f"the kernels take fp32 or bf16 q with pools of "
                         f"q's dtype or int8, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    rep = H // Hkv
    if ps > MAX_PAGE_SIZE or max(D, Dv) > MAX_HEAD_DIM or rep > MAX_ROWS:
        raise ValueError(
            f"page_size={ps}, head dims ({D}, {Dv}), rep={rep} exceed the "
            f"kernel's limits ({MAX_PAGE_SIZE}, {MAX_HEAD_DIM}, {MAX_ROWS})")
    route = route_for(q.dtype, Sq, rep)
    tc = route in ("rows", "split")       # the tensor-core instances
    check_tc_geometry(route, ps, D, Dv, nb)
    splits = split_count(B, Hkv, nb * ps) if route == "split" else 0
    if route == "split" and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"split count {splits} outside 1..{MAX_SPLITS}")
    scales = kv_scales or ()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    *zip(("k_scales", "v_scales"), scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
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
            _INT8_POOL if quantized else 0, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), ks_ptr, vs_ptr,
            block_tables.data_ptr(), qpos.data_ptr(), kvl.data_ptr(),
            out.data_ptr(), B, Sq, H, Hkv, D, Dv, ps,
            nb, MAX_ROWS // rep, float(scale), float(soft_cap or 0.0),
            int(causal), stream)
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
    return out


paged_attention.launches = 0        # K4: fp pools
paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
paged_attention.launches_int8 = 0   # K5: int8 pools
paged_attention.launches_int8_by_route = dict.fromkeys(ROUTES, 0)



def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                 max_len: Optional[int] = None) -> torch.Tensor:
    """Gather a (P, page_size, Hkv, D) pool back to dense (B, T, Hkv, D)
    caches through the block tables — the inverse of the paged layout, for
    tests and yardsticks; the serving path never calls it."""
    P, ps, Hkv, D = pages.shape
    B, nb = block_tables.shape
    dense = pages[block_tables.long()].reshape(B, nb * ps, Hkv, D)
    return dense if max_len is None else dense[:, :max_len]
