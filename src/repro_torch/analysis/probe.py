"""The coverage probe: each contract held to the ``.cu`` it describes, on
the card.

A contract (``analysis/kernel_contracts.py``) states which output blocks a
launch writes. The probe launches the kernel through its raw binding (the
``ctypes`` entry points the wrappers call) into output buffers filled with
a sentinel — NaN, or ``INT32_MIN`` for int32 — on the route, tile and split
the wrapper would take, and checks that every element the contract marks
written was overwritten and agrees with the kernel's plain version within
the parity harness's tolerances (``TOLS`` / ``ATTN_TOLS``, int8 and K2
exact; the SSD scan's own). A contract that says a block is written when
the kernel skips it — or a kernel that skips what its grid should cover —
shows as a sentinel left behind.

The probe needs a CUDA card and the built kernels; the cells come from the
contract sweep (``analysis/sweep.py``, whose entries carry their builder
arguments) or from a caller. Each probe raises :class:`ProbeError` on a
failure and returns (the route it took, the max |kernel - plain|).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import sweep as SW
from repro_torch.analysis.kernel_contracts import (check_contract,
                                                   get_contract_builder,
                                                   touched_blocks)

INT32_MIN = -2 ** 31
# The parity harness's tolerances (tests/parity.py: TOLS, ATTN_TOLS), and
# the SSD scan's (K6 accumulates over a whole row).
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2), "int8": (0.0, 0.0)}
ATTN_TOLS = {"float32": (3e-5, 3e-5), "bfloat16": (3e-2, 3e-2)}
SSD_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}

Cell = Tuple[str, str, Dict]          # (name, kernel, builder arguments)


class ProbeError(AssertionError):
    """A launch left an element its contract marks written unwritten, or
    disagreed with its plain version there."""


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _poisoned(shape, dtype):
    """A buffer every element of which holds the sentinel."""
    fill = INT32_MIN if dtype == torch.int32 else float("nan")
    return torch.full(shape, fill, dtype=dtype, device="cuda")


def _unwritten(t: torch.Tensor) -> torch.Tensor:
    return torch.isnan(t.float()) if t.is_floating_point() else \
        t == INT32_MIN


def check_written(name: str, got: torch.Tensor, want: torch.Tensor,
                  mask: torch.Tensor, atol: float, rtol: float) -> float:
    """Every element ``mask`` marks was overwritten and equals ``want``
    within (atol, rtol) — exactly when both are 0; returns the max
    |got - want| there."""
    if not bool(mask.any()):
        raise ProbeError(f"{name}: the contract marks nothing written")
    hole = _unwritten(got) & mask
    if bool(hole.any()):
        raise ProbeError(f"{name}: {int(hole.sum())} elements the contract "
                         f"marks written still hold the sentinel")
    g, w = got[mask].double(), want[mask].double()
    err = float((g - w).abs().max())
    if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
        raise ProbeError(f"{name}: max |kernel - plain| = {err:.3e} over the "
                         f"written elements exceeds atol={atol} rtol={rtol}")
    return err


def _contract(kernel: str, cell: Dict, drop: Sequence[str] = ()):
    c = get_contract_builder(kernel)(
        **{k: v for k, v in cell.items() if k not in drop})
    bad = check_contract(c)
    if bad:
        raise ProbeError(f"{kernel} contract: {[str(v) for v in bad]}")
    return c


def _launched(err: int, lib_error, what: str) -> None:
    if err:
        raise ProbeError(f"{what}: launch failed: {lib_error(err).decode()}")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K1, K2
# ---------------------------------------------------------------------------

def gemm_mask(contract, shape) -> torch.Tensor:
    """The C elements a GEMM contract marks written: whole C blocks."""
    mask = torch.zeros(shape, dtype=torch.bool, device="cuda")
    flat = mask.view(-1, *shape[-4:])
    for z, i, j, _, _ in touched_blocks(contract, "c_bm"):
        flat[z, i, j] = True
    return mask


def probe_gemm(name: str, cell: Dict, gen: torch.Generator
               ) -> Tuple[str, float]:
    """K1 (K2 with ``fused``) at one cell: ``M, N, K`` and the contract's
    arguments (``a_shape``, ``b_shape``, ``blk``, ``dtype``[, ``fused``,
    ``batch``])."""
    from repro_torch.core import layout as L
    from repro_torch.kernels import matrixflow_gemm as MF
    M, N, K, blk = cell["M"], cell["N"], cell["K"], cell["blk"]
    G, dt, fused = cell.get("batch", 0), cell["dtype"], cell.get("fused",
                                                                 False)
    contract = _contract("matrixflow_gemm", cell, ("M", "N", "K"))
    lead = (G,) if G else ()
    if dt == torch.int8:
        a, b = (torch.randint(-127, 128, (*lead, *s), generator=gen,
                              device="cuda", dtype=torch.int8)
                for s in ((M, K), (K, N)))
    else:
        a, b = (torch.randn((*lead, *s), generator=gen, device="cuda").to(dt)
                for s in ((M, K), (K, N)))
    a_bm = L.to_block_major_a(a, blk.bm, blk.bk).contiguous()
    b_bm = L.to_block_major_b(b, blk.bk, blk.bn).contiguous()
    nbm, nbk = a_bm.shape[-4:-2]
    nbn = b_bm.shape[-4]
    route = MF.route_for(dt, blk.bm, dequant=fused)
    lib, s = MF._lib(), _stream()
    if fused:
        out = torch.float32
        sa, sb = ((torch.rand(n, generator=gen, device="cuda") + 0.5) / 64
                  for n in (M, N))
        c = _poisoned((nbm, nbn, blk.bm, blk.bn), out)
        gm, tn, splits = MF.tc_tile(blk.bm, blk.bn, nbm, nbn, nbk, blk.bk)
        err = lib.mf_gemm_dequant(
            MF._OUT_CODES[out], blk.bm, blk.bn, gm, tn, splits,
            a_bm.data_ptr(), b_bm.data_ptr(), sa.data_ptr(), M, sb.data_ptr(),
            N, c.data_ptr(), nbm, nbn, nbk, blk.bk, s)
        want = MF.plain(a_bm, b_bm, out_dtype=out, scale_a=sa, scale_b=sb)
        tol = (0.0, 0.0)                  # K2 is bitwise its plain version
    else:
        out = torch.bfloat16 if dt == torch.bfloat16 else MF.acc_dtype_for(dt)
        c = _poisoned((*lead, nbm, nbn, blk.bm, blk.bn), out)
        if route == "cuda_core":
            err = lib.mf_gemm(MF._IN_CODES[dt], MF._OUT_CODES[out], blk.bm,
                              blk.bn, a_bm.data_ptr(), b_bm.data_ptr(),
                              c.data_ptr(), nbm, nbn, nbk, blk.bk, max(G, 1),
                              s)
        else:
            gm, tn, splits = MF.tc_tile(blk.bm, blk.bn, nbm, nbn, nbk, blk.bk)
            err = lib.mf_gemm_tc(MF._OUT_CODES[out], blk.bm, blk.bn, gm, tn,
                                 splits, a_bm.data_ptr(), b_bm.data_ptr(),
                                 c.data_ptr(), nbm, nbn, nbk, blk.bk,
                                 max(G, 1), s)
        want = MF.plain(a_bm, b_bm, out_dtype=out)
        tol = TOLS[_name(dt)]
    _launched(err, lib.mf_error_string, name)
    return route, check_written(name, c, want, gemm_mask(contract, c.shape),
                                *tol)


# ---------------------------------------------------------------------------
# K3, K4, K5
# ---------------------------------------------------------------------------

def _attention_operands(cell: Dict, gen: torch.Generator, paged: bool):
    """q, K/V (dense, or pools and their scales), positions and lengths of
    one cell: the parity case's offsets and lengths where the cell is one
    (``case``), else the defaults."""
    B, Sq, H, Hkv, D = (cell[k] for k in ("B", "Sq", "H", "Hkv", "D"))
    Dv, dt = cell["Dv"], cell["dtype"]
    causal, offs, lens = SW.ATTN_CASE_SEMANTICS.get(cell.get("case"),
                                                    (True, None, None))
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
    qpos = kvl = None
    if offs is not None:
        o = torch.tensor(offs, dtype=torch.int32, device="cuda")[:, None]
        qpos = torch.where(o < 0, -1, o + torch.arange(
            Sq, device="cuda", dtype=torch.int32)[None]).to(torch.int32)
    if lens is not None:
        kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if not paged:
        k, v = (torch.randn((B, cell["Sk"], Hkv, d), generator=gen,
                            device="cuda").to(dt) for d in (D, Dv))
        return q, k, v, None, qpos, kvl, causal
    P, ps = cell["P"], cell["page_size"]
    if cell["quantized"]:
        k, v = (torch.randint(-127, 128, (P, ps, Hkv, d), generator=gen,
                              device="cuda", dtype=torch.int8)
                for d in (D, Dv))
        scales = tuple((torch.rand((P, Hkv), generator=gen, device="cuda")
                        + 0.5) / 64 for _ in range(2))
    else:
        k, v = (torch.randn((P, ps, Hkv, d), generator=gen,
                            device="cuda").to(dt) for d in (D, Dv))
        scales = None
    return q, k, v, scales, qpos, kvl, causal


def written_rows(tile_rows: int, t: int, rows: int, rep: int, g: int):
    """The (query position, head) pairs of flat rows t * tile_rows .. that
    an output block (b, g, t, 0) of an attention contract holds, the last
    tile cut at ``rows``."""
    return [(r // rep, g * rep + r % rep)
            for r in range(t * tile_rows, min((t + 1) * tile_rows, rows))]


def row_mask(contract, B: int, Sq: int, H: int, Hkv: int,
             Dv: int) -> torch.Tensor:
    """The output elements an attention contract marks written: the flat
    rows (query position, head of the group) of each written tile."""
    rep = H // Hkv
    T = next(o for o in contract.operands if o.name == "o").block_shape[2]
    mask = torch.zeros((B, Sq, H, Dv), dtype=torch.bool)
    for b, g, t, _ in touched_blocks(contract, "o"):
        rows = written_rows(T, t, Sq * rep, rep, g)
        if rows:
            s, h = zip(*rows)
            mask[b, list(s), list(h)] = True
    return mask.cuda()


def probe_attention(name: str, kernel: str, cell: Dict,
                    gen: torch.Generator) -> Tuple[str, float]:
    """K3 (``flash_attention``), K4 or K5 (``paged_attention``) at one
    cell, positions and lengths resolved as the CUDA-core route's wrapper
    resolves them."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    paged = kernel == "paged_attention"
    contract = _contract(kernel, cell, ("case",))
    q, k, v, scales, qpos, kvl, causal = _attention_operands(cell, gen, paged)
    B, Sq, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    scale, rep, s = 1.0 / math.sqrt(D), H // Hkv, _stream()
    out = _poisoned((B, Sq, H, Dv), q.dtype)
    if paged:
        bt = torch.as_tensor(cell["block_tables"], dtype=torch.int32,
                             device="cuda")
        nb, ps = bt.shape[1], k.shape[1]
        route = FA.route_for(q.dtype, Sq, rep,
                             None if scales is not None else k.dtype)
        splits = FA.split_count(B, Hkv, nb * ps) if route == "split" else 0
        qp = qpos if qpos is not None else torch.arange(
            Sq, device="cuda", dtype=torch.int32).expand(B, Sq).contiguous()
        kl = torch.clamp(kvl if kvl is not None else torch.full(
            (B,), nb * ps, device="cuda"), max=nb * ps).to(torch.int32)
        ks, vs = scales or (None, None)
        sp = (None, None) if ks is None else (ks.data_ptr(), vs.data_ptr())
        lib = PA._lib()
        if route in ("rows", "split"):
            err = lib.paged_attention_tc(
                D, ps, splits, q.data_ptr(), k.data_ptr(), v.data_ptr(), *sp,
                bt.data_ptr(), qp.data_ptr(), kl.data_ptr(), out.data_ptr(), B,
                Sq, H, Hkv, nb, scale, 0.0, int(causal), s)
        else:
            err = lib.paged_attention(
                PA._POOL_CODES[k.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), *sp, bt.data_ptr(), qp.data_ptr(),
                kl.data_ptr(), out.data_ptr(), B, Sq, H, Hkv, D, Dv, ps, nb,
                scale, 0.0, int(causal), s)
        _launched(err, lib.pa_error_string, f"{name} ({route})")
        want = PA.paged_attention_plain(q, k, v, bt, qp, kl, causal=causal,
                                        scale=scale, soft_cap=None,
                                        kv_scales=scales)
    else:
        Sk = k.shape[1]
        route = FA.route_for(q.dtype, Sq, rep, k.dtype)
        splits = FA.split_count(B, Hkv, Sk) if route == "split" else 0
        qp, kl = FA._resolve(qpos, kvl, B, Sq, Sk, q.device)
        lse = _poisoned((B, Sq, H), torch.float32) if cell.get("lse") \
            else None
        lib = FA._lib()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kl.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, H, Hkv,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, 0.0,
                int(causal), s)
        if route in ("rows", "split"):
            err = lib.flash_attention_tc(D, Dv, splits, *args)
        else:
            err = lib.flash_attention(FA._KV_CODES[k.dtype], D, Dv, *args)
        _launched(err, lib.fa_error_string, f"{name} ({route})")
        want = FA.flash_attention_plain(q, k, v, qp, kl, causal=causal,
                                        scale=scale, soft_cap=None,
                                        return_lse=lse is not None)
        if lse is not None:
            want, want_lse = want
            e = check_lse(f"{name} lse", lse, want_lse,
                          lse_mask(contract, route, splits, B, Sq, H, Hkv,
                                   Dv), *ATTN_TOLS[_name(q.dtype)])
            return route, max(e, check_written(
                name, out, want, row_mask(contract, B, Sq, H, Hkv, Dv),
                *ATTN_TOLS[_name(q.dtype)]))
    return route, check_written(name, out, want,
                                row_mask(contract, B, Sq, H, Hkv, Dv),
                                *ATTN_TOLS[_name(q.dtype)])


def lse_mask(contract, route: str, splits: int, B: int, Sq: int, H: int,
             Hkv: int, Dv: int) -> torch.Tensor:
    """The (B, Sq, H) log-sum-exps K3's contract marks written: the rows
    of each written ``lse`` segment (``flash_attention.lse_segment_rows``)."""
    from repro_torch.kernels import flash_attention as FA
    rep = H // Hkv
    T = next(o for o in contract.operands if o.name == "o").block_shape[2]
    mask = torch.zeros((B, Sq, H), dtype=torch.bool)
    for b, g, t, z in touched_blocks(contract, "lse"):
        for r in FA.lse_segment_rows(route, z, splits, Dv, T):
            if t * T + r < Sq * rep:
                s, h = (t * T + r) // rep, g * rep + (t * T + r) % rep
                mask[b, s, h] = True
    return mask.cuda()


def check_lse(name: str, got: torch.Tensor, want: torch.Tensor,
              mask: torch.Tensor, atol: float, rtol: float) -> float:
    """:func:`check_written` for log-sum-exps, whose rows that see no key
    hold -inf: those must be -inf on both sides."""
    dead = torch.isneginf(want)
    if bool((mask & dead & ~torch.isneginf(got)).any()):
        raise ProbeError(f"{name}: a row that sees no key got a finite "
                         f"log-sum-exp")
    live = mask & ~dead
    if not bool(live.any()):
        return 0.0
    return check_written(name, got.where(~torch.isneginf(got), float("nan")),
                         want, live, atol, rtol)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def probe_ssd(name: str, cell: Dict, gen: torch.Generator
              ) -> Tuple[str, float]:
    """K6 at one shape: every launch of its route, y and the final state
    poisoned; the contract of the route's last launch (the one that writes
    them) marks what must be overwritten."""
    from repro_torch.kernels import ssd_scan as K6
    B, S, H, P, N, dt = (cell[k] for k in ("B", "S", "H", "P", "N", "dtype"))
    launches = K6.route_launches(dt, S, P, N)
    for launch in launches:
        contract = _contract("ssd_scan", dict(cell, launch=launch))
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dt)
    dtv = 0.01 + 0.1 * torch.rand((B, S, H), generator=gen, device="cuda")
    A = -(0.5 + torch.rand(H, generator=gen, device="cuda"))
    Bc, Cc = ((torch.randn((B, S, N), generator=gen, device="cuda") / 8)
              .to(dt) for _ in range(2))
    y = _poisoned((B, S, H, P), dt)
    state = _poisoned((B, H, P, N), torch.float32)
    route, Q = K6.check_operands(x, dtv, A, Bc, Cc, cell["chunk"])
    strides = (*x.stride()[:3], *dtv.stride(), *Bc.stride()[:2],
               *Cc.stride()[:2])
    ptrs = (x.data_ptr(), dtv.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), state.data_ptr())
    lib = K6._lib()
    if route == "cuda_cores":
        err = lib.ssd_scan(*ptrs, B, S, H, P, N, Q, *strides, _stream())
    else:
        plan = K6.tile_plan(S, P, N)
        nseg = plan["segments"]
        scratch = _poisoned((max(B * H * plan["scratch_floats"], 1),),
                            torch.float32)
        seg = (scratch.data_ptr(), scratch[B * H * (nseg - 1) * P * N:]
               .data_ptr()) if nseg > 1 else (None, None)
        err = lib.ssd_scan_tc(*ptrs, *seg, B, S, H, P, N, plan["seg_tiles"],
                              nseg, *strides, _stream())
    _launched(err, lib.ssd_error_string, f"{name} ({route})")
    T = next(o for o in contract.operands if o.name == "y").block_shape[1]
    ymask = torch.zeros(y.shape, dtype=torch.bool, device="cuda")
    for b, t, h, _ in touched_blocks(contract, "y"):
        ymask[b, t * T:(t + 1) * T, h] = True
    smask = torch.zeros(state.shape, dtype=torch.bool, device="cuda")
    for b, h in touched_blocks(contract, "state"):
        smask[b, h] = True
    want_y, want_s = K6.ssd_scan_plain(x, dtv, A, Bc, Cc, chunk=cell["chunk"])
    e = check_written(f"{name} y", y, want_y, ymask, *SSD_TOLS[_name(dt)])
    return route, max(e, check_written(f"{name} state", state, want_s, smask,
                                       *SSD_TOLS["float32"]))


# ---------------------------------------------------------------------------
# Cells and the run
# ---------------------------------------------------------------------------

def sweep_cells(entries: Sequence[SW.SweepEntry]) -> List[Cell]:
    """The launches of a card sweep's entries: its GEMM cells of the
    matrixflow backend, its attention cells, and one SSD cell per shape
    and dtype (the SSD entries are one per launch of a route)."""
    cells, seen = [], set()
    for e in entries:
        if e.kernel == "blockflow" or not e.cell or not e.route:
            continue
        if e.kernel == "ssd_scan":
            key = tuple(e.cell[k] for k in ("B", "S", "H", "P", "N", "dtype"))
            if key in seen:
                continue
            seen.add(key)
            cells.append((e.instance, e.kernel, dict(e.cell, launch=None)))
        else:
            cells.append((e.instance, e.kernel, e.cell))
    return cells


def gemm_cell(M: int, N: int, K: int, dtype: torch.dtype, *,
              fused: bool = False, bm: Optional[int] = None,
              batch: int = 0) -> Dict:
    """A K1/K2 cell as the card plans it (``bm`` forces the row tile)."""
    from repro_torch.core import layout as L
    from repro_torch.core import plan as P
    pol = P.GemmPolicy(backend="matrixflow",
                       weight_dtype="int8" if fused else None)
    blk = P.plan(M, N, K, dtype, pol, "cuda").layout
    if bm:
        blk = dataclasses.replace(blk, bm=bm)
    cell = dict(a_shape=(L.cdiv(M, blk.bm), L.cdiv(K, blk.bk), blk.bm,
                         blk.bk),
                b_shape=(L.cdiv(N, blk.bn), L.cdiv(K, blk.bk), blk.bk,
                         blk.bn),
                blk=blk, fused=fused, device="cuda", dtype=dtype, M=M, N=N,
                K=K)
    if batch:
        cell["batch"] = batch
    return cell


def run_probe(cells: Sequence[Cell], seed: int = 0) -> Dict:
    """Probe every cell; returns the probes and the max |error| by
    "kernel/route". Raises :class:`ProbeError` at the first failure."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n: Dict[str, int] = {}
    worst: Dict[str, float] = {}
    for name, kernel, cell in cells:
        if kernel == "matrixflow_gemm":
            route, err = probe_gemm(name, cell, gen)
        elif kernel == "ssd_scan":
            route, err = probe_ssd(name, cell, gen)
        else:
            route, err = probe_attention(name, kernel, cell, gen)
        key = f"{kernel}/{route}"
        n[key] = n.get(key, 0) + 1
        worst[key] = max(worst.get(key, 0.0), err)
    return dict(cells=n, max_abs_err=worst)
