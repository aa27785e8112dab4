"""MatrixFlow blocked GEMM (paper Algorithm 1): wrappers of the CUDA
kernels in ``csrc/matrixflow_gemm.cu``, which replace the Pallas TPU kernels
``repro/kernels/matrixflow_gemm.py::_kernel`` (K1) and
``::_kernel_fused_dequant`` (K2, the W8A8 route).

:func:`matrixflow_gemm_block_major` (K1) takes block-major operands —
including a resident ``PackedWeight``'s blocks — and returns C block-major.
:func:`matrixflow_gemm_dequant` (K2) takes int8 block-major operands and
the row and channel scales, and returns C rescaled at the flush. For
tensors on the CPU each runs its plain version
(``kernels/ref.py::block_matmul_ref``); for CUDA tensors it launches its
kernel or raises. Each counts its own launches (``.launches``).

K1 has three routes on the card, by operand dtype and row tile, each
counted on the wrapper apart:

  ``wgmma``      bf16, bm = 64 (prefill, encoders): wgmma on the tensor
                 cores, CTA tiles of grouped C blocks (``.wgmma_launches``)
  ``mma``        bf16, bm = 16 or 32 (decode): mma.sync on the tensor
                 cores, K split across warps and cluster CTAs
                 (``.mma_launches``)
  ``cuda_core``  fp32 (TF32 stays off) and int8 → int32: FMA and integer
                 MACs on the CUDA cores (``.cuda_core_launches``)

K1 also takes a batch of problems of one geometry in one launch (a grid
axis over the batch, as a ``vmap`` of the TPU kernel adds one): the
unfused attention's score and value products, B x H of them a layer, on
the ``wgmma`` and ``cuda_core`` routes (``.batched_launches``). K1 is its
own backward (``core/api.py``: dA = dC·Bᵀ and dB = Aᵀ·dC are K1 launches);
a launch made for a gradient also counts in ``.backward_launches``.

K2 takes the two tensor-core routes with int8 operands (s8 ``wgmma`` at
bm = 64, s8 ``mma.sync`` at bm = 16 and 32, the same tiles and splits,
:func:`tc_tile`), counted on its wrapper as ``.wgmma_launches`` and
``.mma_launches``; it has no CUDA-core route.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) each wrapper takes
the route the card would take, records that launch and its least work
(``roofline.launch_cost`` of the logical ``problem``) in the active cost
ledger, and returns an empty ``meta`` result. Nothing launches there, so
the launch counters above do not move: they count real launches only.

:func:`gemm_contract` (registered as ``"matrixflow_gemm"``, K2 with
``fused=True``) states each route's launch grid and the block every CTA
reads and writes, for the static checker (``analysis/kernel_contracts.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.analysis.kernel_contracts import (KernelContract,
                                                   OperandSpec, Precondition,
                                                   register_contract, require)
from repro_torch.core import layout as L
from repro_torch.kernels import _build
from repro_torch.kernels.forward_only import refuse_grad
from repro_torch.kernels.ref import acc_dtype_for, block_matmul_ref
from repro_torch.roofline import analysis as RA

# Plain version of the kernels (Algorithm 1, K innermost; with scales, K2).
plain = block_matmul_ref

_IN_CODES = {torch.float32: 0, torch.int8: 2}    # the CUDA-core routine
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
# Output dtypes of the dequant-fused kernel (K2).
_DEQUANT_OUT = (torch.float32, torch.bfloat16)
# (input dtype, output dtype) pairs the kernel instantiates.
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.int8, torch.int32)}
# Operand dtypes of the tensor-core routes.
_TC_DTYPES = (torch.bfloat16,)
# Streaming multiprocessors of an H100 SXM: the CTA count one wave fills.
SMS = 132
# CTAs of one cluster that may share a C block on the mma route.
MAX_SPLITS = 8
# wgmma CTA tiles, largest first: (C blocks along M, columns, the waves of
# SMS CTAs its grid must give to be taken).
WGMMA_TILES = ((2, 256, 2.0), (2, 128, 1.0), (1, 128, 0.5), (1, 64, 0.0))
# CTAs a split mma launch aims at: timed at every decode GEMM of the served
# models on an H100 (scripts/torch_gemm_tiles.py), the splits ran fastest
# near 160-200 CTAs, not at the 264 that two resident CTAs an SM hold.
MMA_TARGET_CTAS = 192
# Problems one batched launch takes (the grid's z axis).
MAX_BATCH = 65535


def route_for(dtype: torch.dtype, bm: int, *, dequant: bool = False) -> str:
    """The route K1 (or, with ``dequant``, K2) takes on the card for
    operands of ``dtype`` in row tiles of ``bm``: ``wgmma``, ``mma`` or
    ``cuda_core``. bf16, and int8 with the dequant flush, run on the
    tensor cores; K1's int8 → int32 instance and fp32 on the CUDA cores."""
    if dtype not in _TC_DTYPES and not (dequant and dtype == torch.int8):
        return "cuda_core"
    return "wgmma" if bm == L.BM_CHOICES[-1] else "mma"


def tc_tile(bm: int, bn: int, nbm: int, nbn: int, nbk: int,
            bk: int) -> Tuple[int, int, int]:
    """(gm, tn, splits) of a tensor-core launch over an (nbm, nbn) grid of
    C blocks, with nbk K blocks of depth bk.

    wgmma (bm = 64): a CTA owns gm C blocks along M by tn / bn along N, the
    first of :data:`WGMMA_TILES` whose grid gives its waves of :data:`SMS`
    CTAs. A larger tile reads fewer bytes from L2 per product, but fewer
    of its CTAs fit an SM (128 x 256 one, 64 x 64 five) and a small grid
    leaves SMs idle: bert-base's 768-wide projections at bn = 32 take
    64 x 128, mamba2's 3,072 x 4,096 prefill 128 x 256.

    mma (bm = 16, 32): one C block a CTA; when those are fewer than
    :data:`SMS`, K is split over up to :data:`MAX_SPLITS` CTAs of a
    cluster, about :data:`MMA_TARGET_CTAS` in all, each with at least one
    four-slice chunk of K to stream. The same tiles serve K1 in bf16 and
    K2 in int8."""
    if bm == L.BM_CHOICES[-1]:
        fits = [t for t in WGMMA_TILES if t[1] % bn == 0]
        for gm, tn, waves in fits:
            if L.cdiv(nbm, gm) * L.cdiv(nbn, tn // bn) >= waves * SMS:
                return gm, tn, 1
        return fits[-1][0], fits[-1][1], 1   # bn 128 on a small grid
    ctas = nbm * nbn
    if ctas >= SMS:
        return 1, bn, 1
    most = L.cdiv(nbk * bk // L.K_SLICE, 4)
    return 1, bn, max(1, min(MAX_SPLITS, most,
                             round(MMA_TARGET_CTAS / ctas)))


def _lib() -> ctypes.CDLL:
    lib = _build.load("matrixflow_gemm")
    if lib.mf_gemm.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mf_gemm.argtypes = [i, i, i, i, vp, vp, vp, i, i, i, i, i, vp]
        lib.mf_gemm.restype = ctypes.c_int
        lib.mf_gemm_tc.argtypes = [i, i, i, i, i, i, vp, vp, vp, i, i, i, i,
                                   i, vp]
        lib.mf_gemm_tc.restype = ctypes.c_int
        lib.mf_gemm_dequant.argtypes = [i, i, i, i, i, i, vp, vp, vp, i,
                                        vp, i, vp, i, i, i, i, vp]
        lib.mf_gemm_dequant.restype = ctypes.c_int
        lib.mf_error_string.argtypes = [i]
        lib.mf_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(a_bm: torch.Tensor, b_bm: torch.Tensor,
                    batched: bool = False) -> None:
    nd = 5 if batched else 4
    if a_bm.dim() != nd or b_bm.dim() != nd:
        raise ValueError(f"block-major operands must be {nd}-D, got "
                         f"{tuple(a_bm.shape)} and {tuple(b_bm.shape)}")
    if batched and a_bm.shape[0] != b_bm.shape[0]:
        raise ValueError(f"batches differ: {a_bm.shape[0]} and "
                         f"{b_bm.shape[0]} problems")
    nbm, nbk, bm, bk = a_bm.shape[-4:]
    nbn, nbk2, bk2, bn = b_bm.shape[-4:]
    if (nbk, bk) != (nbk2, bk2):
        raise ValueError(
            f"block-major operands disagree on the K stream: a_bm "
            f"{tuple(a_bm.shape)} walks {nbk} blocks of bk={bk}, b_bm "
            f"{tuple(b_bm.shape)} walks {nbk2} blocks of bk={bk2}")
    if a_bm.dtype != b_bm.dtype:
        raise ValueError(f"operand dtypes differ: {a_bm.dtype} vs {b_bm.dtype}")
    if a_bm.device != b_bm.device:
        raise ValueError(f"operands on {a_bm.device} and {b_bm.device}")


def launch_preconditions(a_shape, b_shape, dtype: torch.dtype,
                         out_dtype: torch.dtype, *, dequant: bool = False,
                         batch: int = 0) -> Tuple[Precondition, ...]:
    """The block geometry, dtypes and batch the CUDA kernels take (K2 with
    ``dequant``; ``batch`` problems, 0 for an unbatched call): the guards
    the wrappers raise and :func:`gemm_contract` states for the card."""
    bm, bk, bn = a_shape[-2], a_shape[-1], b_shape[-1]
    route = route_for(dtype, bm, dequant=dequant)
    if dequant:
        pairs_ok = out_dtype in _DEQUANT_OUT
        pairs_msg = (f"the dequant kernel writes {_DEQUANT_OUT}, not "
                     f"{out_dtype}")
    else:
        pairs_ok = (dtype, out_dtype) in _PAIRS
        pairs_msg = (f"the kernel takes {sorted(map(str, _PAIRS))} (input, "
                     f"output) dtypes, not ({dtype}, {out_dtype})")
    return (
        Precondition.check(
            "instantiated block geometry",
            bm in L.BM_CHOICES and bn in L.BN_CHOICES and bk % L.K_SLICE == 0,
            f"block geometry (bm={bm}, bn={bn}, bk={bk}) is not one the "
            f"kernel instantiates: bm in {L.BM_CHOICES}, bn in "
            f"{L.BN_CHOICES}, bk a multiple of {L.K_SLICE} "
            f"(core/layout.py::choose_layout picks these)"),
        Precondition.check("instantiated dtypes", pairs_ok, pairs_msg),
        Precondition.check(
            "batched route", not batch or (route != "mma"
                                           and 1 <= batch <= MAX_BATCH),
            f"a batch of {batch} problems at bm={bm}: batched launches take "
            f"the wgmma and cuda_core routes and 1..{MAX_BATCH} problems"),
    )


def _check_launch(a_bm: torch.Tensor, b_bm: torch.Tensor) -> None:
    """What the CUDA kernels take of the operands' placement beyond
    :func:`_check_operands` and :func:`launch_preconditions` (on ``meta``:
    all but the alignment of storage it does not have)."""
    if a_bm.device.type not in ("cuda", "meta"):
        raise ValueError(f"no MatrixFlow GEMM for device {a_bm.device}")
    if not (a_bm.is_contiguous() and b_bm.is_contiguous()):
        raise ValueError("block-major operands must be contiguous")
    if a_bm.device.type == "cuda" and (a_bm.data_ptr() % 16
                                       or b_bm.data_ptr() % 16):
        raise ValueError("operands must be 16-byte aligned")


def _problem(problem, a_bm: torch.Tensor, b_bm: torch.Tensor):
    """The logical (M, N, K) inside the blocks: ``problem``, or (with
    None) the padded extent."""
    if problem is not None:
        return problem
    nbm, nbk, bm, bk = a_bm.shape[-4:]
    return nbm * bm, b_bm.shape[-4] * b_bm.shape[-1], nbk * bk


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.mf_error_string(err).decode()}")


def matrixflow_gemm_block_major(
    a_bm: torch.Tensor, b_bm: torch.Tensor, *,
    out_dtype: Optional[torch.dtype] = None,
    backward: bool = False,
    problem: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """C_bm = A_bm @ B_bm over MatrixFlow block-major operands (K1).

    a_bm (nbm, nbk, bm, bk), b_bm (nbn, nbk, bk, bn) → C_bm (nbm, nbn, bm,
    bn); with a leading batch dim on both, (G, ...) → (G, nbm, nbn, bm,
    bn), G problems in one launch. Accumulates in fp32 (int32 for int8);
    ``out_dtype`` defaults to the accumulator dtype, as in the TPU kernel.
    On the card bf16 operands run on the tensor cores (:func:`route_for`),
    others on the CUDA cores; a batch takes the ``wgmma`` or ``cuda_core``
    route. ``backward`` marks a launch made for a gradient
    (``core/api.py``), counted also in ``.backward_launches``. The
    operands carry no autograd history: ``core/api.py`` wraps this call in
    the autograd Function whose backward is this call again. ``problem``
    is the logical (M, N, K) inside the padded blocks, the least work the
    cost ledger records on ``meta`` (default: the padded extent).
    """
    batched = a_bm.dim() == 5
    _check_operands(a_bm, b_bm, batched)
    out_dtype = out_dtype or acc_dtype_for(a_bm.dtype)
    if a_bm.device.type == "cpu":
        return plain(a_bm, b_bm, out_dtype=out_dtype)
    _check_launch(a_bm, b_bm)
    G = a_bm.shape[0] if batched else 1
    require(*launch_preconditions(a_bm.shape, b_bm.shape, a_bm.dtype,
                                  out_dtype, batch=G if batched else 0))
    nbm, nbk, bm, bk = a_bm.shape[-4:]
    nbn, bn = b_bm.shape[-4], b_bm.shape[-1]
    route = route_for(a_bm.dtype, bm)
    c_bm = torch.empty((*a_bm.shape[:-4], nbm, nbn, bm, bn),
                       dtype=out_dtype, device=a_bm.device)
    if a_bm.device.type == "meta":
        M, N, K = _problem(problem, a_bm, b_bm)
        RA.record_launch("matrixflow_gemm", route, M=M, N=N, K=K,
                         dtype=a_bm.dtype, out_dtype=out_dtype, G=G,
                         marks=("batched",) * batched
                         + ("backward",) * backward)
        return c_bm
    lib = _lib()
    stream = torch.cuda.current_stream(a_bm.device).cuda_stream
    if route == "cuda_core":
        err = lib.mf_gemm(_IN_CODES[a_bm.dtype], _OUT_CODES[out_dtype], bm,
                          bn, a_bm.data_ptr(), b_bm.data_ptr(),
                          c_bm.data_ptr(), nbm, nbn, nbk, bk, G, stream)
    else:
        gm, tn, splits = tc_tile(bm, bn, nbm, nbn, nbk, bk)
        err = lib.mf_gemm_tc(_OUT_CODES[out_dtype], bm, bn, gm, tn, splits,
                             a_bm.data_ptr(), b_bm.data_ptr(),
                             c_bm.data_ptr(), nbm, nbn, nbk, bk, G, stream)
    _raise_on(err, lib, f"matrixflow_gemm ({route} route)")
    fn = matrixflow_gemm_block_major
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)
    fn.batched_launches += batched
    fn.backward_launches += backward
    return c_bm


matrixflow_gemm_block_major.launches = 0
matrixflow_gemm_block_major.wgmma_launches = 0
matrixflow_gemm_block_major.mma_launches = 0
matrixflow_gemm_block_major.cuda_core_launches = 0
matrixflow_gemm_block_major.batched_launches = 0
matrixflow_gemm_block_major.backward_launches = 0


def matrixflow_gemm_dequant(
    a_bm: torch.Tensor, b_bm: torch.Tensor,
    scale_a: Optional[torch.Tensor], scale_b: Optional[torch.Tensor], *,
    out_dtype: torch.dtype = torch.float32,
    problem: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """The W8A8 GEMM (K2): C_bm = (A_bm @ B_bm) · s_a[m] · s_b[n].

    int8 a_bm (nbm, nbk, bm, bk) and b_bm (nbn, nbk, bk, bn); ``scale_a``
    holds at most nbm·bm row scales and ``scale_b`` at most nbn·bn channel
    scales (fp32; rows and channels past them, or all when None, scale by
    1 — the kernel reads them in place, without a padded copy).
    Accumulates in int32; each C block is written once, as
    ``float(acc) * s_a[m] * s_b[n]`` in ``out_dtype`` (fp32 or bf16). On
    the card it runs on the tensor cores (:func:`route_for` with
    ``dequant=True``, :func:`tc_tile`), bitwise equal to the plain version.
    ``problem`` as in :func:`matrixflow_gemm_block_major`.
    """
    refuse_grad("matrixflow_gemm_dequant (K2)", scale_a, scale_b,
                remedy="the W8A8 route has no backward")
    _check_operands(a_bm, b_bm)
    if a_bm.dtype != torch.int8:
        raise ValueError(f"the dequant GEMM takes int8 operands, got "
                         f"{a_bm.dtype}")
    nbm, nbk, bm, bk = a_bm.shape
    nbn, bn = b_bm.shape[0], b_bm.shape[3]
    for name, sc, n in (("scale_a", scale_a, nbm * bm),
                        ("scale_b", scale_b, nbn * bn)):
        if sc is not None and (sc.dim() != 1 or sc.shape[0] > n):
            raise ValueError(f"{name} {tuple(sc.shape)} must be 1-D with at "
                             f"most {n} entries (the block grid)")
        if sc is not None and sc.device != a_bm.device:
            raise ValueError(f"{name} is on {sc.device}, operands on "
                             f"{a_bm.device}")
    if a_bm.device.type == "cpu":
        return plain(a_bm, b_bm, out_dtype=out_dtype, scale_a=scale_a,
                     scale_b=scale_b)
    _check_launch(a_bm, b_bm)
    require(*launch_preconditions(a_bm.shape, b_bm.shape, a_bm.dtype,
                                  out_dtype, dequant=True))
    sa, sb = (None if sc is None else sc.float().contiguous()
              for sc in (scale_a, scale_b))
    c_bm = torch.empty((nbm, nbn, bm, bn), dtype=out_dtype,
                       device=a_bm.device)
    route = route_for(a_bm.dtype, bm, dequant=True)
    if a_bm.device.type == "meta":
        M, N, K = _problem(problem, a_bm, b_bm)
        RA.record_launch("matrixflow_gemm_dequant", route, M=M, N=N, K=K,
                         out_dtype=out_dtype)
        return c_bm
    gm, tn, splits = tc_tile(bm, bn, nbm, nbn, nbk, bk)
    lib = _lib()
    _raise_on(lib.mf_gemm_dequant(
        _OUT_CODES[out_dtype], bm, bn, gm, tn, splits, a_bm.data_ptr(),
        b_bm.data_ptr(),
        None if sa is None else sa.data_ptr(), 0 if sa is None else len(sa),
        None if sb is None else sb.data_ptr(), 0 if sb is None else len(sb),
        c_bm.data_ptr(), nbm, nbn, nbk, bk,
        torch.cuda.current_stream(a_bm.device).cuda_stream),
        lib, f"matrixflow_gemm_dequant ({route} route)")
    fn = matrixflow_gemm_dequant
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)
    return c_bm


matrixflow_gemm_dequant.launches = 0
matrixflow_gemm_dequant.wgmma_launches = 0
matrixflow_gemm_dequant.mma_launches = 0


# ---------------------------------------------------------------------------
# The launch grids, stated for the static checker
# ---------------------------------------------------------------------------

def gemm_preconditions(a_shape, b_shape, blk: L.BlockLayout):
    """The reference's entry guards (``repro/kernels/matrixflow_gemm.py::
    gemm_preconditions``): the K stream the operands walk, and blocks that
    match the layout."""
    nbm, nbk, bm, bk = a_shape[-4:]
    nbn, nbk2, bk2, bn = b_shape[-4:]
    return (
        Precondition.check(
            "A/B K-stream agreement",
            (nbk, bk) == (nbk2, bk2),
            f"block-major operands disagree on the K stream: a_bm "
            f"{tuple(a_shape)} walks {nbk} blocks of bk={bk}, b_bm "
            f"{tuple(b_shape)} walks {nbk2} blocks of bk={bk2}"),
        Precondition.check(
            "blocks match layout",
            (bm, bn, bk) == (blk.bm, blk.bn, blk.bk),
            f"operand blocks (bm={bm}, bn={bn}, bk={bk}) do not match the "
            f"BlockLayout (bm={blk.bm}, bn={blk.bn}, bk={blk.bk}); "
            f"re-layout with core.layout.to_block_major_* under this blk"),
    )


def _cpu_contract(nbm, nbn, nbk, bm, bn, bk, fused, pre) -> KernelContract:
    """The plain version's geometry, the reference's grid (nbm, nbn, nbk)
    with the K stream innermost and sequential."""
    operands = [
        OperandSpec("a_bm", "input", (nbm, nbk, 1, 1), (1, 1, bm, bk),
                    lambda i, j, k: (i, k, 0, 0)),
        OperandSpec("b_bm", "input", (nbn, nbk, 1, 1), (1, 1, bk, bn),
                    lambda i, j, k: (j, k, 0, 0)),
        OperandSpec("c_bm", "output", (nbm, nbn, 1, 1), (1, 1, bm, bn),
                    lambda i, j, k: (i, j, 0, 0), reduction_axes=(2,)),
    ]
    if fused:
        operands += [
            OperandSpec("scale_a", "input", (nbm, 1), (bm, 1),
                        lambda i, j, k: (i, 0)),
            OperandSpec("scale_b", "input", (1, nbn), (1, bn),
                        lambda i, j, k: (0, j)),
        ]
    return KernelContract(
        kernel="matrixflow_gemm", grid=(nbm, nbn, nbk),
        operands=tuple(operands),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        preconditions=pre,
        description="plain Algorithm 1 (kernels/ref.py::block_matmul_ref)")


@register_contract("matrixflow_gemm")
def gemm_contract(*, a_shape, b_shape, blk: L.BlockLayout,
                  fused: bool = False, device="cuda",
                  dtype: Optional[torch.dtype] = None,
                  batch: int = 0) -> KernelContract:
    """Contract of one K1 launch (K2's with ``fused``) over block-major
    operands ``a_shape`` (nbm, nbk, bm, bk) and ``b_shape`` (nbn, nbk, bk,
    bn) of ``dtype`` (default bf16; int8 for K2), ``batch`` problems in
    one launch (0: unbatched).

    For a CUDA device the grid is the launch's, on the route
    :func:`route_for` names, tiled by :func:`tc_tile`, with the loops a CTA
    walks innermost; for the CPU, the reference's grid (nbm, nbn, nbk) of
    the plain version. C is revisited along the K stream, and on the
    ``mma`` route along the split axis, whose CTAs form one cluster."""
    nbm, nbk, bm, bk = a_shape[-4:]
    nbn, _, _, bn = b_shape[-4:]
    dtype = dtype or (torch.int8 if fused else torch.bfloat16)
    out_dtype = torch.float32 if fused else acc_dtype_for(dtype)
    pre = gemm_preconditions(a_shape, b_shape, blk)
    if torch.device(device).type == "cpu":
        return _cpu_contract(nbm, nbn, nbk, bm, bn, bk, fused, pre)
    pre += launch_preconditions(a_shape, b_shape, dtype, out_dtype,
                                dequant=fused, batch=batch)
    G = max(batch, 1)
    route = route_for(dtype, bm, dequant=fused)
    gm, tn, splits = (tc_tile(bm, bn, nbm, nbn, nbk, bk)
                      if route != "cuda_core" and bn in L.BN_CHOICES
                      else (1, bn, 1))
    gn = tn // bn
    spb = bk // L.K_SLICE if bk % L.K_SLICE == 0 else 1
    total = nbk * spb
    if route == "cuda_core":
        # mf_gemm_kernel: grid (nbn, nbm, batch) at csrc/matrixflow_gemm.cu
        # :233; C block (i = blockIdx.y, j = blockIdx.x) of problem z =
        # blockIdx.z (:216, :223), the whole K stream walked by the CTA
        # (gemm_tile, :134-:137)
        grid = (nbn, nbm, G, nbk)
        sem = ("parallel", "parallel", "parallel", "arbitrary")
        a_map = lambda x, y, z, k: (z, y, k, 0, 0)
        b_map = lambda x, y, z, k: (z, x, k, 0, 0)
        c_map = lambda x, y, z, k: (z, y, x, 0, 0)
        a_blocks, b_blocks = (G, nbm, nbk, 1, 1), (G, nbn, nbk, 1, 1)
        red, cluster = (3,), 1
    elif route == "wgmma":
        # mf_gemm_wgmma_kernel (K2: mf_gemm_dequant_wgmma_kernel): grid
        # (ceil(nbn / gn), ceil(nbm / GM), batch) at :661 (:1152); CTA (x,
        # y) owns C blocks i0 + wg, j0 + jj with i0 = blockIdx.y * GM, j0 =
        # blockIdx.x * gn at :410 (:885); a block past nbm or nbn reads
        # zeros and is not written (ok = i < nbm, :426; ok = j < nbn, :437;
        # :479, :486); the K stream in slices, kb = step / spb at :420
        grid = (L.cdiv(nbn, gn), L.cdiv(nbm, gm), G, gm, gn, nbk)
        sem = ("parallel",) * 5 + ("arbitrary",)

        def a_map(x, y, z, wg, jj, k):
            i = y * gm + wg
            return (z, i, k, 0, 0) if i < nbm else None

        def b_map(x, y, z, wg, jj, k):
            j = x * gn + jj
            return (z, j, k, 0, 0) if j < nbn else None

        def c_map(x, y, z, wg, jj, k):
            i, j = y * gm + wg, x * gn + jj
            return (z, i, j, 0, 0) if i < nbm and j < nbn else None
        a_blocks, b_blocks = (G, nbm, nbk, 1, 1), (G, nbn, nbk, 1, 1)
        red, cluster = (5,), 1
    else:
        # mf_gemm_mma_kernel (K2: mf_gemm_dequant_mma_kernel): grid (nbn,
        # nbm, splits) at :673, the splits CTAs of one C block one cluster
        # (:678-:681); CTA (j, i, z) at :533 (:1030) takes the z-th of
        # splits even shares [lo, hi) of the K stream's 32-deep slices
        # (:535-:536), slice g = lo + s at kb = g / spb, kc = g - kb * spb
        # while g < hi (:548-:549, :561-:562); the cluster adds the
        # partial tiles, CTA z writing its share of C (:638-:642)
        def share(z):
            return total * z // splits, total * (z + 1) // splits
        steps = max(hi - lo for lo, hi in map(share, range(splits)))
        grid = (nbn, nbm, splits, steps)
        sem = ("parallel", "parallel", "cluster", "arbitrary")

        def a_map(x, y, z, s):
            lo, hi = share(z)
            g = lo + s
            return (0, y, g // spb, 0, g % spb) if g < hi else None

        def b_map(x, y, z, s):
            lo, hi = share(z)
            g = lo + s
            return (0, x, g // spb, g % spb, 0) if g < hi else None

        def c_map(x, y, z, s):
            return (0, y, x, 0, 0)
        a_blocks, b_blocks = (1, nbm, nbk, 1, spb), (1, nbn, nbk, spb, 1)
        red, cluster = (2, 3), splits
    a_block = (1, 1, 1, bm, bk if a_blocks[-1] == 1 else L.K_SLICE)
    b_block = (1, 1, 1, bk if b_blocks[-2] == 1 else L.K_SLICE, bn)
    operands = [
        OperandSpec("a_bm", "input", a_blocks, a_block, a_map),
        OperandSpec("b_bm", "input", b_blocks, b_block, b_map),
        OperandSpec("c_bm", "output", (G, nbm, nbn, 1, 1), (1, 1, 1, bm, bn),
                    c_map, reduction_axes=red),
    ]
    if fused:
        # the row and channel scales of C block (i, j), read at its flush
        def sa_map(*pt):
            c = c_map(*pt)
            return None if c is None else (c[1],)

        def sb_map(*pt):
            c = c_map(*pt)
            return None if c is None else (c[2],)
        operands += [
            OperandSpec("scale_a", "input", (nbm,), (bm,), sa_map),
            OperandSpec("scale_b", "input", (nbn,), (bn,), sb_map),
        ]
    kernel = "matrixflow_gemm_dequant" if fused else "matrixflow_gemm"
    return KernelContract(
        kernel="matrixflow_gemm", grid=grid, operands=tuple(operands),
        dimension_semantics=sem, preconditions=pre, cluster=cluster,
        description=f"{kernel} {route} (gm={gm}, tn={tn}, splits={splits}"
                    f"{f', batch={batch}' if batch else ''})")
