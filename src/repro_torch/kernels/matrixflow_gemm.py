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

K2 takes the two tensor-core routes with int8 operands (s8 ``wgmma`` at
bm = 64, s8 ``mma.sync`` at bm = 16 and 32, the same tiles and splits,
:func:`tc_tile`), counted on its wrapper as ``.wgmma_launches`` and
``.mma_launches``; it has no CUDA-core route.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import layout as L
from repro_torch.kernels import _build
from repro_torch.kernels.ref import acc_dtype_for, block_matmul_ref

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
        lib.mf_gemm.argtypes = [i, i, i, i, vp, vp, vp, i, i, i, i, vp]
        lib.mf_gemm.restype = ctypes.c_int
        lib.mf_gemm_tc.argtypes = [i, i, i, i, i, i, vp, vp, vp, i, i, i, i,
                                   vp]
        lib.mf_gemm_tc.restype = ctypes.c_int
        lib.mf_gemm_dequant.argtypes = [i, i, i, i, i, i, vp, vp, vp, i,
                                        vp, i, vp, i, i, i, i, vp]
        lib.mf_gemm_dequant.restype = ctypes.c_int
        lib.mf_error_string.argtypes = [i]
        lib.mf_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(a_bm: torch.Tensor, b_bm: torch.Tensor) -> None:
    if a_bm.dim() != 4 or b_bm.dim() != 4:
        raise ValueError(f"block-major operands must be 4-D, got "
                         f"{tuple(a_bm.shape)} and {tuple(b_bm.shape)}")
    nbm, nbk, bm, bk = a_bm.shape
    nbn, nbk2, bk2, bn = b_bm.shape
    if (nbk, bk) != (nbk2, bk2):
        raise ValueError(
            f"block-major operands disagree on the K stream: a_bm "
            f"{tuple(a_bm.shape)} walks {nbk} blocks of bk={bk}, b_bm "
            f"{tuple(b_bm.shape)} walks {nbk2} blocks of bk={bk2}")
    if a_bm.dtype != b_bm.dtype:
        raise ValueError(f"operand dtypes differ: {a_bm.dtype} vs {b_bm.dtype}")
    if a_bm.device != b_bm.device:
        raise ValueError(f"operands on {a_bm.device} and {b_bm.device}")


def _check_launch(a_bm: torch.Tensor, b_bm: torch.Tensor) -> None:
    """What the CUDA kernels take beyond :func:`_check_operands`."""
    if a_bm.device.type != "cuda":
        raise ValueError(f"no MatrixFlow GEMM for device {a_bm.device}")
    bm, bk, bn = a_bm.shape[2], a_bm.shape[3], b_bm.shape[3]
    if bm not in L.BM_CHOICES or bn not in L.BN_CHOICES or bk % L.K_SLICE:
        raise ValueError(
            f"block geometry (bm={bm}, bn={bn}, bk={bk}) is not one the "
            f"kernel instantiates: bm in {L.BM_CHOICES}, bn in "
            f"{L.BN_CHOICES}, bk a multiple of {L.K_SLICE} "
            f"(core/layout.py::choose_layout picks these)")
    if not (a_bm.is_contiguous() and b_bm.is_contiguous()):
        raise ValueError("block-major operands must be contiguous")
    if a_bm.data_ptr() % 16 or b_bm.data_ptr() % 16:
        raise ValueError("operands must be 16-byte aligned")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.mf_error_string(err).decode()}")


def matrixflow_gemm_block_major(
    a_bm: torch.Tensor, b_bm: torch.Tensor, *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """C_bm = A_bm @ B_bm over MatrixFlow block-major operands (K1).

    a_bm (nbm, nbk, bm, bk), b_bm (nbn, nbk, bk, bn) → C_bm (nbm, nbn, bm,
    bn). Accumulates in fp32 (int32 for int8); ``out_dtype`` defaults to
    the accumulator dtype, as in the TPU kernel. On the card bf16 operands
    run on the tensor cores (:func:`route_for`), others on the CUDA cores.
    """
    _check_operands(a_bm, b_bm)
    out_dtype = out_dtype or acc_dtype_for(a_bm.dtype)
    if a_bm.device.type == "cpu":
        return plain(a_bm, b_bm, out_dtype=out_dtype)
    _check_launch(a_bm, b_bm)
    if (a_bm.dtype, out_dtype) not in _PAIRS:
        raise ValueError(f"the kernel takes {sorted(map(str, _PAIRS))} "
                         f"(input, output) dtypes, not ({a_bm.dtype}, "
                         f"{out_dtype})")
    nbm, nbk, bm, bk = a_bm.shape
    nbn, bn = b_bm.shape[0], b_bm.shape[3]
    c_bm = torch.empty((nbm, nbn, bm, bn), dtype=out_dtype,
                       device=a_bm.device)
    lib = _lib()
    stream = torch.cuda.current_stream(a_bm.device).cuda_stream
    route = route_for(a_bm.dtype, bm)
    if route == "cuda_core":
        err = lib.mf_gemm(_IN_CODES[a_bm.dtype], _OUT_CODES[out_dtype], bm,
                          bn, a_bm.data_ptr(), b_bm.data_ptr(),
                          c_bm.data_ptr(), nbm, nbn, nbk, bk, stream)
    else:
        gm, tn, splits = tc_tile(bm, bn, nbm, nbn, nbk, bk)
        err = lib.mf_gemm_tc(_OUT_CODES[out_dtype], bm, bn, gm, tn, splits,
                             a_bm.data_ptr(), b_bm.data_ptr(),
                             c_bm.data_ptr(), nbm, nbn, nbk, bk, stream)
    _raise_on(err, lib, f"matrixflow_gemm ({route} route)")
    fn = matrixflow_gemm_block_major
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)
    return c_bm


matrixflow_gemm_block_major.launches = 0
matrixflow_gemm_block_major.wgmma_launches = 0
matrixflow_gemm_block_major.mma_launches = 0
matrixflow_gemm_block_major.cuda_core_launches = 0


def matrixflow_gemm_dequant(
    a_bm: torch.Tensor, b_bm: torch.Tensor,
    scale_a: Optional[torch.Tensor], scale_b: Optional[torch.Tensor], *,
    out_dtype: torch.dtype = torch.float32,
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
    """
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
    if out_dtype not in _DEQUANT_OUT:
        raise ValueError(f"the dequant kernel writes {_DEQUANT_OUT}, not "
                         f"{out_dtype}")
    sa, sb = (None if sc is None else sc.float().contiguous()
              for sc in (scale_a, scale_b))
    c_bm = torch.empty((nbm, nbn, bm, bn), dtype=out_dtype,
                       device=a_bm.device)
    route = route_for(a_bm.dtype, bm, dequant=True)
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
