"""MatrixFlow block-major layouts (paper §3.3), in PyTorch.

The transforms are the same pure moves as ``repro/core/layout.py`` — bitwise
the same result for any block geometry:

    A : (M, K)  row-major        →  A_bm : (M/bm, K/bk, bm, bk)
    B : (K, N)  row-major        →  B_bm : (N/bn, K/bk, bk, bn)   ("horizontal split")
    C : (M, N)                   ←  C_bm : (M/bm, N/bn, bm, bn)

Every block is one contiguous region, so the GEMM kernel
(``kernels/matrixflow_gemm.py``) streams each one as a run of 16-byte loads.

What differs from the TPU package is the block chooser. The TPU chooser
fills a 96 MiB VMEM budget with blocks up to 512×2048; a Hopper block has at
most 227 KB of shared memory, so :func:`choose_layout` picks MMA-aligned
blocks (bm a multiple of the m16 of ``mma.sync``, bn of n8, bk of the
32-deep K slice the kernel stages) whose A and B tiles fit
:data:`SMEM_BUDGET` together.
"""
from __future__ import annotations

import dataclasses

import torch

PAGE_BYTES = 4096          # the paper's memory-page transfer unit

# Shared memory one thread block may use on an H100 (232,448 bytes of the
# SM's 256 KB). One A block plus one B block must fit it together.
SMEM_BUDGET = 232_448
# The GEMM kernel's tile sets (csrc/matrixflow_gemm.cu instantiates exactly
# these): bm for the M side, bn for the N side, and the K slice depth.
BM_CHOICES = (16, 32, 64)
BN_CHOICES = (32, 64, 128)
K_SLICE = 32
DC_MAX_BK = 256            # "dc": fine K granularity, deeper pipelines


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Geometry of a MatrixFlow block decomposition for C = A @ B.

    ``mode`` follows the paper's two access policies: ``dc`` (direct-cache:
    fine-grained K) and ``dm`` (direct-memory: large K bursts).
    """

    bm: int
    bn: int
    bk: int
    mode: str = "dm"


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def bm_for(M: int) -> int:
    """The smallest kernel row tile covering M (capped at the largest), so
    a decode GEMM with M = batch_slots pads to 16 rows, not 64."""
    for bm in BM_CHOICES:
        if M <= bm:
            return bm
    return BM_CHOICES[-1]


def bn_for(N: int) -> int:
    """Column tile by N: wide outputs (the LM head) take 128 columns per
    block; narrow ones take 32 so that more blocks — one CTA each — cover
    the card."""
    if N >= 8192:
        return 128
    if N >= 2048:
        return 64
    return 32


def bk_for(K: int, bn: int, dtype: torch.dtype, mode: str) -> int:
    """K block: a multiple of :data:`K_SLICE`, at most the budget allows
    for an A block of the tallest row tile plus a B block, split evenly so
    that padding K costs at most one slice per block."""
    if mode == "dc":
        cap = DC_MAX_BK
    elif mode == "dm":
        cap = SMEM_BUDGET // ((BM_CHOICES[-1] + bn) * dtype.itemsize)
        cap = cap // K_SLICE * K_SLICE
    else:
        raise ValueError(f"unknown access mode: {mode!r}")
    nbk = cdiv(round_up(K, K_SLICE), cap)
    return round_up(cdiv(K, nbk), K_SLICE)


def choose_layout(M: int, N: int, K: int, dtype: torch.dtype = torch.bfloat16,
                  *, mode: str = "dm") -> BlockLayout:
    """The Hopper block chooser (see the module docstring)."""
    bn = bn_for(N)
    return BlockLayout(bm_for(M), bn, bk_for(K, bn, dtype, mode), mode)


# ---------------------------------------------------------------------------
# Layout transforms (pure, invertible)
# ---------------------------------------------------------------------------

def pad_to_blocks(x: torch.Tensor, b0: int, b1: int) -> torch.Tensor:
    """Zero-pad the trailing 2 dims of ``x`` up to multiples of (b0, b1)."""
    m, n = x.shape[-2:]
    pm, pn = round_up(m, b0) - m, round_up(n, b1) - n
    if pm == 0 and pn == 0:
        return x
    return torch.nn.functional.pad(x, (0, pn, 0, pm))


def to_block_major_a(a: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(…, M, K) row-major → (…, M/bm, K/bk, bm, bk) block-major."""
    a = pad_to_blocks(a, bm, bk)
    *lead, M, K = a.shape
    a = a.reshape(*lead, M // bm, bm, K // bk, bk)
    return a.movedim(-3, -2).contiguous()


def from_block_major_a(a_bm: torch.Tensor, M: int, K: int) -> torch.Tensor:
    *lead, nbm, nbk, bm, bk = a_bm.shape
    a = a_bm.movedim(-2, -3).reshape(*lead, nbm * bm, nbk * bk)
    return a[..., :M, :K]


def to_block_major_b(b: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """(…, K, N) row-major → (…, N/bn, K/bk, bk, bn) block-major: the
    paper's horizontal split, so the K-walk of one output column block is
    one contiguous streak."""
    b = pad_to_blocks(b, bk, bn)
    *lead, K, N = b.shape
    b = b.reshape(*lead, K // bk, bk, N // bn, bn)
    return b.movedim(-2, -4).contiguous()


def from_block_major_b(b_bm: torch.Tensor, K: int, N: int) -> torch.Tensor:
    *lead, nbn, nbk, bk, bn = b_bm.shape
    b = b_bm.movedim(-4, -2).reshape(*lead, nbk * bk, nbn * bn)
    return b[..., :K, :N]


def to_block_major_c(c: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    c = pad_to_blocks(c, bm, bn)
    *lead, M, N = c.shape
    c = c.reshape(*lead, M // bm, bm, N // bn, bn)
    return c.movedim(-3, -2).contiguous()


def from_block_major_c(c_bm: torch.Tensor, M: int, N: int) -> torch.Tensor:
    *lead, nbm, nbn, bm, bn = c_bm.shape
    c = c_bm.movedim(-2, -3).reshape(*lead, nbm * bm, nbn * bn)
    return c[..., :M, :N]


# ---------------------------------------------------------------------------
# Transfer-contiguity accounting (feeds core/sysmodel.py)
# ---------------------------------------------------------------------------

def descriptors_per_block_conventional(
    rows: int, cols: int, row_stride_bytes: int, itemsize: int,
    page_bytes: int = PAGE_BYTES,
) -> int:
    """DMA descriptors to fetch a (rows × cols) block from a *row-major*
    matrix: one per row segment, plus one per page boundary it crosses."""
    seg_bytes = cols * itemsize
    total = 0
    for r in range(rows):
        start = r * row_stride_bytes
        first_page = start // page_bytes
        last_page = (start + seg_bytes - 1) // page_bytes
        total += 1 + (last_page - first_page)
    return total


def descriptors_per_block_matrixflow(
    rows: int, cols: int, itemsize: int, page_bytes: int = PAGE_BYTES,
) -> int:
    """Block-major: the block is one contiguous region → ceil(bytes / page)."""
    return cdiv(rows * cols * itemsize, page_bytes)
