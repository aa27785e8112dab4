"""Dispatch wrappers over the kernels, one entry point per kernel
(``repro/kernels/ops.py``), with the reference's signatures:

  * :func:`gemm` — the MatrixFlow GEMM (K1) on row-major operands: the
    paper's DC/DM block geometry chosen by the plan, re-laid out
    block-major around the kernel;
  * :func:`gemm_preformatted` — the deploy path: operands already
    block-major (weights formatted once at load), C block-major;
  * :func:`mha` — flash attention (K3) over model-layout (B, S, H, D)
    tensors;
  * :func:`ssd` — the chunked SSD scan (K6), y only.

``impl=None`` calls the kernel's wrapper, which launches the CUDA kernel
for CUDA tensors and runs its plain version for CPU tensors;
``impl="ref"`` runs the plain reference (``kernels/ref.py``) on any
device. The reference's ``"pallas"`` and ``"interpret"`` are TPU
choices and raise. Models call ``core/api.py``; tests and tools call these
directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.kernel_contracts import Precondition, require
from repro_torch.core import layout as L
from repro_torch.core import plan as P
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matrixflow_gemm import (gemm_preconditions,
                                                 matrixflow_gemm_block_major)
from repro_torch.kernels.ssd_scan import ssd_scan

IMPLS = (None, "ref")


def _impl(impl: Optional[str]) -> Optional[str]:
    if impl not in IMPLS:
        raise ValueError(
            f"impl={impl!r}: the port's choices are None (the kernel's "
            f"wrapper: the CUDA kernel for CUDA tensors, its plain version "
            f"for CPU tensors) and 'ref' (the plain reference); 'pallas' and "
            f"'interpret' are the JAX package's TPU choices")
    return impl


def gemm(a: torch.Tensor, b: torch.Tensor, *, mode: str = "dm",
         out_dtype: Optional[torch.dtype] = None,
         impl: Optional[str] = None) -> torch.Tensor:
    """MatrixFlow GEMM, C = A @ B of row-major a (M, K) and b (K, N).
    impl: None (the wrapper) | 'ref'."""
    if _impl(impl) == "ref":
        return ref.matmul_ref(a, b, out_dtype)
    (M, K), (K2, N) = a.shape, b.shape
    require(Precondition.check(
        "A/B contraction agreement", K == K2,
        f"a has K={K} columns but b has K={K2} rows; C = A @ B needs the "
        f"contraction dims to agree (a {tuple(a.shape)}, b "
        f"{tuple(b.shape)})"))
    blk = P.plan(M, N, K, a.dtype, P.GemmPolicy(backend="matrixflow",
                                                mode=mode), a.device).layout
    c_bm = matrixflow_gemm_block_major(
        L.to_block_major_a(a, blk.bm, blk.bk),
        L.to_block_major_b(b, blk.bk, blk.bn), out_dtype=out_dtype,
        problem=(M, N, K))
    return L.from_block_major_c(c_bm, M, N)


def gemm_preformatted(a_bm: torch.Tensor, b_bm: torch.Tensor, *,
                      blk: L.BlockLayout,
                      out_dtype: Optional[torch.dtype] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Deploy path: operands already block-major (weights formatted once at
    load; activations produced block-major by the previous GEMM — Fig. 5),
    their blocks those of ``blk``; returns C block-major."""
    require(*gemm_preconditions(a_bm.shape, b_bm.shape, blk))
    if _impl(impl) == "ref":
        return ref.block_matmul_ref(a_bm, b_bm, out_dtype=out_dtype)
    return matrixflow_gemm_block_major(a_bm, b_bm, out_dtype=out_dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        soft_cap: Optional[float] = None,
        q_positions: Optional[torch.Tensor] = None,
        kv_valid_len: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
        block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Fused attention over (B, S, H, D)-layout tensors (model layout).

    q_positions (B, Sq) / kv_valid_len (B,) carry the decode/serving offset
    and cache-length semantics (see kernels/flash_attention.py). impl
    'ref' uses the plain reference; otherwise the flash kernel's wrapper.
    ``block_q``/``block_k`` are the reference's tile knobs: the card's
    kernel tiles its rows and keys itself, so they must only be positive."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q={block_q}, block_k={block_k} must be >= 1")
    if _impl(impl) == "ref":
        return ref.mha_ref(q, k, v, causal=causal, scale=scale,
                           soft_cap=soft_cap, q_positions=q_positions,
                           kv_valid_len=kv_valid_len)
    return flash_attention(q, k, v, q_positions, kv_valid_len,
                           causal=causal, scale=scale, soft_cap=soft_cap)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bc: torch.Tensor, Cc: torch.Tensor, *, chunk: int = 128,
        impl: Optional[str] = None) -> torch.Tensor:
    """Chunked SSD scan over (B, S, H, P); returns y. impl as in mha()."""
    if _impl(impl) == "ref":
        return ref.ssd_ref(x, dt, A, Bc, Cc)
    return ssd_scan(x, dt, A, Bc, Cc, chunk=chunk, final_state=False)[0]
