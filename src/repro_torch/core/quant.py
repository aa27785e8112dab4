"""INT8 symmetric quantization for MatrixFlow GEMMs and KV pages — the
port of ``repro/core/quant.py``; payloads and scales are bitwise those of
the JAX package.

* **weights** are quantized offline, symmetric **per output channel**
  (one fp32 scale per column of the (K, N) operand), so the GEMM dequant
  is a rank-1 rescale of the int32 result;
* **activations** are quantized dynamically, symmetric **per row**, at
  the GEMM entry;
* the GEMM runs **int8 × int8 → int32** and
  ``C[m, n] = float(C_i32[m, n]) * s_a[m] * s_b[n]`` — on the card fused
  into the C-block flush of the MatrixFlow kernel
  (``kernels/matrixflow_gemm.py::matrixflow_gemm_dequant``);
* :class:`QuantizedPackedWeight` holds the int8 blocks block-major plus
  the per-channel scales, resident like a fp ``PackedWeight``.

KV pages are int8 **per page per KV head**: one fp32 scale per (page, kv
head), frozen when the page's first row is written (``kv_write_scale``
with ``KV_HEADROOM`` slack) so that the payload is a pure function of the
page's content, whether it was written a token at a time or in bulk.

Bitwise agreement with the JAX package rests on three choices made the
same way: the division is fp32 ``x / s`` (not ``x * (1 / s)``),
``torch.round`` rounds half to even as ``jnp.round`` does, and the grid is
clipped to [−127, 127].
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import layout as L
from repro_torch.models.config import torch_dtype

__all__ = [
    "QMAX", "KV_HEADROOM", "QuantizedPackedWeight",
    "quantize_weight", "dequantize_weight",
    "quantize_activations", "dequantize_gemm",
    "quantize_kv_pages", "dequantize_kv_pages",
    "kv_write_scale", "quantize_kv_rows",
]

QMAX = 127  # symmetric int8 grid [-127, 127]; -128 excluded

# Frozen-scale headroom of a KV page: later rows of a page routinely exceed
# its first row's amax; 2x absorbs the usual spread at the cost of one bit.
KV_HEADROOM = 2.0


def _safe_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax/QMAX with all-zero slices mapped to scale 1 (q = 0 exactly)."""
    amax = amax.float()
    return torch.where(amax > 0, amax / QMAX, torch.ones_like(amax))


def _to_grid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -QMAX, QMAX).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, K, N) fp weight → (int8 (…, K, N), fp32 scales (…, N)):
    per output channel, scale max|w[:, n]| / 127."""
    wf = w.float()
    scales = _safe_scale(wf.abs().amax(dim=-2))
    return _to_grid(wf / scales[..., None, :]), scales


def dequantize_weight(q: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight` up to the rounding error."""
    return (q.float() * scales[..., None, :]).to(torch_dtype(dtype))


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, K) fp activations → (int8 (…, K), fp32 scales (…,)): per row
    (per token), the dynamic half of W8A8."""
    xf = x.float()
    scales = _safe_scale(xf.abs().amax(dim=-1))
    return _to_grid(xf / scales[..., None]), scales


def dequantize_gemm(c_int: torch.Tensor, scale_a: torch.Tensor,
                    scale_b: torch.Tensor, out_dtype=torch.float32
                    ) -> torch.Tensor:
    """int32 GEMM result (M, N) → ``float(C) * s_a[m] * s_b[n]``, the two
    products in that order, then ``out_dtype`` (the unfused dequant)."""
    c = c_int.to(torch.int32).float()
    c = c * scale_a.float()[..., :, None]
    c = c * scale_b.float()[..., None, :]
    return c.to(torch_dtype(out_dtype))


def quantize_kv_pages(pages: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, P, ps, Hkv, dh) fp pages → (int8 pages, fp32 scales (…, P, Hkv)):
    per page per KV head, true amax — the one-shot regime for tests, not
    the serving write path."""
    pf = pages.float()
    scales = _safe_scale(pf.abs().amax(dim=(-3, -1)))
    return _to_grid(pf / scales[..., :, None, :, None]), scales


def dequantize_kv_pages(q: torch.Tensor, scales: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_pages` up to the rounding error."""
    return (q.float() * scales[..., :, None, :, None].float()).to(
        torch_dtype(dtype))


def kv_write_scale(rows: torch.Tensor) -> torch.Tensor:
    """(…, Hkv, dh) first-row K/V → the page's frozen fp32 scale (…, Hkv):
    amax · KV_HEADROOM / QMAX per head (all-zero heads → 1)."""
    return _safe_scale(rows.float().abs().amax(dim=-1) * KV_HEADROOM)


def quantize_kv_rows(rows: torch.Tensor, scales: torch.Tensor
                     ) -> torch.Tensor:
    """(…, Hkv, dh) fp rows against (…, Hkv) scales → int8 on the grid."""
    return _to_grid(rows.float() / scales[..., :, None].float())


@dataclasses.dataclass(frozen=True)
class QuantizedPackedWeight:
    """An int8 GEMM rhs held resident block-major, with per-channel scales.

    data    int8 ``(N/bn, K/bk, bk, bn)``, the quantized horizontally split
            B operand of the paper (Fig. 4);
    scales  fp32 ``(N,)``, one symmetric scale per output channel.

    Carries the geometry fields of :class:`~repro_torch.core.plan.
    PackedWeight`, so layout resolution takes either; built by
    ``pack_weight(w, policy, quantize="int8")``.
    """

    data: torch.Tensor
    scales: torch.Tensor
    k: int                   # logical (unpadded) K
    n: int                   # logical (unpadded) N
    bk: int
    bn: int
    mode: str = "dm"
    dequant_dtype: str = "float32"   # the original weight dtype's name

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def unpack_quantized(self) -> torch.Tensor:
        """Back to row-major int8 (K, N), for layout-free backends."""
        return L.from_block_major_b(self.data, self.k, self.n)

    def to(self, device) -> "QuantizedPackedWeight":
        """The same blocks and scales on ``device``."""
        return dataclasses.replace(self, data=self.data.to(device),
                                   scales=self.scales.to(device))

    def unpack(self) -> torch.Tensor:
        """The dequantized row-major weight in the original dtype."""
        return dequantize_weight(self.unpack_quantized(), self.scales,
                                 self.dequant_dtype)
