"""Public MatrixFlow API of the port: GEMMs and attention through policies
and backend registries (``repro/core/api.py``).

GEMM backends (:class:`~repro_torch.core.plan.GemmPolicy`):

  "torch"       ``torch.matmul`` — the vendor matmul, in the role the JAX
                package gives XLA. Consumes batched contractions natively.
  "blockflow"   the plain Algorithm 1 over block-major operands
                (kernels/ref.py::block_matmul_ref), on any device.
  "matrixflow"  the MatrixFlow CUDA kernel (kernels/matrixflow_gemm.py);
                on CPU tensors its wrapper runs the plain version.

Attention backends (:class:`~repro_torch.core.plan.AttentionPolicy`):

  "unfused"     the plain masked softmax over dense K/V (kernels/ref.py::
                mha_ref); rejects paged caches.
  "fused"       the offset-aware flash attention CUDA kernel over dense K/V
                (kernels/flash_attention.py): the cache-less forward and
                contiguous KV caches; rejects paged caches.
  "paged"       the block-table paged attention CUDA kernel
                (kernels/paged_attention.py); without a block table the
                operands are dense and it falls back to the flash kernel
                (the same contract), so one policy covers a model end to
                end.

On CPU tensors the kernel wrappers run their plain versions.

Weights that persist across calls are packed block-major once
(``pack_model_weights``); ``linear``/``matmul`` consume the PackedWeight's
blocks directly. A QuantizedPackedWeight runs the W8A8 route on every GEMM
backend (``core/quant.py``): the activations are quantized per row, the
GEMM runs int8 × int8 → int32 and is rescaled by the row and channel
scales — fused into the flush of the MatrixFlow kernel (K2) on the card.
Under ``GemmPolicy(weight_dtype="int8")`` ``linear`` quantizes a raw fp
weight on the fly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

from repro_torch.core import layout as L
from repro_torch.core import plan as P
from repro_torch.core import quant as Q
from repro_torch.core.plan import (  # re-exported: the public policy surface
    AttentionPolicy, ExecutionPlan, GemmPolicy, PackedWeight,
    QuantizedPackedWeight, pack_model_weights, pack_weight, plan,
    register_attention_backend, register_backend)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.ref import acc_dtype_for, block_matmul_ref, mha_ref

__all__ = [
    "GemmPolicy", "ExecutionPlan", "PackedWeight", "QuantizedPackedWeight",
    "AttentionPolicy",
    "pack_weight", "pack_model_weights", "plan",
    "matmul", "linear", "attention", "use_policy", "current_policy",
    "use_attention_policy", "current_attention_policy",
]

_state = threading.local()


def current_policy() -> GemmPolicy:
    """The active GemmPolicy (innermost use_policy, else the default)."""
    stack = getattr(_state, "policies", None)
    return stack[-1] if stack else GemmPolicy()


@contextlib.contextmanager
def use_policy(policy: GemmPolicy):
    """Pin the active GEMM policy for the enclosed region (thread-local)."""
    stack = getattr(_state, "policies", None)
    if stack is None:
        stack = _state.policies = []
    stack.append(policy)
    try:
        yield policy
    finally:
        stack.pop()


def current_attention_policy() -> AttentionPolicy:
    stack = getattr(_state, "attn_policies", None)
    return stack[-1] if stack else AttentionPolicy()


@contextlib.contextmanager
def use_attention_policy(policy: AttentionPolicy):
    """Pin the active attention policy for the enclosed region."""
    stack = getattr(_state, "attn_policies", None)
    if stack is None:
        stack = _state.attn_policies = []
    stack.append(policy)
    try:
        yield policy
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# Built-in GEMM backends
# ---------------------------------------------------------------------------

def _torch_gemm(a, b, pln: ExecutionPlan, out_dtype):
    if isinstance(b, QuantizedPackedWeight):
        aq, sa = Q.quantize_activations(a)
        c = torch.matmul(aq.double(), b.unpack_quantized().double())
        return Q.dequantize_gemm(c, sa, b.scales, out_dtype)
    if isinstance(b, PackedWeight):
        b = b.unpack()
    if a.dtype.is_floating_point:
        return torch.matmul(a, b).to(out_dtype)
    # CUDA has no integer matmul; float64 is exact for int8 products
    return torch.matmul(a.double(), b.double()).to(out_dtype)


def _make_block_major_gemm(block_fn, dequant_fn):
    """A backend over ``block_fn(a_bm, b_bm, out_dtype=)`` and, for a
    QuantizedPackedWeight, ``dequant_fn(a_bm, b_bm, scale_a=, scale_b=,
    out_dtype=)``: lay A out block-major (quantized per row first on the
    W8A8 route), take B's resident blocks (or lay B out), run, un-block
    C."""
    def gemm(a2, b, pln: ExecutionPlan, out_dtype):
        M = a2.shape[0]
        if isinstance(b, QuantizedPackedWeight):
            aq, sa = Q.quantize_activations(a2)
            blk = P.layout_for_packed(M, b)
            a_bm = L.to_block_major_a(aq, blk.bm, blk.bk)
            c_bm = dequant_fn(a_bm, b.data, scale_a=sa, scale_b=b.scales,
                              out_dtype=out_dtype)
            return L.from_block_major_c(c_bm, M, b.n)
        if isinstance(b, PackedWeight):
            blk = P.layout_for_packed(M, b)
            b_bm, N = b.data, b.n
        else:
            blk = pln.layout
            b_bm, N = L.to_block_major_b(b, blk.bk, blk.bn), b.shape[1]
        a_bm = L.to_block_major_a(a2, blk.bm, blk.bk)
        c_bm = block_fn(a_bm, b_bm, out_dtype=out_dtype)
        return L.from_block_major_c(c_bm, M, N)
    return gemm


register_backend("torch", _torch_gemm, batched=True, needs_layout=False)
register_backend("blockflow", _make_block_major_gemm(block_matmul_ref,
                                                    block_matmul_ref))
register_backend("matrixflow",
                 _make_block_major_gemm(MF.matrixflow_gemm_block_major,
                                        MF.matrixflow_gemm_dequant))


def _out_dtype(a: torch.Tensor, b) -> torch.dtype:
    """The promoted input dtype; integer GEMMs surface their int32
    accumulator (an int8 result would truncate). The W8A8 route
    dequantizes to the weight's original dtype, promoted with a's."""
    if isinstance(b, QuantizedPackedWeight):
        return torch.promote_types(a.dtype, getattr(torch, b.dequant_dtype))
    out = torch.promote_types(a.dtype, b.dtype)
    return out if out.is_floating_point else acc_dtype_for(out)


def matmul(a: torch.Tensor, b: Union[torch.Tensor, PackedWeight], *,
           policy: Optional[GemmPolicy] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B through the plan the active policy resolves to.

    a: (..., M, K); b: (K, N), a PackedWeight or a QuantizedPackedWeight
    (a batched backend also takes (..., K, N)). The output dtype defaults
    to the promoted input dtype.
    """
    pol = policy if policy is not None else current_policy()
    quantized = isinstance(b, QuantizedPackedWeight)
    packed = quantized or isinstance(b, PackedWeight)
    out_dtype = out_dtype or _out_dtype(a, b)
    spec = P.get_backend_spec(pol.resolved_backend(a.device))
    K = a.shape[-1]
    if spec.batched and not packed:
        M = a.numel() // K if a.dim() > 1 else 1
        return spec.fn(a, b, plan(M, b.shape[-1], K, a.dtype, pol, a.device),
                       out_dtype)
    if not packed and b.dim() != 2:
        raise ValueError(f"GEMM backend {spec.name!r} takes a 2-D rhs or a "
                         f"PackedWeight, got {tuple(b.shape)}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, K)
    N = b.n if packed else b.shape[1]
    # the W8A8 route plans for the int8 problem the kernel runs
    pln = plan(a2.shape[0], N, K, torch.int8 if quantized else a2.dtype, pol,
               a.device)
    c = spec.fn(a2, b, pln, out_dtype)
    return c.reshape(*lead, N).to(out_dtype)


def linear(x: torch.Tensor,
           w: Union[torch.Tensor, PackedWeight, QuantizedPackedWeight],
           bias: Optional[torch.Tensor] = None, *,
           policy: Optional[GemmPolicy] = None) -> torch.Tensor:
    """y = x @ w (+ bias): the layer-level entry point the models use.

    Under ``GemmPolicy(weight_dtype="int8")`` a raw 2-D fp weight is
    quantized on the fly, per call (pack once with ``pack_model_weights``
    for resident int8 weights). Only ``linear`` applies the knob to raw
    tensors: ``matmul`` also serves activation × activation products."""
    pol = policy if policy is not None else current_policy()
    if (pol.weight_dtype is not None and isinstance(w, torch.Tensor)
            and w.dim() == 2 and x.dtype.is_floating_point
            and w.dtype.is_floating_point):
        m_hint = max(x.numel() // x.shape[-1], 1)
        w = P.pack_weight(w, pol, m_hint=m_hint, quantize=pol.weight_dtype)
    y = matmul(x, w, policy=pol)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# Attention backends
# ---------------------------------------------------------------------------

def _reject_paged(backend: str, block_tables, kv_scales=None) -> None:
    if block_tables is not None:
        raise ValueError(
            f"attention backend {backend!r} cannot consume a paged KV cache "
            f"(got a block table); use AttentionPolicy(backend='paged')")
    if kv_scales is not None:
        raise ValueError(
            f"attention backend {backend!r} cannot consume a quantized KV "
            f"pool (got kv_scales); use AttentionPolicy(backend='paged', "
            f"kv_dtype='int8')")


def _unfused_attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                       soft_cap, block_tables=None, kv_scales=None):
    _reject_paged("unfused", block_tables, kv_scales)
    return mha_ref(q, k, v, causal=causal, scale=scale, soft_cap=soft_cap,
                   q_positions=q_positions, kv_valid_len=kv_valid_len)


def _fused_attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                     soft_cap, block_tables=None, kv_scales=None):
    _reject_paged("fused", block_tables, kv_scales)
    return FA.flash_attention(q, k, v, q_positions, kv_valid_len,
                              causal=causal, scale=scale, soft_cap=soft_cap)


def _paged_attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                     soft_cap, block_tables=None, kv_scales=None):
    if block_tables is None:       # dense operands: the flash kernel
        if kv_scales is not None:
            raise ValueError("kv_scales belong to int8 page pools; dense "
                             "operands have no pages (pass block_tables)")
        return FA.flash_attention(q, k, v, q_positions, kv_valid_len,
                                  causal=causal, scale=scale,
                                  soft_cap=soft_cap)
    return PA.paged_attention(q, k, v, block_tables, q_positions,
                              kv_valid_len, kv_scales=kv_scales,
                              causal=causal, scale=scale, soft_cap=soft_cap)


register_attention_backend("unfused", _unfused_attention)
register_attention_backend("fused", _fused_attention)
register_attention_backend("paged", _paged_attention)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, kv_valid_len: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              soft_cap: Optional[float] = None,
              block_tables: Optional[torch.Tensor] = None,
              kv_scales=None,
              policy: Optional[AttentionPolicy] = None) -> torch.Tensor:
    """Scaled-dot-product attention through the active AttentionPolicy.

    q (B, Sq, H, Dk); dense k/v (B, T, Hkv, D) or, with ``block_tables``
    (B, n_blocks), page pools (P, page_size, Hkv, D). Key j of row b is
    visible to query i iff ``j < kv_valid_len[b]`` and, when causal,
    ``j <= q_positions[b, i]``; rows with no visible key are zeros. int8
    pools carry ``kv_scales=(k_scales, v_scales)``, fp32 (P, Hkv) each;
    only the ``paged`` backend takes them.
    """
    pol = policy if policy is not None else current_attention_policy()
    spec = P.get_attention_backend_spec(pol.resolved_backend(q.device))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return spec.fn(q, k, v, q_positions=q_positions,
                   kv_valid_len=kv_valid_len, causal=causal, scale=scale,
                   soft_cap=soft_cap, block_tables=block_tables,
                   kv_scales=kv_scales)
