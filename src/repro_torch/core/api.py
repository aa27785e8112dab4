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

  "unfused"     the paper's §4.4 split, as the reference writes it: the
                score and value contractions through the GEMM policy
                (einsum on a batched backend, the batched MatrixFlow GEMM
                otherwise), the masked softmax in PyTorch; rejects paged
                caches. The only attention that trains: the kernels below
                are forward-only.
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

Autograd: on a block-major backend a product of raw operands runs through
an autograd Function whose backward is the same GEMM (dA = dC·Bᵀ and dB =
Aᵀ·dC, each laid out block-major and planned as its own problem): K1
trains on its own kernel, as the reference's ``blockflow`` backend trains
through its plain Algorithm 1. A batched rhs (..., K, N) runs as one
batched launch (the reference's ``vmap``). A packed weight under autograd
raises: its blocks are not a parameter.

Saved products (``remat_policy="dots"``, the reference's
``jax.checkpoint_policies.checkpoint_dots``): while a :class:`SavedDots`
record is active (:func:`saving_dots`, inside a remat block's function)
the block's first run keeps every product's output, and its recompute in
the backward gets them back in order instead of computing them again: K1's
autograd Function through :meth:`SavedDots.product`, and the aten products
(``mm``, ``bmm``) of the ``torch`` backend, the unfused attention's
einsums and the MoE banks through :func:`saved_products`. The recomputed
graph still saves its operands, so the backward runs as under a full
recompute.
"""
from __future__ import annotations

import contextlib
import math
import threading
import warnings
from typing import Callable, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from repro_torch.kernels.forward_only import needs_grad
from repro_torch.kernels.ref import (acc_dtype_for, block_matmul_ref,
                                     work_dtype)

__all__ = [
    "GemmPolicy", "ExecutionPlan", "PackedWeight", "QuantizedPackedWeight",
    "AttentionPolicy",
    "pack_weight", "pack_model_weights", "plan",
    "matmul", "linear", "attention", "use_policy", "current_policy",
    "use_attention_policy", "current_attention_policy", "prefers_einsum",
    "resolved_backend", "resolved_attention_backend",
    "SavedDots", "saving_dots", "saved_products",
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


def resolved_backend(device, policy: Optional[GemmPolicy] = None) -> str:
    """Registry name the active (or given) policy resolves to on
    ``device``."""
    return (policy or current_policy()).resolved_backend(device)


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


def resolved_attention_backend(device,
                               policy: Optional[AttentionPolicy] = None, *,
                               pageable: bool = True) -> str:
    """Registry name the active (or given) attention policy resolves to on
    ``device`` (``pageable=False``: for a model whose state cannot be
    paged)."""
    return (policy or current_attention_policy()).resolved_backend(
        device, pageable=pageable)


# ---------------------------------------------------------------------------
# Saved products (remat_policy="dots")
# ---------------------------------------------------------------------------

class SavedDots:
    """The product outputs of one remat block, kept from its first run
    for its recompute (``remat_policy="dots"``).

    The first run under :func:`saving_dots` records each product's output
    in call order; a later run replays them from the first, each checked
    against the shape and dtype the recompute asks for (a mismatch raises:
    nothing is computed in its place), and frees them when it ends (the
    recompute may stop early, once every saved tensor is back)."""

    def __init__(self):
        self._outs = []
        self._next: Optional[int] = None     # None: the first run records
        self._recorded = False

    def _start(self) -> None:
        if self._recorded:
            self._next = 0

    def _stop(self) -> None:
        if self._next is None:
            self._recorded = True
        else:
            self._outs, self._next = [], None

    def product(self, shape, dtype: torch.dtype,
                compute: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``compute()``'s output (shape ``shape``, dtype ``dtype``),
        recorded on the first run; on a replay, the recorded one."""
        if self._next is None:
            out = compute()
            self._outs.append(out.detach())
            return out
        if self._next >= len(self._outs):
            raise RuntimeError(
                f"remat_policy='dots': the recompute asks for product "
                f"{self._next}, the forward saved {len(self._outs)}")
        out = self._outs[self._next]
        if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
            raise RuntimeError(
                f"remat_policy='dots': product {self._next} was saved as "
                f"{tuple(out.shape)} {out.dtype}; the recompute asks for "
                f"{tuple(shape)} {dtype}")
        self._next += 1
        return out.detach()


def active_dots() -> Optional[SavedDots]:
    """The record of the remat block running on this thread, if any."""
    return getattr(_state, "dots", None)


@contextlib.contextmanager
def saving_dots(record: Optional[SavedDots]):
    """Run the enclosed block's products through ``record`` (None: no
    record; the products compute). Entered inside the block's function,
    so it holds on whichever thread runs the recompute."""
    prev = active_dots()
    _state.dots = record
    if record is not None:
        record._start()
    try:
        yield record
    finally:
        if record is not None:
            record._stop()
        _state.dots = prev


_ATEN_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm)


class _SavedProductsMode(TorchDispatchMode):
    """``mm`` and ``bmm`` through the active :class:`SavedDots`; every
    other op as it is."""

    def __init__(self, record: SavedDots):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in _ATEN_PRODUCTS:
            return func(*args, **kwargs)
        a, b = args[0], args[1]
        return self.record.product((*a.shape[:-1], b.shape[-1]), a.dtype,
                                   lambda: func(*args, **kwargs))


def saved_products():
    """A context in which the aten products of a call (an einsum, the
    ``torch`` backend's matmul) go through the active :class:`SavedDots`;
    nothing when no record is active. The products' autograd nodes are
    made as without it, so their backward is unchanged."""
    record = active_dots()
    if record is None:
        return contextlib.nullcontext()
    return _SavedProductsMode(record)


# ---------------------------------------------------------------------------
# Built-in GEMM backends
# ---------------------------------------------------------------------------

def _torch_gemm(a, b, pln: ExecutionPlan, out_dtype):
    # integer products in an exact type (kernels/ref.py::work_dtype)
    work = work_dtype(torch.int32, a.device)
    if isinstance(b, QuantizedPackedWeight):
        aq, sa = Q.quantize_activations(a)
        c = torch.matmul(aq.to(work), b.unpack_quantized().to(work))
        return Q.dequantize_gemm(c, sa, b.scales, out_dtype)
    if isinstance(b, PackedWeight):
        b = b.unpack()
    if a.dtype.is_floating_point:
        return torch.matmul(a, b).to(out_dtype)
    return torch.matmul(a.to(work), b.to(work)).to(out_dtype)


def _register_block_major(name, block_fn, dequant_fn):
    """Register a block-major backend around ``block_fn(a_bm, b_bm, *,
    out_dtype, backward, problem)``: raw operands, batches and gradients run
    on it (:func:`_block_major`, through ``matmul``), and so do resident
    weights: a PackedWeight's blocks directly and, for a
    QuantizedPackedWeight, ``dequant_fn(a_bm, b_bm, scale_a=, scale_b=,
    out_dtype=, problem=)`` with A quantized per row first (the W8A8
    route). ``problem`` is the logical (M, N, K) inside the padded blocks
    (the kernels' cost ledger on ``meta`` records it)."""
    def gemm(a2, b, pln: ExecutionPlan, out_dtype):
        M = a2.shape[0]
        blk = P.layout_for_packed(M, b)
        problem = (M, b.n, b.k)
        if isinstance(b, QuantizedPackedWeight):
            aq, sa = Q.quantize_activations(a2)
            a_bm = L.to_block_major_a(aq, blk.bm, blk.bk)
            c_bm = dequant_fn(a_bm, b.data, scale_a=sa, scale_b=b.scales,
                              out_dtype=out_dtype, problem=problem)
        else:
            a_bm = L.to_block_major_a(a2, blk.bm, blk.bk)
            c_bm = block_fn(a_bm, b.data, out_dtype=out_dtype,
                            problem=problem)
        return L.from_block_major_c(c_bm, M, b.n)
    register_backend(name, gemm, block_fn=block_fn)


def _blockflow_block(a_bm, b_bm, *, out_dtype, backward=False,
                     problem=None):
    """The plain Algorithm 1 as a block function: a plain version counts
    no launches, so a gradient's is not marked."""
    return block_matmul_ref(a_bm, b_bm, out_dtype=out_dtype)


def _blockflow_dequant(a_bm, b_bm, *, scale_a, scale_b, out_dtype,
                       problem=None):
    return block_matmul_ref(a_bm, b_bm, out_dtype=out_dtype, scale_a=scale_a,
                            scale_b=scale_b)


register_backend("torch", _torch_gemm, batched=True, needs_layout=False)
_register_block_major("blockflow", _blockflow_block, _blockflow_dequant)
_register_block_major("matrixflow", MF.matrixflow_gemm_block_major,
                      MF.matrixflow_gemm_dequant)


def _block_major(a: torch.Tensor, b: torch.Tensor, pol: GemmPolicy,
                 out_dtype: torch.dtype, backward: bool = False
                 ) -> torch.Tensor:
    """C = A @ B of raw operands on a block-major backend: a (M, K) and b
    (K, N), or a batch of G problems (G, M, K) and (G, K, N) in one
    launch. Planned for one (M, N, K) problem, laid out block-major
    (zero-padded to the blocks), un-blocked."""
    M, K = a.shape[-2:]
    N = b.shape[-1]
    blk = plan(M, N, K, a.dtype, pol, a.device).layout
    c_bm = P.get_backend_spec(pol.resolved_backend(a.device)).block_fn(
        L.to_block_major_a(a, blk.bm, blk.bk),
        L.to_block_major_b(b, blk.bk, blk.bn),
        out_dtype=out_dtype, backward=backward, problem=(M, N, K))
    return L.from_block_major_c(c_bm, M, N)


class _BlockMajorMatmul(torch.autograd.Function):
    """:func:`_block_major` with its gradient on the same backend: dA =
    dC·Bᵀ and dB = Aᵀ·dC, each its own block-major problem (the padding of
    one layout is sliced away before the next lays out its operands, so it
    contributes zeros). The cotangent is cast to the operands' dtype, the
    one dtype the kernel multiplies (bf16 scores' fp32 cotangent rounds to
    bf16, as a flash attention backward rounds dS)."""

    @staticmethod
    def forward(ctx, a, b, pol, out_dtype):
        ctx.save_for_backward(a, b)
        ctx.pol = pol
        dots = active_dots()
        if dots is None:
            return _block_major(a, b, pol, out_dtype)
        return dots.product((*a.shape[:-1], b.shape[-1]), out_dtype,
                            lambda: _block_major(a, b, pol, out_dtype))

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        g = dc.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _block_major(g, b.transpose(-1, -2), ctx.pol, a.dtype,
                              backward=True)
        if ctx.needs_input_grad[1]:
            db = _block_major(a.transpose(-1, -2), g, ctx.pol, b.dtype,
                              backward=True)
        return da, db, None, None


def _raw_block_major(a: torch.Tensor, b: torch.Tensor, pol: GemmPolicy,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`_block_major`, through the autograd Function when a gradient
    is needed."""
    if needs_grad(a, b):
        if a.dtype != b.dtype:
            raise ValueError(f"a block-major GEMM under autograd takes "
                             f"operands of one dtype, got {a.dtype} and "
                             f"{b.dtype}")
        return _BlockMajorMatmul.apply(a, b, pol, out_dtype)
    return _block_major(a, b, pol, out_dtype)


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

    a: (..., M, K); b: (K, N), (..., K, N) with a's leading dims (a
    batched rhs), a PackedWeight or a QuantizedPackedWeight. The output
    dtype defaults to the promoted input dtype. Differentiable on every
    backend for raw operands (a block-major backend's gradient is its own
    GEMM); a packed weight under autograd raises on a block-major backend.
    """
    pol = policy if policy is not None else current_policy()
    quantized = isinstance(b, QuantizedPackedWeight)
    packed = quantized or isinstance(b, PackedWeight)
    out_dtype = out_dtype or _out_dtype(a, b)
    spec = P.get_backend_spec(pol.resolved_backend(a.device))
    K = a.shape[-1]
    if spec.batched and not packed:
        M = a.numel() // K if a.dim() > 1 else 1
        with saved_products():
            return spec.fn(a, b, plan(M, b.shape[-1], K, a.dtype, pol,
                                      a.device), out_dtype)
    if packed and needs_grad(a):
        raise ValueError(
            f"a {type(b).__name__} under autograd on GEMM backend "
            f"{spec.name!r}: packed blocks are not a parameter; train on the "
            f"raw weights (the W8A8 route has no backward)")
    if not packed and spec.block_fn is not None:
        if b.dim() == 2:             # (..., M, K) @ (K, N)
            c = _raw_block_major(a.reshape(-1, K), b, pol, out_dtype)
            return c.reshape(*a.shape[:-1], b.shape[1]).to(out_dtype)
        if a.dim() < 3 or a.shape[:-2] != b.shape[:-2]:
            raise ValueError(f"a batched rhs {tuple(b.shape)} needs a's "
                             f"leading dims, a is {tuple(a.shape)}")
        lead, (M, N) = a.shape[:-2], (a.shape[-2], b.shape[-1])
        c = _raw_block_major(a.reshape(-1, M, K), b.reshape(-1, K, N), pol,
                             out_dtype)
        return c.reshape(*lead, M, N).to(out_dtype)
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


def prefers_einsum(device, policy: Optional[GemmPolicy] = None) -> bool:
    """True when the GEMM backend the policy resolves to on ``device``
    consumes batched contractions natively (so model code takes einsum
    instead of the batched block-major GEMM)."""
    pol = policy if policy is not None else current_policy()
    return P.get_backend_spec(pol.resolved_backend(device)).batched


def _unfused_attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                       soft_cap, block_tables=None, kv_scales=None,
                       return_lse=False):
    """The reference's einsum + host-softmax baseline (the paper's §4.4
    split: GEMMs on the accelerator, softmax on the host), differentiable.
    GQA by repeating each kv head over its group; the score and value
    contractions follow the ambient GEMM policy: einsum (fp32 scores) on a
    batched backend, else the batched block-major GEMM over the (B, Hkv,
    rep) problems, scores in fp32. Probabilities are rounded to v's dtype
    before P·V, whose result is v's dtype. Fully masked rows are zeros.
    ``return_lse`` also returns each row's log-sum-exp of its visible
    scores (B, Sq, H) fp32, -inf where it sees none."""
    _reject_paged("unfused", block_tables, kv_scales)
    B, Sq, H, Dk = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, Dk)
    einsum = prefers_einsum(q.device)
    if einsum:
        with saved_products():
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float())
    else:  # fold (B, Hkv, rep) into one batch of problems
        qm = qg.permute(0, 2, 3, 1, 4).reshape(B * H, Sq, Dk)
        km = (k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
              .reshape(B * H, T, Dk))
        logits = matmul(qm, km.transpose(1, 2), out_dtype=torch.float32)
        logits = logits.reshape(B, Hkv, rep, Sq, T)
    logits = logits.float() * scale
    if soft_cap:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    kv_pos = torch.arange(T, device=q.device)[None, None, :]   # (1, 1, T)
    valid = kv_pos < kv_valid_len.to(q.device)[:, None, None]  # (B, 1, T)
    if causal:
        valid = valid & (kv_pos <= q_positions[:, :, None])     # (B, Sq, T)
    valid = valid.expand(B, Sq, T)[:, None, None]         # (B, 1, 1, Sq, T)
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    lse = None
    if return_lse:                    # (B, Hkv, rep, Sq) -> (B, Sq, H)
        lse = torch.where(valid.any(dim=-1), torch.logsumexp(logits, dim=-1),
                          torch.full_like(logits[..., 0], -math.inf))
        lse = lse.permute(0, 3, 1, 2).reshape(B, Sq, H)
    probs = torch.softmax(logits, dim=-1)                 # host-side op
    probs = torch.where(valid, probs, torch.zeros_like(probs))
    if einsum:
        with saved_products():
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype), v)
    else:
        pm = probs.reshape(B * H, Sq, T).to(v.dtype)
        vm = (v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
              .reshape(B * H, T, Dv))
        out = matmul(pm, vm).reshape(B, Hkv, rep, Sq, Dv).permute(0, 3, 1, 2,
                                                                  4)
    out = out.reshape(B, Sq, H, Dv)
    return (out, lse) if return_lse else out


def _fused_attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                     soft_cap, block_tables=None, kv_scales=None,
                     return_lse=False):
    _reject_paged("fused", block_tables, kv_scales)
    return FA.flash_attention(q, k, v, q_positions, kv_valid_len,
                              causal=causal, scale=scale, soft_cap=soft_cap,
                              return_lse=return_lse)


def _paged_attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                     soft_cap, block_tables=None, kv_scales=None,
                     return_lse=False):
    if block_tables is None:       # dense operands: the flash kernel
        if kv_scales is not None:
            raise ValueError("kv_scales belong to int8 page pools; dense "
                             "operands have no pages (pass block_tables)")
        return FA.flash_attention(q, k, v, q_positions, kv_valid_len,
                                  causal=causal, scale=scale,
                                  soft_cap=soft_cap, return_lse=return_lse)
    if return_lse:
        raise ValueError("page pools return no log-sum-exp: they are never "
                         "cut over the sequence")
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
              policy: Optional[AttentionPolicy] = None,
              return_lse: bool = False):
    """Scaled-dot-product attention through the active AttentionPolicy.

    q (B, Sq, H, Dk); dense k/v (B, T, Hkv, D) or, with ``block_tables``
    (B, n_blocks), page pools (P, page_size, Hkv, D). Key j of row b is
    visible to query i iff ``j < kv_valid_len[b]`` and, when causal,
    ``j <= q_positions[b, i]``; rows with no visible key are zeros. int8
    pools carry ``kv_scales=(k_scales, v_scales)``, fp32 (P, Hkv) each;
    only the ``paged`` backend takes them. ``return_lse`` (dense K/V
    only) returns (out, lse): lse (B, Sq, H) fp32, each row's log-sum-exp
    of its visible scores, -inf where it sees none.
    """
    pol = policy if policy is not None else current_attention_policy()
    spec = P.get_attention_backend_spec(pol.resolved_backend(q.device))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    extra = dict(return_lse=True) if return_lse else {}
    return spec.fn(q, k, v, q_positions=q_positions,
                   kv_valid_len=kv_valid_len, causal=causal, scale=scale,
                   soft_cap=soft_cap, block_tables=block_tables,
                   kv_scales=kv_scales, **extra)


# ---------------------------------------------------------------------------
# Deprecation shims (one release): the old stringly-typed surface
# ---------------------------------------------------------------------------

def current_backend(device) -> str:
    """Deprecated: use current_policy() / resolved_backend()."""
    return resolved_backend(device)


@contextlib.contextmanager
def gemm_backend(name: str):
    """Deprecated context manager: pin by backend name.

    Use ``use_policy(GemmPolicy(backend=name))`` instead.
    """
    warnings.warn("gemm_backend(name) is deprecated; use "
                  "use_policy(GemmPolicy(backend=name))", DeprecationWarning,
                  stacklevel=3)
    with use_policy(GemmPolicy(backend=name)) as pol:
        yield pol
