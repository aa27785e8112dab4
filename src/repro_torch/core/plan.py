"""ExecutionPlan API: typed GEMM/attention policies, backend registries,
resident block-major weights — the port of ``repro/core/plan.py``.

* :class:`GemmPolicy` — frozen, hashable: backend and DC/DM access mode.
* the GEMM and attention **backend registries**;
* :func:`plan` — a policy resolved against one ``(M, N, K, dtype,
  device)`` problem into an :class:`ExecutionPlan`, memoized. ``mode=
  "auto"`` asks the analytic system model (``core/sysmodel.py``) for DC vs
  DM per shape; ``backend="auto"`` resolves by the operand's device — the
  CUDA kernels on a CUDA device, the plain versions on the CPU;
* :class:`PackedWeight` — a weight held resident in block-major form (the
  paper's Fig. 5 reuse): packed once at model build, consumed by every
  GEMM without a re-layout; with ``quantize="int8"`` (or a policy's
  ``weight_dtype``) a :class:`~repro_torch.core.quant.QuantizedPackedWeight`
  instead — int8 blocks plus per-channel scales, the W8A8 route.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core import layout as L
from repro_torch.core import quant as Q
from repro_torch.core.quant import QuantizedPackedWeight

__all__ = [
    "GemmPolicy", "ExecutionPlan", "PackedWeight", "BackendSpec",
    "AttentionPolicy", "AttentionBackendSpec", "FUSED", "UNFUSED", "PAGED",
    "plan", "plan_cache_clear", "register_backend", "get_backend_spec",
    "resolve_backend", "register_attention_backend",
    "get_attention_backend_spec", "resolve_attention_backend",
    "pack_weight", "pack_model_weights", "layout_for_packed",
    "QuantizedPackedWeight",
]

Device = Union[str, torch.device]

# Quantized weight dtypes the GEMM route understands (core/quant.py).
_WEIGHT_DTYPES = (None, "int8")
# KV-pool dtypes the paged attention route understands.
_KV_DTYPES = (None, "int8")


def _device_type(device: Device) -> str:
    return torch.device(device).type


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """How GEMMs execute. Frozen → hashable → a plan-cache key.

    backend      registry name, or "auto" (``matrixflow`` — the CUDA kernel
                 — on a CUDA device, ``blockflow`` — its plain version — on
                 the CPU).
    mode         paper access mode: "dc" | "dm" | "auto" (per-shape choice
                 by the sysmodel). Blocks come from core/layout.py's
                 Hopper chooser.
    weight_dtype None → weights execute in their stored dtype; "int8" →
                 the W8A8 route (core/quant.py): per-channel int8 weights,
                 dynamic per-row int8 activations, int32 accumulation, the
                 dequant fused into the C-block flush.
    """

    backend: str = "auto"
    mode: str = "auto"
    weight_dtype: Optional[str] = None

    def __post_init__(self):
        if self.weight_dtype not in _WEIGHT_DTYPES:
            raise ValueError(
                f"unsupported weight_dtype {self.weight_dtype!r}; "
                f"expected one of {_WEIGHT_DTYPES}")

    def resolved_backend(self, device: Device) -> str:
        return resolve_backend(self.backend, device)


@dataclasses.dataclass(frozen=True)
class AttentionPolicy:
    """How attention executes.

    backend    registry name, or "auto" (``paged`` on a CUDA device,
               ``unfused`` on the CPU; for a model whose recurrent state
               cannot be paged, ``fused`` on a CUDA device). ``fused`` is
               the offset-aware flash kernel over dense K/V (the cache-less
               forward and contiguous KV caches); ``paged`` reads page
               pools through block tables and falls back to the flash
               kernel on dense operands.
    page_size  tokens per KV page for the ``paged`` backend — the paged
               kernel's key-block size. Consumed by
               ``models/transformer.py::init_paged_caches`` and the serving
               engine's PagePool.
    kv_dtype   None → the KV pool stores the model's cache dtype; "int8" →
               the ``paged`` backend stores int8 pages with one fp32 scale
               per (page, kv head), dequantized inside the paged kernel's
               page fetch. The dense backends reject it (core/api.py).
    """

    backend: str = "auto"
    page_size: int = 16
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"unsupported kv_dtype {self.kv_dtype!r}; "
                f"expected one of {_KV_DTYPES}")

    def resolved_backend(self, device: Device, *,
                         pageable: bool = True) -> str:
        return resolve_attention_backend(self.backend, device,
                                         pageable=pageable)


# Common pinned policies (tests, CLI flags).
FUSED = AttentionPolicy(backend="fused")
UNFUSED = AttentionPolicy(backend="unfused")
PAGED = AttentionPolicy(backend="paged")


def resolve_backend(name: str, device: Device) -> str:
    if name != "auto":
        return name
    return "matrixflow" if _device_type(device) == "cuda" else "blockflow"


def resolve_attention_backend(name: str, device: Device, *,
                              pageable: bool = True) -> str:
    """``auto`` → ``paged`` on a CUDA device, ``unfused`` on the CPU; a
    model whose state cannot be paged (``pageable=False``: the SSD
    families) gets the contiguous ``fused`` kernel on a CUDA device."""
    if name != "auto":
        return name
    if _device_type(device) != "cuda":
        return "unfused"
    return "paged" if pageable else "fused"


# ---------------------------------------------------------------------------
# Backend registries
# ---------------------------------------------------------------------------

# A GEMM backend: fn(a, b, plan, out_dtype) -> c. batched=False backends get
# a 2-D a (M, K) and a 2-D b (K, N) or a PackedWeight; batched=True ones get
# the operands as the caller passed them.
BackendFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    fn: BackendFn
    batched: bool = False        # consumes batched contractions natively
    needs_layout: bool = True    # plan() must resolve a BlockLayout


# An attention backend: fn(q, k, v, *, q_positions, kv_valid_len, causal,
# scale, soft_cap, block_tables) -> out, model-layout operands.
AttentionBackendFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttentionBackendSpec:
    name: str
    fn: AttentionBackendFn


_REGISTRY: Dict[str, BackendSpec] = {}
_ATTN_REGISTRY: Dict[str, AttentionBackendSpec] = {}
_registry_lock = threading.Lock()


def register_backend(name: str, fn: BackendFn, *, batched: bool = False,
                     needs_layout: bool = True) -> BackendSpec:
    """Register a GEMM backend under ``name`` (the GemmPolicy.backend key)."""
    spec = BackendSpec(name, fn, batched, needs_layout)
    with _registry_lock:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = spec
    plan_cache_clear()
    return spec


def register_attention_backend(name: str,
                               fn: AttentionBackendFn) -> AttentionBackendSpec:
    spec = AttentionBackendSpec(name, fn)
    with _registry_lock:
        if name in _ATTN_REGISTRY:
            raise ValueError(f"attention backend {name!r} already registered")
        _ATTN_REGISTRY[name] = spec
    return spec


def _lookup(registry: dict, name: str, what: str):
    spec = registry.get(name)
    if spec is None:
        # The built-ins are registered by repro_torch.core.api at import.
        import repro_torch.core.api  # noqa: F401
        spec = registry.get(name)
    if spec is None:
        raise ValueError(f"unknown {what} backend {name!r}; registered: "
                         f"{sorted(registry)}")
    return spec


def get_backend_spec(name: str) -> BackendSpec:
    return _lookup(_REGISTRY, name, "GEMM")


def get_attention_backend_spec(name: str) -> AttentionBackendSpec:
    return _lookup(_ATTN_REGISTRY, name, "attention")


# ---------------------------------------------------------------------------
# Plan resolution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A GemmPolicy resolved against one (M, N, K, dtype, device) problem."""

    M: int
    N: int
    K: int
    dtype: torch.dtype
    backend: str                     # resolved registry name
    mode: Optional[str]              # "dc"/"dm"; None for layout-free backends
    layout: Optional[L.BlockLayout]
    policy: GemmPolicy


_SYSMODEL_DTYPE = {torch.int8: "int8", torch.int16: "int16",
                   torch.int32: "int32", torch.float16: "fp16",
                   torch.bfloat16: "bf16", torch.float32: "fp32"}


def _auto_mode(M: int, N: int, K: int, dtype: torch.dtype) -> str:
    """DC vs DM per shape, from the analytic system model (paper §4.3)."""
    from repro_torch.core import sysmodel as SM
    g = SM.Gemm(M=M, K=K, N=N)
    sm_dtype = _SYSMODEL_DTYPE.get(dtype, "fp32")
    t_dc = SM.matrixflow_gemm_time(g, sm_dtype, mode="dc")["total"]
    t_dm = SM.matrixflow_gemm_time(g, sm_dtype, mode="dm")["total"]
    return "dc" if t_dc <= t_dm else "dm"


@functools.lru_cache(maxsize=4096)
def _plan_cached(M: int, N: int, K: int, dtype: torch.dtype,
                 policy: GemmPolicy, device_type: str) -> ExecutionPlan:
    backend = policy.resolved_backend(device_type)
    spec = get_backend_spec(backend)
    if not spec.needs_layout:
        return ExecutionPlan(M, N, K, dtype, backend, None, None, policy)
    mode = policy.mode
    if mode == "auto":
        mode = _auto_mode(M, N, K, dtype)
    layout = L.choose_layout(M, N, K, dtype, mode=mode)
    return ExecutionPlan(M, N, K, dtype, backend, mode, layout, policy)


def plan(M: int, N: int, K: int, dtype: torch.dtype,
         policy: Optional[GemmPolicy] = None,
         device: Device = "cpu") -> ExecutionPlan:
    """Resolve ``policy`` for one GEMM problem; memoized on all arguments."""
    return _plan_cached(int(M), int(N), int(K), dtype,
                        policy if policy is not None else GemmPolicy(),
                        _device_type(device))


def plan_cache_clear() -> None:
    _plan_cached.cache_clear()


# ---------------------------------------------------------------------------
# Resident block-major weights (paper Fig. 5: lay out once, reuse per layer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedWeight:
    """A GEMM rhs stored block-major: ``data`` is (N/bn, K/bk, bk, bn)."""

    data: torch.Tensor
    k: int                   # logical (unpadded) K
    n: int                   # logical (unpadded) N
    bk: int
    bn: int
    mode: str = "dm"

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def unpack(self) -> torch.Tensor:
        """Back to row-major (K, N) — for layout-free backends."""
        return L.from_block_major_b(self.data, self.k, self.n)


def pack_weight(w: torch.Tensor, policy: Optional[GemmPolicy] = None, *,
                m_hint: int = 512, quantize: Optional[str] = None
                ) -> Union[PackedWeight, QuantizedPackedWeight]:
    """Lay a (K, N) weight out block-major exactly once. bk and bn do not
    depend on M (core/layout.py), so ``m_hint`` only feeds the sysmodel's
    DC/DM choice under ``mode="auto"``.

    ``quantize="int8"`` (default: the policy's ``weight_dtype``) quantizes
    per output channel at pack time and returns a QuantizedPackedWeight;
    the block geometry is then chosen for the int8 itemsize (the paper's
    per-dtype MAC sizing, Table 2)."""
    policy = policy if policy is not None else GemmPolicy()
    quantize = quantize if quantize is not None else policy.weight_dtype
    if quantize not in _WEIGHT_DTYPES:
        raise ValueError(f"unsupported quantize={quantize!r}; "
                         f"expected one of {_WEIGHT_DTYPES}")
    K, N = w.shape
    pack_dtype = torch.int8 if quantize == "int8" else w.dtype
    mode = policy.mode
    if mode == "auto":
        mode = _auto_mode(m_hint, N, K, pack_dtype)
    blk = L.choose_layout(m_hint, N, K, pack_dtype, mode=mode)
    if quantize == "int8":
        q, scales = Q.quantize_weight(w)
        return QuantizedPackedWeight(
            L.to_block_major_b(q, blk.bk, blk.bn), scales, K, N, blk.bk,
            blk.bn, blk.mode, str(w.dtype).removeprefix("torch."))
    return PackedWeight(L.to_block_major_b(w, blk.bk, blk.bn), K, N,
                        blk.bk, blk.bn, blk.mode)


def layout_for_packed(M: int, pw: Union[PackedWeight, QuantizedPackedWeight]
                      ) -> L.BlockLayout:
    """The BlockLayout for an (M, K) activation against a packed weight
    (fp or int8): bk/bn are frozen by the pack, bm follows M."""
    return L.BlockLayout(L.bm_for(M), pw.bn, pw.bk, pw.mode)


# Keys that name GEMM right-hand sides in the model parameter trees
# (models/layers.py, models/transformer.py).
_PACK_KEYS = frozenset({"wq", "wk", "wv", "wo", "wi", "w_z", "w_x", "w_B",
                        "w_C", "w_dt", "w_out", "head"})


def pack_model_weights(params, policy: Optional[GemmPolicy] = None, *,
                       m_hint: int = 512, quantize: Optional[str] = None):
    """Pack every GEMM weight of a model param tree into a PackedWeight
    (the paper's offline weight arrangement, Fig. 5); norms and embeddings
    pass through. ``quantize="int8"`` (default: the policy's
    ``weight_dtype``) makes every one a QuantizedPackedWeight, the
    quantize-at-pack deployment shape."""
    if quantize is None and policy is not None:
        quantize = policy.weight_dtype
    def rec(node, key=None):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        if key in _PACK_KEYS and isinstance(node, torch.Tensor) \
                and node.dim() == 2:
            return pack_weight(node, policy, m_hint=m_hint, quantize=quantize)
        return node

    return rec(params)
