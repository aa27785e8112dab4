"""Offset-aware flash attention over dense K/V: wrapper of the CUDA kernel
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_kernel``.

It carries every attention without a paged cache: the cache-less forward
(scoring, the BERT/ViT encoders) and serving from contiguous
``(slots, max_len)`` KV caches. Operands stay in the model layout
``(B, S, heads, D)`` and the kernel reads them through their strides, so a
view (a cache sliced to its valid columns) needs no copy. For tensors on
the CPU :func:`flash_attention` runs :func:`flash_attention_plain`, the
same online-softmax recurrence in PyTorch over the kernel's key blocks;
for CUDA tensors it launches the kernel or raises.

On the card the kernel takes one of three routes (:func:`route_for`),
each counted in ``flash_attention.launches_by_route``, their sum in
``flash_attention.launches``:

  ``rows``        bf16, rows = Sq x rep > 16 (encoders, prefill buckets,
                  chunks): mma.sync on the tensor cores, 64 rows a CTA
  ``split``       bf16, rows <= 16 (decode): mma.sync, one m16 row tile
                  whose keys are split over 4 warps and up to
                  :data:`MAX_SPLITS` CTAs of a cluster (:func:`split_count`)
  ``cuda_cores``  fp32 (TF32 stays off): FMA on the CUDA cores

:func:`route_for` and :func:`split_count` also pick the routes of the
paged kernel's bf16 instances (``kernels/paged_attention.py``), which run
on the same warp tile (``csrc/attn_mma.cuh``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# The kernel's tiling (csrc/flash_attention.cu): keys per block, rows
# (query positions x the heads sharing a kv head) per CTA, head dims built.
BLOCK_K = 32
MAX_ROWS = 16
HEAD_DIMS = (64, 80)

ROUTES = ("rows", "split", "cuda_cores")
# The tensor-core routes (csrc/attn_mma.cuh): rows of the split route's one
# m16 tile, CTAs of one cluster that may share it.
SPLIT_ROWS = 16
MAX_SPLITS = 8
# Streaming multiprocessors of an H100 SXM, and the CTAs a split launch
# aims at (as K1's mma route, kernels/matrixflow_gemm.py), each with at
# least MIN_SPLIT_KEYS keys of the cache to read: timed on an H100
# (scripts/torch_attn_sweep.py), a cluster's merge costs more than a
# walk of 256 keys saves (smollm-135m's decode ran fastest unsplit), and
# 8 CTAs of 256 keys each were the fastest at 2,048 keys.
SMS = 132
SPLIT_TARGET_CTAS = 192
MIN_SPLIT_KEYS = 256


def route_for(dtype: torch.dtype, Sq: int, rep: int) -> str:
    """The route the attention kernels (K3, and K4 over fp pools) take on
    the card for ``Sq`` query positions of ``rep`` heads per kv head:
    ``split`` (bf16, one m16 tile holds them all), ``rows`` (bf16) or
    ``cuda_cores`` (fp32)."""
    if dtype != torch.bfloat16:
        return "cuda_cores"
    return "split" if Sq * rep <= SPLIT_ROWS else "rows"


def split_count(B: int, Hkv: int, n_keys: int) -> int:
    """CTAs of one cluster that share the keys of each (batch row, kv head)
    on the split route, from shapes alone (never kv_valid_len: reading it
    would synchronise the host): enough to bring the B x Hkv pairs near
    SPLIT_TARGET_CTAS, at most MAX_SPLITS, none when the pairs alone fill
    the SMs, and each with MIN_SPLIT_KEYS of the ``n_keys`` in memory."""
    pairs = B * Hkv
    if pairs >= SMS:
        return 1
    most = max(1, -(-n_keys // MIN_SPLIT_KEYS))
    return max(1, min(MAX_SPLITS, most, round(SPLIT_TARGET_CTAS / pairs)))



def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        vp, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_longlong)
        common = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                  ll, ll, ll, ll, ll, ll, ll, ll, ll, f, f, i, vp]
        lib.flash_attention.argtypes = [i, *common]        # head_dim
        lib.flash_attention_tc.argtypes = [i, i, *common]  # head_dim, splits
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_tc.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [i]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_plain(q, k, v, q_positions, kv_valid_len, *,
                          causal: bool, scale: float,
                          soft_cap: Optional[float]) -> torch.Tensor:
    """The kernel's recurrence in PyTorch (the plain version).

    Arguments as :func:`flash_attention` after its defaults are resolved
    (``kv_valid_len`` clamped to Sk). Keys in blocks of BLOCK_K; fp32 online
    softmax, p zeroed where invalid, p rounded to v's dtype before P·V,
    flush by max(l, 1e-30).
    """
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = v.shape[1], v.shape[2], v.shape[3]
    rep = H // Hkv
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, D)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=dev)
    l_sum = torch.zeros((B, H, Sq, 1), device=dev)
    acc = torch.zeros((B, H, Sq, Dv), device=dev)
    qpos = q_positions[:, None, :, None]                      # (B, 1, Sq, 1)
    kvlen = kv_valid_len[:, None, None, None]
    for c0 in range(0, Sk, BLOCK_K):
        kb = k[:, c0:c0 + BLOCK_K].repeat_interleave(rep, dim=2)
        vb = v[:, c0:c0 + BLOCK_K].repeat_interleave(rep, dim=2)
        s = torch.matmul(qf, kb.float().permute(0, 2, 3, 1)) * scale
        if soft_cap:
            s = soft_cap * torch.tanh(s / soft_cap)
        cols = c0 + torch.arange(kb.shape[1], device=dev)
        valid = cols < kvlen
        if causal:
            valid = valid & (cols <= qpos)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                        vb.float().permute(0, 2, 1, 3))
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def _resolve(q_positions, kv_valid_len, B: int, Sq: int, Sk: int, dev):
    """``q_positions`` and ``kv_valid_len`` as int32, a missing one at its
    default (bottom-right aligned positions; Sk), ``kv_valid_len`` clamped
    to Sk."""
    if q_positions is None:
        q_positions = (torch.arange(Sq, device=dev) + (Sk - Sq)).expand(B, Sq)
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), Sk, device=dev)
    return (q_positions.to(torch.int32),
            torch.clamp(kv_valid_len.to(torch.int32), max=Sk))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it in 16-byte chunks (last dim
    contiguous, start and every other stride 16-byte aligned), else a
    packed copy. Tensors of the model's own layout and views of them
    (a contiguous cache sliced to its first columns) need no copy."""
    item = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s * item % 16 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(
    q: torch.Tensor,             # (B, Sq, H, D) — model layout
    k: torch.Tensor,             # (B, Sk, Hkv, D)
    v: torch.Tensor,             # (B, Sk, Hkv, Dv)
    q_positions: Optional[torch.Tensor] = None,   # (B, Sq) int32; <0 → masked
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) int32; None → Sk
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over dense K/V; returns (B, Sq, H, Dv) in q's dtype.

    Defaults as the TPU wrapper's: ``q_positions`` is bottom-right aligned,
    ``arange(Sq) + (Sk - Sq)`` (NOT the paged kernel's ``arange``), and
    ``kv_valid_len`` is Sk and is clamped to it. Key j of row b is visible
    to query i iff ``j < kv_valid_len[b]`` and, when causal,
    ``j <= q_positions[b, i]``; a row that sees no key is zeros.
    """
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} query heads must be a multiple of Hkv={Hkv}")
    if tuple(k.shape) != (B, Sk, Hkv, D) or v.shape[0] != B:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on (B, Sk, Hkv, D)")
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if Sk == 0:
        return torch.zeros((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    if dev.type == "cpu":
        return flash_attention_plain(
            q, k, v, *_resolve(q_positions, kv_valid_len, B, Sq, Sk, dev),
            causal=causal, scale=scale, soft_cap=soft_cap)
    if dev.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or {k.dtype, v.dtype} != {q.dtype}:
        raise ValueError(f"the kernel takes fp32 or bf16 q, k and v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS or Dv != D:
        raise ValueError(
            f"head dims ({D}, {Dv}): the flash attention kernel is built for "
            f"head_dim in {HEAD_DIMS} with equal q/k and v head dims")
    if H // Hkv > MAX_ROWS:
        raise ValueError(f"GQA group H/Hkv = {H // Hkv} exceeds the kernel's "
                         f"{MAX_ROWS} rows per CTA")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    route = route_for(q.dtype, Sq, H // Hkv)
    splits = split_count(B, Hkv, Sk) if route == "split" else 0
    if route == "split" and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"split count {splits} outside 1..{MAX_SPLITS}")
    if route == "cuda_cores":
        q_positions, kv_valid_len = _resolve(q_positions, kv_valid_len, B, Sq,
                                             Sk, dev)
    # the tensor-core kernels take a missing q_positions or kv_valid_len as
    # its default, and clamp kv_valid_len themselves
    qpos, kvl = (None if t is None else
                 t.to(device=dev, dtype=torch.int32).contiguous()
                 for t in (q_positions, kv_valid_len))
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if qpos is None else qpos.data_ptr(),
            None if kvl is None else kvl.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, Hkv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
            float(soft_cap or 0.0), int(causal),
            torch.cuda.current_stream(dev).cuda_stream)
    if route == "cuda_cores":
        err = lib.flash_attention(D, *args)
    else:
        err = lib.flash_attention_tc(D, splits, *args)
    if err:
        raise RuntimeError(f"flash_attention launch failed ({route} route): "
                           f"{lib.fa_error_string(err).decode()}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
