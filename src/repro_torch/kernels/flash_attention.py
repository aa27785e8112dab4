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
``flash_attention.launches`` (those with the log-sum-exp also in
``flash_attention.lse_launches``):

  ``rows``        bf16, Sq > 1 and rows = Sq x rep > 16 (encoders, prefill
                  buckets, chunks): mma.sync on the tensor cores, 64 rows
                  a CTA
  ``split``       bf16, decode (Sq = 1) or rows <= 16: mma.sync, one m16
                  row tile a CTA whose keys are split over 4 warps and up
                  to :data:`MAX_SPLITS` CTAs of a cluster
                  (:func:`split_count`)
  ``cuda_cores``  fp32 (TF32 stays off): FMA on the CUDA cores
  ``cuda_cores_bf16kv``  fp32 q over bf16 K/V (an fp32 model serving from
                  a bf16 cache): the CUDA-core kernel with K/V widened to
                  fp32 as it stages them, p rounded to bf16 before P·V

bf16 q over fp32 K/V (a bf16 model, an fp32 cache) has no instance of its
own: q is cast up to fp32 (exact), the fp32 kernel runs on
``cuda_cores``, and the output is cast back to bf16. That is the
reference's promotion: its kernel computes in fp32 and writes q's dtype.
Another CUDA dtype pair raises.

Rows are flat on every route (query position x the heads sharing a kv
head, in that order), so any GQA group fits: granite-20b's 48 query heads
on one kv head make a decode row of three m16 tiles.

``return_lse=True`` also returns each row's log-sum-exp ``m + log(l)``
over its visible keys, (B, Sq, H) fp32 (-inf where a row sees no key),
written by the kernel on every route: what merges the partial attentions
of a KV cache cut over the sequence (``distributed/tp.py::attention``).

:func:`route_for` and :func:`split_count` also pick the routes of the
paged kernel's bf16 instances (``kernels/paged_attention.py``), which run
on the same warp tile (``csrc/attn_mma.cuh``).

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) the wrapper takes
the route the card would take, records that launch and its least work
(``roofline.launch_cost``, every key in memory: positions are data) in the
active cost ledger, and returns an empty ``meta`` result. Nothing launches
there, so the launch counters do not move: they count real launches only.

:func:`flash_attention_contract` (registered as ``"flash_attention"``)
states each route's launch grid and the rows and keys every CTA reads and
writes, for the static checker (``analysis/kernel_contracts.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.analysis.kernel_contracts import (KernelContract,
                                                   OperandSpec, Precondition,
                                                   register_contract, require)
from repro_torch.kernels import _build
from repro_torch.kernels.forward_only import refuse_grad
from repro_torch.roofline import analysis as RA

NEG_INF = -1e30
# The kernel's tiling (csrc/flash_attention.cu): keys per block, the head
# dims built with v's head dim equal, and every (q/k head dim, v head dim)
# pair built: those, and MLA's (192, 128) (deepseek-v2: 128 nope + 64 rope
# dims, v 128).
BLOCK_K = 32
HEAD_DIMS = (64, 80, 128)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)

MIXED_ROUTE = "cuda_cores_bf16kv"
ROUTES = ("rows", "split", "cuda_cores", MIXED_ROUTE)
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the fp32-q kernel's
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


def route_for(dtype: torch.dtype, Sq: int, rep: int,
              kv_dtype: Optional[torch.dtype] = None) -> str:
    """The route the attention kernels (K3, K4 and K5) take on the card
    for ``Sq`` query positions of ``rep`` heads per kv head, q of
    ``dtype`` over K/V of ``kv_dtype`` (default: q's; K5's int8 pools pass
    none): ``split`` (bf16 decode, or one m16 tile holds every row),
    ``rows`` (bf16), ``cuda_cores`` (fp32 q, or bf16 q cast up over fp32
    K/V) or :data:`MIXED_ROUTE` (fp32 q over bf16 K/V)."""
    kv_dtype = kv_dtype or dtype
    if dtype == torch.float32 and kv_dtype == torch.bfloat16:
        return MIXED_ROUTE
    if dtype != torch.bfloat16 or kv_dtype != torch.bfloat16:
        return "cuda_cores"
    return "split" if Sq == 1 or Sq * rep <= SPLIT_ROWS else "rows"


def check_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 what: str) -> None:
    """Raise unless the card takes q over K/V of these dtypes: fp32 or bf16
    q over fp32 or bf16 K/V of one dtype."""
    fp = (torch.float32, torch.bfloat16)
    if q.dtype not in fp or k.dtype not in fp or v.dtype != k.dtype:
        raise ValueError(f"the {what} kernels take fp32 or bf16 q over fp32 "
                         f"or bf16 K/V of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")


def split_count(B: int, Hkv: int, n_keys: int) -> int:
    """CTAs of one cluster that share the keys of each (batch row, kv head)
    on the split route, from shapes alone (never kv_valid_len: reading it
    would synchronise the host): enough to bring the B x Hkv pairs near
    SPLIT_TARGET_CTAS, at most MAX_SPLITS, none when the pairs alone fill
    the SMs, and each with MIN_SPLIT_KEYS of the ``n_keys`` in memory (so
    none under 512 keys, where both routes give a row the same bits)."""
    pairs = B * Hkv
    if pairs >= SMS:
        return 1
    most = max(1, n_keys // MIN_SPLIT_KEYS)
    return max(1, min(MAX_SPLITS, most, round(SPLIT_TARGET_CTAS / pairs)))



def attention_preconditions(H: int, Hkv: int) -> Tuple[Precondition, ...]:
    """The GQA guard of every attention kernel (K3, K4, K5)."""
    return (Precondition.check(
        "GQA head divisibility", Hkv >= 1 and H % Hkv == 0,
        f"H={H} query heads must be a multiple of Hkv={Hkv}"),)


def launch_preconditions(D: int, Dv: int, route: str,
                         splits: int) -> Tuple[Precondition, ...]:
    """The head dims K3 is built for and the split count it takes: the
    guards the wrapper raises on the card and the contract states."""
    return (
        Precondition.check(
            "instantiated head dims", (D, Dv) in HEAD_DIM_PAIRS,
            f"head dims ({D}, {Dv}): the flash attention kernel is built for "
            f"(head_dim, v head_dim) in {HEAD_DIM_PAIRS}"),
        Precondition.check(
            "split count", route != "split" or 1 <= splits <= MAX_SPLITS,
            f"split count {splits} outside 1..{MAX_SPLITS}"),
    )


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        vp, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_longlong)
        # q, k, v, q_positions, kv_valid_len, out, lse, then the shapes
        common = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                  ll, ll, ll, ll, ll, ll, ll, ll, ll, f, f, i, vp]
        # head_dim, v_head_dim (and splits)
        lib.flash_attention.argtypes = [i, i, i, *common]
        lib.flash_attention_tc.argtypes = [i, i, i, *common]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_tc.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [i]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_plain(q, k, v, q_positions, kv_valid_len, *,
                          causal: bool, scale: float,
                          soft_cap: Optional[float],
                          return_lse: bool = False):
    """The kernel's recurrence in PyTorch (the plain version).

    Arguments as :func:`flash_attention` after its defaults are resolved
    (``kv_valid_len`` clamped to Sk). Keys in blocks of BLOCK_K; fp32 online
    softmax, p zeroed where invalid, p rounded to v's dtype before P·V,
    flush by max(l, 1e-30). With ``return_lse`` also each row's m + log(l)
    (B, Sq, H) fp32, -inf where l = 0.
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
    out = out.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if not return_lse:
        return out
    lse = torch.where(l_sum > 0, m + torch.log(l_sum),
                      torch.full_like(l_sum, -math.inf))
    return out, lse[..., 0].permute(0, 2, 1).contiguous()


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
    v: torch.Tensor,             # (B, Sk, Hkv, Dv); Dv = D but for MLA
    q_positions: Optional[torch.Tensor] = None,   # (B, Sq) int32; <0 → masked
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) int32; None → Sk
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention over dense K/V; returns (B, Sq, H, Dv) in q's dtype,
    and with ``return_lse`` also (B, Sq, H) fp32: each row's log-sum-exp
    of its visible scores, -inf where it sees none.
    fp32 or bf16 q over fp32 or bf16 K/V (:func:`route_for`); forward-only
    (it raises under autograd: ``kernels/forward_only.py``).

    Defaults as the TPU wrapper's: ``q_positions`` is bottom-right aligned,
    ``arange(Sq) + (Sk - Sq)`` (NOT the paged kernel's ``arange``), and
    ``kv_valid_len`` is Sk and is clamped to it. Key j of row b is visible
    to query i iff ``j < kv_valid_len[b]`` and, when causal,
    ``j <= q_positions[b, i]``; a row that sees no key is zeros.
    """
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    require(*attention_preconditions(H, Hkv))
    if tuple(k.shape) != (B, Sk, Hkv, D) or v.shape[0] != B:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on (B, Sk, Hkv, D)")
    refuse_grad("flash_attention (K3)", q, k, v)
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if Sk == 0:
        out = torch.zeros((B, Sq, H, Dv), dtype=q.dtype, device=dev)
        return (out, torch.full((B, Sq, H), -math.inf, device=dev)) \
            if return_lse else out
    if dev.type == "cpu":
        return flash_attention_plain(
            q, k, v, *_resolve(q_positions, kv_valid_len, B, Sq, Sk, dev),
            causal=causal, scale=scale, soft_cap=soft_cap,
            return_lse=return_lse)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"no flash attention kernel for device {dev}")
    check_dtypes(q, k, v, "flash attention")
    route = route_for(q.dtype, Sq, H // Hkv, k.dtype)
    splits = split_count(B, Hkv, Sk) if route == "split" else 0
    require(*launch_preconditions(D, Dv, route, splits))
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    out_dtype = q.dtype
    if route == "cuda_cores":
        q = q.float()                # bf16 q over fp32 K/V: exact
    if dev.type == "meta":
        RA.record_launch("flash_attention", route, B=B, Sq=Sq, Sk=Sk, H=H,
                         Hkv=Hkv, D=D, Dv=Dv, dtype=out_dtype,
                         kv_dtype=k.dtype, lse=return_lse)
        out = torch.empty((B, Sq, H, Dv), dtype=out_dtype, device=dev)
        return (out, torch.empty((B, Sq, H), device=dev)) if return_lse \
            else out
    tc = route in ("rows", "split")
    if not tc:
        q_positions, kv_valid_len = _resolve(q_positions, kv_valid_len, B, Sq,
                                             Sk, dev)
    # the tensor-core kernels take a missing q_positions or kv_valid_len as
    # its default, and clamp kv_valid_len themselves
    qpos, kvl = (None if t is None else
                 t.to(device=dev, dtype=torch.int32).contiguous()
                 for t in (q_positions, kv_valid_len))
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Sq, H), device=dev) if return_lse else None
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if qpos is None else qpos.data_ptr(),
            None if kvl is None else kvl.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, Hkv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
            float(soft_cap or 0.0), int(causal),
            torch.cuda.current_stream(dev).cuda_stream)
    if tc:
        err = lib.flash_attention_tc(D, Dv, splits, *args)
    else:
        err = lib.flash_attention(_KV_CODES[k.dtype], D, Dv, *args)
    if err:
        raise RuntimeError(f"flash_attention launch failed ({route} route): "
                           f"{lib.fa_error_string(err).decode()}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    if return_lse:
        flash_attention.lse_launches += 1
        return out.to(out_dtype), lse
    return out.to(out_dtype)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.lse_launches = 0      # of them, with the log-sum-exp


# ---------------------------------------------------------------------------
# The launch grids, stated for the static checker
# ---------------------------------------------------------------------------

# Rows a CTA holds (csrc/attn_mma.cuh: kRowsTile, kSplitRows; the CUDA-core
# kernel's kMaxRows), and the keys of one step of a CTA's key walk: the
# split route cuts the keys in 16-key tiles (attn_mma.cuh:390-393), the
# CUDA-core kernel stages BLOCK_K keys.
ROWS_TILE = 64
KEY_TILE = 16


def attention_tiles(route: str, rows: int, n_keys: int, splits: int,
                    *, paged: bool = False, page_size: int = 0):
    """(rows a CTA holds, CTAs along blockIdx.x, the key unit of a step,
    ``share(z)`` → the [lo, hi) keys rank z of a cluster walks) of one
    launch of the attention kernels on ``route``: the arithmetic of
    ``attn_mma.cuh::attend`` (:348-:393) and of the CUDA-core kernels."""
    nz = max(splits, 1)
    if route in ("rows", "split"):
        t = ROWS_TILE if route == "rows" and not paged else SPLIT_ROWS
        unit = min(KEY_TILE, page_size) if paged else KEY_TILE
        tiles16 = -(-n_keys // KEY_TILE)

        def share(z):
            if route != "split":
                return 0, n_keys
            return (tiles16 * z // nz * KEY_TILE,
                    min(tiles16 * (z + 1) // nz * KEY_TILE, n_keys))
    else:
        t, unit = SPLIT_ROWS, page_size if paged else BLOCK_K

        def share(z):
            return 0, n_keys
    return t, -(-rows // t), unit, share


def lse_segment_rows(route: str, z: int, splits: int, Dv: int,
                     tile_rows: int) -> range:
    """The rows of a CTA's tile whose log-sum-exp split rank ``z`` writes:
    on the split route with a cluster (``splits`` > 1), the rows whose
    first output element lies in the rank's share ``[16 Dv z / nz, 16 Dv
    (z + 1) / nz)`` of the (16, Dv) tile (``csrc/attn_mma.cuh``:686, the
    cluster merge); else every row of the tile, by the CTA itself
    (``attn_mma.cuh``:607 on the rows route, :653 on the split route
    without a cluster, ``flash_attention.cu``:321 on the CUDA cores)."""
    if route != "split" or splits <= 1:
        return range(tile_rows)
    lo, hi = (SPLIT_ROWS * Dv * z // splits,
              SPLIT_ROWS * Dv * (z + 1) // splits)
    return range(-(-lo // Dv), -(-hi // Dv))


def attention_contract(kernel: str, *, B, H, Hkv, Sq, D, Dv, route,
                       splits, n_keys, kv_operands, pre,
                       page_size: int = 0, lse: bool = False
                       ) -> KernelContract:
    """The card's contract of one launch of K3, K4 or K5 on ``route``.

    Grid (blockIdx.z = b, blockIdx.y = g, the row tile, the rank z of its
    cluster, the key steps), blockIdx.x = tile * splits + z
    (``attn_mma.cuh`` :348-:353; the CUDA-core kernels' x = tile,
    ``flash_attention.cu``:187-:191, ``paged_attention.cu``:126-:130):
    CTA (tile, z) of (b, g) holds flat rows tile * T .. + T - 1 (query
    position r // rep, head g * rep + r % rep) and walks the keys of its
    share in steps of ``unit`` keys. The output tile is revisited along the
    key steps and, on the split route, along the cluster's ranks, which
    add their partials (``attn_mma.cuh``:668-:688). ``kv_operands(b, g,
    col0)`` gives the K/V-side operands' blocks at a step's first key.

    With ``lse`` (K3's log-sum-exp output) each (b, g, tile) holds one
    ``lse`` segment a cluster rank, :func:`lse_segment_rows`: written
    once, after the key walk, by the rank the kernel assigns its rows
    (the whole tile by its one CTA off the split route's clusters)."""
    rep = H // Hkv if Hkv >= 1 and H % Hkv == 0 else 1
    rows = Sq * rep
    T, n_tiles, unit, share = attention_tiles(
        route, rows, n_keys, splits, paged=kernel == "paged_attention",
        page_size=page_size)
    nz = max(splits, 1)
    steps = max(-(-(hi - lo) // unit) for lo, hi in map(share, range(nz)))

    def key(b, g, t, z, s):
        lo, hi = share(z)
        col0 = lo + s * unit
        return col0 if col0 < hi else None

    def row_map(b, g, t, z, s):
        return (b, g, t, 0)

    operands = [
        OperandSpec("q_positions", "input", (B, 1), (1, Sq),
                    lambda b, g, t, z, s: (b, 0)),
        OperandSpec("kv_valid_len", "input", (B,), (1,),
                    lambda b, g, t, z, s: (b,)),
        OperandSpec("q", "input", (B, Hkv, n_tiles, 1), (1, 1, T, D),
                    row_map),
    ]
    for name, nblocks, block, fn, expected in kv_operands:
        def kv_map(b, g, t, z, s, fn=fn):
            col0 = key(b, g, t, z, s)
            return None if col0 is None else fn(b, g, col0)
        operands.append(OperandSpec(name, "input", nblocks, block, kv_map,
                                    expected_blocks=expected))
    operands.append(OperandSpec("o", "output", (B, Hkv, n_tiles, 1),
                                (1, 1, T, Dv), row_map,
                                reduction_axes=(3, 4)))
    if lse:
        seg = max(len(lse_segment_rows(route, z, splits, Dv, T))
                  for z in range(nz))

        def lse_map(b, g, t, z, s):
            return (b, g, t, z) if s == steps - 1 else None
        operands.append(OperandSpec("lse", "output", (B, Hkv, n_tiles, nz),
                                    (1, 1, seg, 1), lse_map))
    return KernelContract(
        kernel=kernel, grid=(B, Hkv, n_tiles, nz, steps),
        operands=tuple(operands),
        dimension_semantics=("parallel", "parallel", "parallel", "cluster",
                             "arbitrary"),
        preconditions=pre, cluster=nz,
        description=f"{kernel} {route} ({T} rows a CTA, splits={splits}, "
                    f"{unit}-key steps)")


@register_contract("flash_attention")
def flash_attention_contract(*, B, H, Hkv, Sq, Sk, D, Dv,
                             block_q: int = 128, block_k: int = 128,
                             device="cuda",
                             dtype: torch.dtype = torch.bfloat16,
                             kv_dtype: Optional[torch.dtype] = None,
                             lse: bool = False) -> KernelContract:
    """Contract of :func:`flash_attention` for one logical shape: q of
    ``dtype`` over K/V of ``kv_dtype`` (default q's); ``lse``: the launch
    writes each row's log-sum-exp too (``return_lse=True``).

    For a CUDA device, the launch on the route :func:`route_for` names
    (:func:`attention_contract`; ``block_q``/``block_k`` are the
    reference's and do not apply: the kernels' tiles are fixed); for the
    CPU, the reference's grid (B, H, nq, nk) over ``block_q`` x
    ``block_k`` blocks, o revisited along the key axis."""
    pre = attention_preconditions(H, Hkv)
    rep = H // Hkv if Hkv >= 1 and H % Hkv == 0 else 1
    if torch.device(device).type == "cpu":
        bq, bk = min(block_q, Sq), min(block_k, Sk)
        nq, nk = -(-Sq // bq), -(-Sk // bk)
        operands = (
            OperandSpec("q_positions", "input", (B, nq, 1), (1, bq, 1),
                        lambda b, h, i, j: (b, i, 0)),
            OperandSpec("kv_valid_len", "input", (B, 1), (1, 1),
                        lambda b, h, i, j: (b, 0)),
            OperandSpec("q", "input", (B, H, nq, 1), (1, 1, bq, D),
                        lambda b, h, i, j: (b, h, i, 0)),
            OperandSpec("k", "input", (B, Hkv, nk, 1), (1, 1, bk, D),
                        lambda b, h, i, j: (b, h // rep, j, 0)),
            OperandSpec("v", "input", (B, Hkv, nk, 1), (1, 1, bk, Dv),
                        lambda b, h, i, j: (b, h // rep, j, 0)),
            OperandSpec("o", "output", (B, H, nq, 1), (1, 1, bq, Dv),
                        lambda b, h, i, j: (b, h, i, 0),
                        reduction_axes=(3,)),
        ) + ((OperandSpec("lse", "output", (B, H, nq), (1, 1, bq),
                          lambda b, h, i, j: (b, h, i) if j == nk - 1
                          else None),) if lse else ())
        return KernelContract(
            kernel="flash_attention", grid=(B, H, nq, nk), operands=operands,
            dimension_semantics=("parallel", "parallel", "parallel",
                                 "arbitrary"),
            preconditions=pre,
            description="plain online-softmax attention, K innermost")
    route = route_for(dtype, Sq, rep, kv_dtype or dtype)
    splits = split_count(B, Hkv, Sk) if route == "split" else 0
    pre += launch_preconditions(D, Dv, route, splits)
    pre += (Precondition.check(
        "keys to attend", Sk > 0,
        f"Sk={Sk}: no keys, and the wrapper returns zeros without a "
        f"launch"),)
    _, _, unit, _ = attention_tiles(route, Sq * rep, Sk, splits)
    nk = -(-Sk // unit)
    kv = tuple((name, (B, nk, Hkv, 1), (1, unit, 1, d), (lambda b, g, col0:
                (b, col0 // unit, g, 0)), None)
               for name, d in (("k", D), ("v", Dv)))
    return attention_contract("flash_attention", B=B, H=H, Hkv=Hkv, Sq=Sq,
                              D=D, Dv=Dv, route=route, splits=splits,
                              n_keys=Sk, kv_operands=kv, pre=pre, lse=lse)
