"""Plain PyTorch versions of the kernels: the ground truth the CUDA kernels
are held against on the card, and what the kernel wrappers run for tensors
on the CPU.

``block_matmul_ref`` is the paper's Algorithm 1 over block-major operands,
as ``repro/core/blockflow.py`` renders it: output block (i, j) accumulates
A_bm[i, k] @ B_bm[j, k] with K innermost and is written once. Integer
operands accumulate exactly: in int64 on the CPU, in float64 on CUDA
(which has no integer matmul; float64 is exact for int8 products summed
over any K below 2**37), so both devices give the same integers. With
``scale_a``/``scale_b`` it is the W8A8 GEMM: the finished int32 block is
rescaled at its flush (``core/quant.py``).

``ssd_ref`` is the Mamba-2 SSD recurrence one step at a time, the oracle;
``ssd_chunked_ref`` is the chunked scan the SSD kernel computes.

:func:`blockflow_contract` (registered as ``"blockflow"``) states
Algorithm 1's block addressing for the static checker
(``analysis/kernel_contracts.py``): the ``blockflow`` GEMM backend runs
:func:`block_matmul_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.kernel_contracts import (KernelContract,
                                                   OperandSpec,
                                                   register_contract)


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """The paper's MAC accumulator policy: int32 for integers, else fp32."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def work_dtype(acc: torch.dtype, device) -> torch.dtype:
    """The dtype products accumulate in: fp32 for fp operands; for integer
    ones an exact type, int64 on the CPU and float64 on CUDA (no integer
    matmul there)."""
    if acc == torch.float32:
        return torch.float32
    return torch.int64 if torch.device(device).type == "cpu" \
        else torch.float64


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B on row-major operands with the accumulator policy."""
    acc = acc_dtype_for(a.dtype)
    work = work_dtype(acc, a.device)
    return torch.matmul(a.to(work), b.to(work)).to(out_dtype or acc)


def _pad_scales(scale: Optional[torch.Tensor], n: int,
               device) -> torch.Tensor:
    """A (≤ n,) scale vector as fp32 (n,), padded with ones; all ones when
    absent. Padded rows and channels multiply an accumulator of 0, and the
    caller's un-blocking drops them."""
    out = torch.ones((n,), dtype=torch.float32, device=device)
    if scale is not None:
        out[:scale.shape[0]] = scale.float()
    return out


def block_matmul_ref(a_bm: torch.Tensor, b_bm: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None,
                     scale_a: Optional[torch.Tensor] = None,
                     scale_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C_bm = A_bm @ B_bm over block-major operands (Algorithm 1).

    a_bm (nbm, nbk, bm, bk), b_bm (nbn, nbk, bk, bn) → C_bm (nbm, nbn, bm,
    bn) in ``out_dtype`` (default: the accumulator dtype); a leading batch
    dim on both operands runs one problem per batch entry.

    ``scale_a`` (≤ nbm·bm rows) / ``scale_b`` (≤ nbn·bn channels) make it
    the dequant-fused int8 GEMM: the int32 accumulator becomes
    ``float(c) * s_a[m] * s_b[n]``, the two fp32 products in that order,
    then ``out_dtype`` (default fp32).
    """
    *lead, nbm, nbk, bm, bk = a_bm.shape
    nbn, nbk2, bk2, bn = b_bm.shape[-4:]
    if (nbk, bk) != (nbk2, bk2):
        raise ValueError(
            f"block-major operands disagree on the K stream: a_bm "
            f"{tuple(a_bm.shape)} vs b_bm {tuple(b_bm.shape)}")
    acc = acc_dtype_for(a_bm.dtype)
    work = work_dtype(acc, a_bm.device)
    c = torch.zeros((*lead, nbm, nbn, bm, bn), dtype=work,
                    device=a_bm.device)
    for k in range(nbk):               # the K stream, innermost in Alg. 1
        c += torch.einsum("...iab,...jbc->...ijac",
                          a_bm.select(-3, k).to(work),
                          b_bm.select(-3, k).to(work))
    if scale_a is None and scale_b is None:
        return c.to(out_dtype or acc)
    if acc != torch.int32:
        raise ValueError(f"scales take int8 operands, got {a_bm.dtype}")
    sa = _pad_scales(scale_a, nbm * bm, c.device).reshape(nbm, 1, bm, 1)
    sb = _pad_scales(scale_b, nbn * bn, c.device).reshape(1, nbn, 1, bn)
    c = c.to(torch.int32).float() * sa * sb
    return c.to(out_dtype or torch.float32)


@register_contract("blockflow")
def blockflow_contract(*, nbm, nbn, nbk, device="cuda") -> KernelContract:
    """Contract of :func:`block_matmul_ref`'s dataflow (Algorithm 1), the
    ``blockflow`` backend's on every device: output block (i, j)
    accumulates along k — the declared reduction axis, the loop above —
    and every A/B block is streamed where the paper's dc/dm orders place
    it. Nothing here is a launch, so ``device`` changes nothing."""
    operands = (
        OperandSpec("a_bm", "input", (nbm, nbk), (1, 1),
                    lambda i, j, k: (i, k)),
        OperandSpec("b_bm", "input", (nbn, nbk), (1, 1),
                    lambda i, j, k: (j, k)),
        OperandSpec("c_bm", "output", (nbm, nbn), (1, 1),
                    lambda i, j, k: (i, j), reduction_axes=(2,)),
    )
    return KernelContract(
        kernel="blockflow", grid=(nbm, nbn, nbk), operands=operands,
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        description="paper Algorithm 1, the plain PyTorch rendering (K "
                    "stream innermost)")


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: Optional[float] = None,
            soft_cap: Optional[float] = None,
            q_positions: Optional[torch.Tensor] = None,
            kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference grouped-query attention with an fp32 softmax
    (``repro/kernels/ref.py::mha_ref``).

    q (B, Sq, H, D); k, v (B, Sk, Hkv, D). Key j of row b is visible to
    query i iff ``j < kv_valid_len[b]`` and, when causal,
    ``j <= q_positions[b, i]``; default positions are bottom-right aligned
    (``arange(Sq) + Sk - Sq``). A query row with no visible key is zeros.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if soft_cap:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    dev = q.device
    if q_positions is None:
        q_positions = (torch.arange(Sq, device=dev) + (Sk - Sq)).expand(B, Sq)
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), Sk, device=dev)
    kv_pos = torch.arange(Sk, device=dev)[None, None, :]
    valid = kv_pos < kv_valid_len[:, None, None]
    if causal:
        valid = valid & (kv_pos <= q_positions[:, :, None])
    valid = valid.expand(B, Sq, Sk)[:, None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) scan
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """Sequential-scan oracle of the SSD recurrence
    (``repro/kernels/ref.py::ssd_ref``), one time step at a time:

        h_t = exp(A · dt_t) · h_{t-1} + dt_t · x_t B_tᵀ ;  y_t = h_t C_t

    x (B, S, H, P), dt (B, S, H), A (H,), Bc/Cc (B, S, N); fp32 state
    (B, H, P, N) from zeros; returns y (B, S, H, P) in x's dtype.
    """
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bc, Cc))
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(A.float()[None, :] * dtf[:, t])[..., None, None]
        dbx = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * bf[:, t, None, None, :]
        h = decay * h + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunk_size(S: int, chunk: int) -> int:
    """The SSD scan's chunk (``repro/kernels/ssd_scan.py::ssd_chunk_size``):
    the largest divisor of S that is at most ``chunk``."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor, *, chunk: int = 128,
                    final_state: bool = True):
    """The chunked SSD scan, chunk after chunk with the fp32 (P, N) state
    carried along: the plain version of the SSD kernel (K6), in the order
    the TPU kernel computes each chunk (``repro/kernels/ssd_scan.py::
    _kernel``; ``repro/models/ssm.py::ssd_chunked`` is the same algorithm).

    Per chunk of Q = ``ssd_chunk_size(S, chunk)`` steps: the cumulative
    log-decay ``cum`` of a = dt·A; ``L[i, j] = exp(cum_i − cum_j)`` for
    j ≤ i, 0 above the diagonal (masked in the exponent, never evaluated
    there, where it overflows); y = (L ∘ C Bᵀ)(dt x) + exp(cum) ∘ (C hᵀ);
    then h ← exp(cum_Q) h + (exp(cum_Q − cum) ∘ dt x)ᵀ B. ``cum`` is summed
    in fp64 and its differences rounded to fp32 before each exp: in fp32,
    differences of two sums near −100 keep ~1e-4 relative error, as much
    as the reference's tolerance (the JAX package sums it in fp32).

    x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, Bc/Cc (B, S, N).
    Returns (y (B, S, H, P) in x's dtype, the state after the last chunk
    (B, H, P, N) fp32, or None when ``final_state`` is False).
    """
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    Q = ssd_chunk_size(S, chunk)
    dev = x.device
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
    ys = []
    for c0 in range(0, S, Q):
        dtc = dt[:, c0:c0 + Q].float()                          # (B, Q, H)
        dtx = (x[:, c0:c0 + Q].float() * dtc[..., None]).transpose(1, 2)
        bq = Bc[:, c0:c0 + Q].float()                           # (B, Q, N)
        cq = Cc[:, c0:c0 + Q].float()
        cum = torch.cumsum((dtc * A.float()).transpose(1, 2).double(),
                           dim=-1)                              # (B, H, Q)
        diff = cum[..., :, None] - cum[..., None, :]            # (B, H, Q, Q)
        L = torch.exp(torch.where(below, diff, neg_inf).float())
        cb = torch.matmul(cq, bq.transpose(1, 2))[:, None]      # (B, 1, Q, Q)
        y = torch.matmul(L * cb, dtx)                           # (B, H, Q, P)
        y = y + torch.matmul(cq[:, None], h.transpose(-1, -2)) \
            * torch.exp(cum.float())[..., None]
        ys.append(y)
        if final_state or c0 + Q < S:
            decay_end = torch.exp((cum[..., -1:] - cum).float())  # (B, H, Q)
            h = h * torch.exp(cum[..., -1].float())[..., None, None] \
                + torch.matmul((dtx * decay_end[..., None]).transpose(-1, -2),
                               bq[:, None])
    y = torch.cat(ys, dim=2).transpose(1, 2).to(x.dtype).contiguous()
    return y, (h if final_state else None)
