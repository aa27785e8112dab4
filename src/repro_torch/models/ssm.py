"""Mamba-2 SSD mixer (arXiv:2405.21060), ``repro/models/ssm.py``.

Prefill runs the chunked SSD scan (``ssd_chunked``), which is the SSD
kernel K6 on the card (``kernels/ssd_scan.py``); decode keeps the O(1)
recurrent state and steps it in plain PyTorch (``ssd_decode_step``), as
the reference does outside any Pallas kernel. Every projection goes
through ``core.api.linear`` (the MatrixFlow GEMM on the card).

Shapes: x (B, S, H, P) heads × head-dim; the B/C projections are shared
across heads (n_groups = 1): (B, S, N); A is a scalar per head, dt one per
head and step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import api
from repro_torch.distributed import tp as TP
from repro_torch.kernels.forward_only import needs_grad
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.module import _normal, dense_init, norm_init


def init_ssd(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Dict:
    """Separate z/x/B/C/dt projections, depthwise conv kernels over x, B
    and C, and fp32 A_log, D and dt_bias — the reference's shapes and
    scales."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.ssm_heads, cfg.ssm_conv

    def conv(ch):          # drawn on the generator's device, as the rest
        return (_normal(gen, (K, ch), device) / math.sqrt(K)).to(
            dtype).to(device)

    return {
        "w_z": dense_init(gen, d, di, dtype, device),
        "w_x": dense_init(gen, d, di, dtype, device),
        "w_B": dense_init(gen, d, N, dtype, device),
        "w_C": dense_init(gen, d, N, dtype, device),
        "w_dt": dense_init(gen, d, H, dtype, device),
        "conv_x": conv(di),
        "conv_b_x": torch.zeros((di,), dtype=dtype, device=device),
        "conv_B": conv(N),
        "conv_b_B": torch.zeros((N,), dtype=dtype, device=device),
        "conv_C": conv(N),
        "conv_b_C": torch.zeros((N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.full((H,), math.log(math.e - 1), dtype=torch.float32,
                              device=device),
        "norm": norm_init(di, dtype, device),
        "w_out": dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. xbc (B, S, C); w (K, C). Returns (silu(y + b),
    new_state), the state being the last K − 1 inputs (for decode); a given
    ``conv_state`` is the left context instead of zeros."""
    K = w.shape[0]
    if conv_state is not None:
        ctx = torch.cat([conv_state, xbc], dim=1)          # (B, K-1+S, C)
    else:
        ctx = F.pad(xbc, (0, 0, K - 1, 0))
    new_state = ctx[:, -(K - 1):].contiguous()      # frees ctx
    S = xbc.shape[1]
    # windowed sum: y_t = Σ_k w_k · x_{t-K+1+k}, in the reference's order
    y = sum(ctx[:, k:k + S] * w[k] for k in range(K))
    return F.silu(y + b), new_state


def ssd_chunked(x, dt, A, Bc, Cc, chunk: int = 128, final_state: bool = True):
    """Chunked SSD scan. x (B, S, H, P), dt (B, S, H), A (H,), Bc/Cc
    (B, S, N); fp32 internals. Returns (y, the fp32 state (B, H, P, N)
    after the last step, or None when ``final_state`` is False). Under
    autograd on the CPU the plain scan runs (differentiable), and so it
    does on ``meta``, where the dry run counts its ops; the kernel K6,
    forward-only like the reference's, refuses a gradient."""
    dt, A = dt.float(), A.float()
    if x.device.type in ("cpu", "meta") and needs_grad(x, dt, A, Bc, Cc):
        return ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk,
                              final_state=final_state)
    return ssd_scan(x, dt, A, Bc, Cc, chunk=chunk, final_state=final_state)


def ssd_decode_step(x, dt, A, Bc, Cc, state):
    """One-token recurrence. x (B, 1, H, P), dt (B, 1, H), Bc/Cc (B, 1, N);
    state (B, H, P, N) fp32. Returns (y (B, 1, H, P), new state)."""
    xt = x[:, 0].float()
    dtt = dt[:, 0].float()
    bt, ct = Bc[:, 0].float(), Cc[:, 0].float()
    decay = torch.exp(dtt * A[None, :])[..., None, None]    # (B, H, 1, 1)
    dbx = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
    new_state = decay * state + dbx
    y = torch.einsum("bhpn,bn->bhp", new_state, ct)
    return y[:, None].to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (log(1 + e^x) as logaddexp(x, 0)), without
    torch's linear branch above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_block(p, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[Dict] = None, chunk: int = 128):
    """The Mamba-2 block: in-projections → causal conv → SSD → D skip →
    silu(z) gate → RMSNorm → out-projection. x (B, S, d_model).

    ``cache`` — ``{"conv": {"x", "B", "C"}, "state"}`` from
    :func:`init_ssd_cache` — is updated in place (its entries): a one-token
    step runs the decode recurrence; a longer prefill runs the chunked scan
    and stores its final state, which assumes the cache is fresh (as the
    reference does: a prefill continuing an earlier one would need an
    initial-state term). Returns (y, cache). Under sequence parallelism
    (``tp.seq_parallel``) x is the rank's rows of the sequence: the block
    gathers them, runs whole on every rank (its params are whole, as the
    reference's ``tp.linear`` runs them) and returns the rank's rows."""
    x = TP.seq_gather(x)
    B, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z = api.linear(x, p["w_z"])
    xc = api.linear(x, p["w_x"])
    bc = api.linear(x, p["w_B"])
    cc = api.linear(x, p["w_C"])
    dt = api.linear(x, p["w_dt"])
    cs = cache["conv"] if cache is not None else {"x": None, "B": None,
                                                  "C": None}
    xc, ncx = _causal_conv(xc, p["conv_x"], p["conv_b_x"], cs["x"])
    bc, ncb = _causal_conv(bc, p["conv_B"], p["conv_b_B"], cs["B"])
    cc, ncc = _causal_conv(cc, p["conv_C"], p["conv_b_C"], cs["C"])
    xc = xc.reshape(B, S, H, P)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    if cache is not None and S == 1:
        y, state = ssd_decode_step(xc, dt, A, bc, cc, cache["state"])
    else:
        y, state = ssd_chunked(xc, dt, A, bc, cc, chunk=min(chunk, S),
                               final_state=cache is not None)
    if cache is not None:
        cache["conv"] = {"x": ncx, "B": ncb, "C": ncc}
        cache["state"] = state
    y = y + xc * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, di) * F.silu(z)
    return TP.rows(api.linear(rmsnorm(p["norm"], y), p["w_out"])), cache


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    """Conv states (the last K − 1 inputs of x, B and C) in the cache dtype
    and the fp32 SSD state (B, H, P, N), all zeros."""
    K = cfg.ssm_conv

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"conv": {"x": zeros(batch, K - 1, cfg.d_inner),
                     "B": zeros(batch, K - 1, cfg.ssm_state),
                     "C": zeros(batch, K - 1, cfg.ssm_state)},
            "state": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state, dt=torch.float32)}
