"""Transformer layers of the dense family and the BERT/ViT encoders:
RMSNorm and LayerNorm, RoPE, GQA/MQA attention (optional QKV biases and
q/k RMSNorm) over a paged or contiguous KV cache (or none), SwiGLU and GELU
MLPs (``repro/models/layers.py``).

Every projection goes through ``core.api.linear`` under the active
GemmPolicy (the MatrixFlow GEMM on the card); attention goes through
``core.api.attention`` under the active AttentionPolicy (on the card: the
paged kernel over page pools, the flash kernel over dense K/V).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import api
from repro_torch.core import quant as Q
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import dense_init, norm_init

# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm with the population variance (``jnp.var``) and an
    optional bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding in fp32. x: (B, S, H, D) with even D;
    positions: (B, S)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs            # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention with a paged or contiguous KV cache
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, dtype, device):
    """The projections; with ``qkv_bias`` (qwen2) zero biases ``bq``,
    ``bk``, ``bv``, and with ``qk_norm`` (qwen3) unit RMSNorm scales
    ``q_norm``, ``k_norm`` over a head's dims, as the reference inits
    them."""
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, H * dh, dtype, device),
         "wk": dense_init(gen, d, Hkv * dh, dtype, device),
         "wv": dense_init(gen, d, Hkv * dh, dtype, device),
         "wo": dense_init(gen, H * dh, d, dtype, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", H * dh), ("bk", Hkv * dh),
                            ("bv", Hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = norm_init(dh, dtype, device)
        p["k_norm"] = norm_init(dh, dtype, device)
    return p


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                         device):
    """Contiguous K/V of ``max_len`` positions per batch row, plus one more
    column at index ``max_len`` that attention never reads: the write sink
    for masked prefill positions (the TPU version drops those writes out of
    range; torch has no dropping scatter, and a sink keeps the write free
    of a host sync). ``len`` (B,) counts the positions written per row."""
    shape = (batch, max_len + 1, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _written_per_row(positions: torch.Tensor, len_dtype) -> torch.Tensor:
    """Tokens actually written per batch row: positions < 0 (masked rows
    and bucket-padding columns) do not count."""
    return (positions >= 0).sum(dim=1).to(len_dtype)


def _contiguous_cache_update(cache, k, v, positions):
    """Write new K/V into the contiguous cache at ``positions``.

    Prefill (S > 1) scatters per (row, column) in place; position −1
    columns go to the sink column. Decode (S == 1) writes each row's one
    position by a one-hot select, as the reference does; a position −1
    row matches no column and writes nothing. Either way a masked row
    leaves its cache and ``len`` untouched."""
    B, S = positions.shape
    T = cache["k"].shape[1] - 1
    if S > 1:
        rows = torch.arange(B, device=positions.device)[:, None].expand(B, S)
        cols = torch.where(positions >= 0, positions,
                           torch.full_like(positions, T)).long()
        cache["k"][rows, cols] = k
        cache["v"][rows, cols] = v
    else:
        at_pos = (torch.arange(T + 1, device=positions.device)[None, :]
                  == positions)[..., None, None]              # (B, T+1, 1, 1)
        cache["k"] = torch.where(at_pos, k, cache["k"])
        cache["v"] = torch.where(at_pos, v, cache["v"])
    cache["len"] += _written_per_row(positions, cache["len"].dtype)
    return cache


def init_paged_attention_cache(cfg: ModelConfig, batch: int, n_pages: int,
                               page_size: int, dtype, device, kv_dtype=None):
    """K/V pools of ``n_pages`` pages shared by every batch row, plus one
    more page at index ``n_pages`` that no block table names: the write
    sink for masked positions (the TPU version drops those writes out of
    range; torch has no dropping scatter, and a sink keeps the write free
    of a host sync). ``len`` is per row, as in the contiguous cache.

    ``kv_dtype="int8"`` stores the pools int8 with fp32 ``k_scale`` /
    ``v_scale`` of shape (n_pages + 1, Hkv), the sink page included, all
    ones at first, so an unwritten page dequantizes to exact zeros."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    Hkv = cfg.n_kv_heads
    shape = (n_pages + 1, page_size, Hkv, cfg.head_dim)
    pool_dtype = torch.int8 if kv_dtype == "int8" else dtype
    cache = {"kp": torch.zeros(shape, dtype=pool_dtype, device=device),
             "vp": torch.zeros(shape, dtype=pool_dtype, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if kv_dtype == "int8":
        cache["k_scale"] = torch.ones((n_pages + 1, Hkv), device=device)
        cache["v_scale"] = torch.ones((n_pages + 1, Hkv), device=device)
    return cache


def _paged_cache_update(cache, k, v, positions, block_tables):
    """Scatter new K/V into the page pools through the block tables, in
    place (the pools are the largest tensors of serving; the TPU version
    returns updated copies).

    Token (b, s) at position p lands in page ``block_tables[b, p // ps]``
    at offset ``p % ps``; positions < 0 (masked rows, bucket padding) go to
    the sink page and do not count: ``len`` advances by the written count.

    An int8 pool (``"k_scale" in cache``) quantizes on write: a page's
    per-head scale is FROZEN when its first row (position % ps == 0) is
    written (``quant.kv_write_scale``), and every row, the first included,
    quantizes against the frozen scale. The engine writes a page's
    positions in order, so a reused page's stale scale is overwritten
    before any row depends on it, and the payload is a pure function of
    the page's content — the same written token by token or in bulk, which
    keeps streams identical across preempt/resume.
    """
    B, S = positions.shape
    P, ps, Hkv, dh = cache["kp"].shape
    keep = positions >= 0
    pos = positions.clamp(min=0).long()
    page = torch.gather(block_tables.long(), 1, pos // ps)
    sink = P - 1
    if "k_scale" in cache:
        # first-row writes establish their page's scale; live block tables
        # are disjoint, so those targets are unique (the rest hit the sink)
        est = (keep & (pos % ps == 0)).reshape(-1)
        est_page = torch.where(est, page.reshape(-1), sink)
        new = []
        for t, name in ((k, "k_scale"), (v, "v_scale")):
            scales = cache[name]
            scales[est_page] = Q.kv_write_scale(t.reshape(B * S, Hkv, dh))
            new.append(Q.quantize_kv_rows(t, scales[page]))
        k, v = new
    flat = torch.where(keep, page * ps + pos % ps, sink * ps).reshape(-1)
    cache["kp"].view(P * ps, Hkv, dh)[flat] = k.reshape(B * S, Hkv, dh)
    cache["vp"].view(P * ps, Hkv, dh)[flat] = v.reshape(B * S, Hkv, dh)
    cache["len"] += _written_per_row(positions, cache["len"].dtype)
    return cache


def attention(p, cfg: ModelConfig, x, *, positions, cache=None,
              block_tables=None):
    """x: (B, S, D). ``cache`` is a paged ``{"kp", "vp", "len"}`` pool (then
    ``block_tables`` (B, n_blocks) is required; an int8 pool adds
    ``"k_scale"`` and ``"v_scale"``), a contiguous ``{"k", "v", "len"}``
    cache, or None (self-attention over x, causal per cfg).
    Returns (y, cache); a cache is updated in place (its dict entries)."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = api.linear(x, p["wq"], p.get("bq")).reshape(B, S, H, dh)
    k = api.linear(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, dh)
    v = api.linear(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q, k = rmsnorm(p["q_norm"], q), rmsnorm(p["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kv_scales = None
    if cache is None:
        kv_k, kv_v, bt = k, v, None
        kv_valid = torch.full((B,), S, dtype=torch.int32, device=x.device)
    elif "kp" in cache:
        if block_tables is None:
            raise ValueError("paged KV cache requires block_tables")
        cache = _paged_cache_update(cache, k, v, positions, block_tables)
        kv_k, kv_v, kv_valid, bt = (cache["kp"], cache["vp"], cache["len"],
                                    block_tables)
        if "k_scale" in cache:     # int8 pool: the kernel dequantizes pages
            kv_scales = (cache["k_scale"], cache["v_scale"])
    else:
        cache = _contiguous_cache_update(cache, k, v, positions)
        T = cache["k"].shape[1] - 1            # the sink column stays unread
        kv_k, kv_v = cache["k"][:, :T], cache["v"][:, :T]
        kv_valid, bt = cache["len"], None
    out = api.attention(q, kv_k, kv_v, q_positions=positions,
                        kv_valid_len=kv_valid, causal=cfg.causal,
                        scale=1.0 / math.sqrt(dh), block_tables=bt,
                        kv_scales=kv_scales)
    return api.linear(out.reshape(B, S, H * dh), p["wo"]), cache


# ---------------------------------------------------------------------------
# MLPs: SwiGLU (decoders) and GELU with biases (granite, BERT/ViT)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wi": dense_init(gen, d, 2 * f, dtype, device),
                "wo": dense_init(gen, f, d, dtype, device)}
    return {"wi": dense_init(gen, d, f, dtype, device),
            "bi": torch.zeros((f,), dtype=dtype, device=device),
            "wo": dense_init(gen, f, d, dtype, device),
            "bo": torch.zeros((d,), dtype=dtype, device=device)}


def mlp(p, cfg: ModelConfig, x):
    if cfg.mlp_act == "swiglu":
        gate, up = api.linear(x, p["wi"]).chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = torch.nn.functional.gelu(api.linear(x, p["wi"], p["bi"]),
                                     approximate="tanh")
    return api.linear(h, p["wo"], p.get("bo"))
