"""Transformer layers (``repro/models/layers.py``): RMSNorm and LayerNorm,
RoPE, GQA/MQA attention (optional QKV biases and q/k RMSNorm) over a paged
or contiguous KV cache (or none), MLA (DeepSeek-V2's latent attention)
over a contiguous latent cache (or none), SwiGLU and GELU MLPs, and the
capacity-dropping MoE with its grouped expert bank.

Every projection goes through ``core.api.linear`` under the active
GemmPolicy (the MatrixFlow GEMM on the card); attention goes through
``core.api.attention`` under the active AttentionPolicy (on the card: the
paged kernel over page pools, the flash kernel over dense K/V). The call
sites the reference routes through tensor parallelism go through
``distributed/tp.py``, which is the plain ``api`` call without a TP
context; under one, heads, d_ff and the caches are the rank's slices.

Under sequence parallelism (``tp.seq_parallel``) a layer takes and
returns the rank's rows of the sequence: attention, MLA, the MLP and the
experts gather their input over the sequence first (``tp.seq_gather``)
and hand back the rank's rows of their output (``linear(seq_out=True)``,
``tp.rows``); the norms run on the rank's rows. Positions stay global.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import api
from repro_torch.core import quant as Q
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed import tp as TP
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import dense_init, norm_init

# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last dim (kept), summed by halving the row: a row's
    bits do not depend on how many rows share the call. torch.mean's CUDA
    reduction picks its order from the number of rows (a decode step's 8
    rows sum in another order than a prefill's hundreds), so a norm in a
    decode step would not give the bits a re-prefill or a prefix hit gives
    the same row, and bf16 greedy streams would part."""
    n = x.shape[-1]
    s = torch.nn.functional.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s / n


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(_row_mean(xf * xf) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm with the population variance (``jnp.var``: the mean
    of the squared deviations) and an optional bias."""
    xf = x.float()
    mu = _row_mean(xf)
    var = _row_mean(torch.square(xf - mu))
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
                         device, seq_cut=None):
    """Contiguous K/V of ``max_len`` positions per batch row, plus one more
    column at index ``max_len`` that attention never reads: the write sink
    for masked prefill positions (the TPU version drops those writes out of
    range; torch has no dropping scatter, and a sink keeps the write free
    of a host sync). ``len`` (B,) counts the positions written per row.

    With ``seq_cut`` (``tp.seq_cut``: the sequence cut over a mesh axis)
    the rank holds its ``seq_cut.cols`` columns and a sink of its own, and
    the cache carries ``seq_offset``, its first global column (0-d int32);
    ``len`` stays global."""
    cols = max_len if seq_cut is None else seq_cut.cols
    shape = (batch, cols + 1, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if seq_cut is not None:
        cache["seq_offset"] = TP.seq_offset_tensor(seq_cut, device)
    return cache


def _written_per_row(positions: torch.Tensor, len_dtype) -> torch.Tensor:
    """Tokens actually written per batch row: positions < 0 (masked rows
    and bucket-padding columns) do not count."""
    return (positions >= 0).sum(dim=1).to(len_dtype)


def _contiguous_cache_update(cache, new, positions):
    """Write ``new`` ({name: (B, S, ...)}: K and V, or MLA's latent rows)
    into the contiguous cache's buffers of the same names at
    ``positions``.

    Prefill (S > 1) scatters per (row, column) in place; position −1
    columns go to the sink column. Decode (S == 1) writes each row's one
    position by a one-hot select, as the reference does; a position −1
    row matches no column and writes nothing. Either way a masked row
    leaves its cache and ``len`` untouched. The rows are cast to the
    cache's dtype (an fp32 model may serve from a bf16 cache).

    A cache cut over the sequence (``cache["seq_offset"]``, its first
    global column) takes global positions: each lands at ``position -
    offset`` where that is one of the rank's T/n columns; elsewhere a
    prefill column goes to the rank's sink and a decode row writes
    nothing. ``len`` advances on every rank by the written count."""
    B, S = positions.shape
    T = cache[next(iter(new))].shape[1] - 1
    new = {name: t.to(cache[name].dtype) for name, t in new.items()}
    if "seq_offset" in cache:         # global positions -> the rank's columns
        local = positions - cache["seq_offset"].to(positions.dtype)
        mine = (positions >= 0) & (local >= 0) & (local < T)
        positions_w = torch.where(mine, local, torch.full_like(local, -1))
    else:
        positions_w = positions
    if S > 1:
        rows = torch.arange(B, device=positions.device)[:, None].expand(B, S)
        cols = torch.where(positions_w >= 0, positions_w,
                           torch.full_like(positions_w, T)).long()
        for name, t in new.items():
            cache[name][rows, cols] = t
    else:
        at_pos = (torch.arange(T + 1, device=positions.device)[None, :]
                  == positions_w)                             # (B, T+1)
        for name, t in new.items():
            mask = at_pos.reshape(B, T + 1, *[1] * (t.dim() - 2))
            cache[name] = torch.where(mask, t, cache[name])
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
    keeps streams identical across preempt/resume. An fp pool stores the
    rows cast to its dtype (an fp32 model may serve from a bf16 cache).
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
    else:
        k, v = k.to(cache["kp"].dtype), v.to(cache["vp"].dtype)
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
    x = TP.seq_gather(x)
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # Under TP: Q/K/V column-parallel (whole heads), then each brought to
    # the head slice attention takes (gathered where attention stays
    # replicated); the caches hold the rank's KV heads. Without a cache, a
    # layer whose KV heads stay replicated runs the rank's query heads over
    # their groups' KV heads (tp.kv_group_slice).
    ctx = TP.current_tp()
    shard_q, shard_kv = TP.head_sharding(ctx, H, Hkv)
    kv_slice = TP.kv_group_slice(ctx, H, Hkv) if cache is None else None
    shard_q = shard_q or kv_slice is not None
    q = TP.linear(x, p["wq"], p.get("bq"), axes=("embed", "heads"), units=H,
                  full=(D, H * dh))
    k = TP.linear(x, p["wk"], p.get("bk"), axes=("embed", "kv_heads"),
                  units=Hkv, full=(D, Hkv * dh))
    v = TP.linear(x, p["wv"], p.get("bv"), axes=("embed", "kv_heads"),
                  units=Hkv, full=(D, Hkv * dh))
    q = TP.conform_heads(q.reshape(B, S, -1, dh), H, shard_q)
    k = TP.conform_heads(k.reshape(B, S, -1, dh), Hkv, shard_kv)
    v = TP.conform_heads(v.reshape(B, S, -1, dh), Hkv, shard_kv)
    if cfg.qk_norm:
        q = rmsnorm(TP.on_slice(p["q_norm"], shard_q), q)
        k = rmsnorm(TP.on_slice(p["k_norm"], shard_kv), k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_slice is not None:
        k, v = TP.take_kv_heads(k, kv_slice), TP.take_kv_heads(v, kv_slice)
    elif shard_q and not shard_kv:
        # MQA: each rank's query heads read the one whole K/V head, so
        # each rank's gradient of it is partial (summed backward)
        k, v = TP.to_ranks(k), TP.to_ranks(v)
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
        cache = _contiguous_cache_update(cache, {"k": k, "v": v}, positions)
        T = cache["k"].shape[1] - 1            # the sink column stays unread
        kv_k, kv_v = cache["k"][:, :T], cache["v"][:, :T]
        kv_valid, bt = cache["len"], None
    out = TP.attention(q, kv_k, kv_v, q_positions=positions,
                       kv_valid_len=kv_valid, causal=cfg.causal,
                       scale=1.0 / math.sqrt(dh), block_tables=bt,
                       kv_scales=kv_scales, heads=(H, Hkv), kv_slice=kv_slice,
                       seq_offset=None if cache is None
                       else cache.get("seq_offset"))
    # row-parallel under TP: the contraction over the rank's heads, summed
    y = TP.linear(out.reshape(B, S, -1), p["wo"], axes=("heads", "embed"),
                  units=H, full=(H * dh, D), seq_out=True)
    return y, cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, dtype, device):
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    return {"wq_a": dense_init(gen, d, rq, dtype, device),
            "q_norm": norm_init(rq, dtype, device),
            "wq_b": dense_init(gen, rq, H * (dn + dr), dtype, device),
            "wkv_a": dense_init(gen, d, r + dr, dtype, device),
            "kv_norm": norm_init(r, dtype, device),
            "wkv_b": dense_init(gen, r, H * (dn + dv), dtype, device),
            "wo": dense_init(gen, H * dv, d, dtype, device)}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, seq_cut=None):
    """The latent cache: the normalized KV latent ``ckv`` (B, max_len + 1,
    kv_lora_rank) and the roped key part ``krope`` (B, max_len + 1,
    qk_rope_head_dim), each with the sink column of
    :func:`init_attention_cache`, and ``len`` (B,). With ``seq_cut``
    (``tp.seq_cut`` of ``ckv``) the rank holds its columns and a sink of
    its own, and ``seq_offset``, as :func:`init_attention_cache` does."""
    cols = max_len if seq_cut is None else seq_cut.cols
    cache = {"ckv": torch.zeros((batch, cols + 1, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
             "krope": torch.zeros((batch, cols + 1, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if seq_cut is not None:
        cache["seq_offset"] = TP.seq_offset_tensor(seq_cut, device)
    return cache


def mla_attention(p, cfg: ModelConfig, x, *, positions, cache=None,
                  block_tables=None):
    """MLA over the contiguous latent cache ``{"ckv", "krope", "len"}``
    (updated in place) or none. K and V are up-projected per head from the
    whole cache on every call, as the reference does; the cache itself
    stays compressed. q and k have qk_nope_head_dim + qk_rope_head_dim
    dims, v has v_head_dim. Returns (y, cache).

    Under TP the query heads, ``wq_b``'s and ``wkv_b``'s columns and
    ``wo``'s rows are cut by heads. A latent cut over the sequence
    (``cache["seq_offset"]``) holds the rank's columns: the rank
    up-projects only those and K3 runs over them with its log-sum-exp,
    merged over the cut's group (``tp.cut_attention``). Where the cut
    takes the model axis too (``tp.latent_up_whole``), the rank holds
    ``wkv_b`` whole, gathers the queries of every head, runs every head
    over its columns, and keeps its own heads of the merge for ``wo``."""
    if block_tables is not None:
        raise NotImplementedError(
            "paged KV caches cover GQA attention only; the MLA latent cache "
            "stays contiguous (docs/serving.md)")
    x = TP.seq_gather(x)
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    ctx = TP.current_tp()
    shard_h, _ = TP.head_sharding(ctx, H, H)
    up_whole = TP.latent_up_whole(ctx)
    q = rmsnorm(p["q_norm"], api.linear(x, p["wq_a"]))
    q = TP.linear(q, p["wq_b"], axes=("kv_lora", "heads"), units=H,
                  full=(rq, H * (dn + dr)))
    q = TP.conform_heads(q.reshape(B, S, -1, dn + dr), H, shard_h)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = api.linear(x, p["wkv_a"])                           # (B, S, r + dr)
    c_kv = rmsnorm(p["kv_norm"], ckv[..., :r])
    k_rope = rope(ckv[..., r:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0]
    seq_offset = None
    if cache is not None:
        cache = _contiguous_cache_update(
            cache, {"ckv": c_kv, "krope": k_rope}, positions)
        T = cache["ckv"].shape[1] - 1          # the sink column stays unread
        c_all, kr_all = cache["ckv"][:, :T], cache["krope"][:, :T]
        kv_valid, seq_offset = cache["len"], cache.get("seq_offset")
    else:
        c_all, kr_all = c_kv, k_rope
        kv_valid = torch.full((B,), S, dtype=torch.int32, device=x.device)
    every_head = up_whole and shard_h and seq_offset is not None
    if up_whole:                   # wkv_b whole: every head's K and V
        kv = api.linear(c_all, p["wkv_b"])
    else:
        kv = TP.linear(c_all, p["wkv_b"], axes=("kv_lora", "heads"),
                       units=H, full=(r, H * (dn + dv)))
    kv = kv.reshape(B, kv.shape[1], -1, dn + dv)
    if not every_head:
        kv = TP.conform_heads(kv, H, shard_h)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    # the one rope key, shared by every head: a rank of sliced heads reads
    # it for its heads only, so its gradient is summed over the group
    kr = TP.to_ranks(kr_all) if shard_h else kr_all
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        *k_nope.shape[:3], dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(dn + dr)
    if seq_offset is None:
        out = TP.attention(q, k, v, q_positions=positions,
                           kv_valid_len=kv_valid, causal=True, scale=scale,
                           heads=(H, H))
    else:
        if every_head:             # the cut and the heads share model
            q = TP.all_gather(q, 2, ctx.group)
        group = TP.seq_group(ctx, "ckv", (B, c_all.shape[1], r))
        out = TP.cut_attention(q, k, v, q_positions=positions,
                               kv_valid_len=kv_valid, seq_offset=seq_offset,
                               group=group, causal=True, scale=scale)
        if every_head:             # this rank's heads for the row-parallel wo
            out = out.narrow(2, ctx.rank * (H // ctx.model_size),
                             H // ctx.model_size)
    y = TP.linear(out.reshape(B, S, -1), p["wo"], axes=("heads", "embed"),
                  units=H, full=(H * dv, D), seq_out=True)
    return y, cache


# ---------------------------------------------------------------------------
# MLPs: SwiGLU (decoders) and GELU with biases (granite, BERT/ViT)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, dtype, device, d_ff=None, d_in=None):
    """``d_ff`` / ``d_in`` default to the config's (MoE's shared experts
    take ``n_shared_experts x moe_d_ff``)."""
    d, f = d_in or cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wi": dense_init(gen, d, 2 * f, dtype, device),
                "wo": dense_init(gen, f, d, dtype, device)}
    return {"wi": dense_init(gen, d, f, dtype, device),
            "bi": torch.zeros((f,), dtype=dtype, device=device),
            "wo": dense_init(gen, f, d, dtype, device),
            "bo": torch.zeros((d,), dtype=dtype, device=device)}


def mlp(p, cfg: ModelConfig, x, d_ff=None, *, whole: bool = False):
    """``d_ff`` defaults to the config's (MoE's shared experts pass their
    summed width). Under TP the up (and gate) projection is
    column-parallel — SwiGLU's gate ‖ up weight sliced half by half, so
    the activation is the rank's slice of d_ff — and the down projection
    row-parallel. ``whole``: under sequence parallelism x is the whole
    sequence already (MoE's shared experts), not the rank's rows."""
    if not whole:
        x = TP.seq_gather(x)
    D, f = x.shape[-1], d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        gate, up = TP.linear(x, p["wi"], axes=("embed", "mlp"),
                             full=(D, 2 * f), blocks=2).chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = torch.nn.functional.gelu(
            TP.linear(x, p["wi"], p["bi"], axes=("embed", "mlp"),
                      full=(D, f)), approximate="tanh")
    return TP.linear(h, p["wo"], p.get("bo"), axes=("mlp", "embed"),
                     full=(f, D), seq_out=True)


# ---------------------------------------------------------------------------
# MoE — capacity-based sort/scatter dispatch
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ModelConfig, dtype, device):
    """The router (d_model, n_experts), the expert banks ``wi`` (E, d, 2f)
    and ``wo`` (E, f, d) — drawn an expert at a time, so a full-width bank
    never has an fp32 copy — and, with shared experts, one MLP of their
    summed width."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff

    def bank(d_in, d_out):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
        if w.device.type == "meta":        # shapes only: nothing to draw
            return w
        for e in range(E):
            w[e] = dense_init(gen, d_in, d_out, dtype, device)
        return w

    p = {"router": dense_init(gen, d, E, dtype, device, scale=0.02),
         "wi": bank(d, 2 * f), "wo": bank(f, d)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, dtype, device,
                               d_ff=cfg.n_shared_experts * f)
    return p


def _moe_groups(T: int, target: int = 32) -> int:
    """Token groups of the dispatch: the largest divisor of T <= target."""
    g = min(target, T)
    while T % g:
        g -= 1
    return max(g, 1)


def _rank_groups(T: int) -> int:
    """The dispatch groups of this rank's T tokens. Under a data-parallel
    context of n ranks (``distributed/fsdp.py``: pod x data) the groups
    are those of the global batch's n·T tokens, aligned with the batch
    shards as in the reference: the rank takes G/n of the G global
    groups, each of the global size (so each expert keeps the global
    capacity C)."""
    ctx = FSDP.current_fsdp()
    n = 1 if ctx is None else ctx.batch_size
    G = _moe_groups(T * n)
    if G % n:
        raise NotImplementedError(
            f"MoE dispatch over {n} data ranks: the global batch's "
            f"{T * n} tokens form {G} groups, which do not divide over the "
            f"data axis, so a rank's tokens are not whole groups")
    return G // n


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, a tie going to
    the lower index (a stable descending sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe(p, cfg: ModelConfig, x):
    """x (B, S, D) → (y (B, S, D), the load-balance aux loss), the
    reference's grouped capacity dispatch (GShard-style dropping):

    1. the B x S tokens in G groups of t (:func:`_moe_groups`; under data
       parallelism the rank's share of the global batch's groups,
       :func:`_rank_groups`); the router
       (through ``api.matmul``, K1 on the card) picks each token's top k
       experts, their probabilities renormalized as gates;
    2. per group, the (token, choice) pairs sorted stably by expert fill
       each expert's C = min(max(int(t k / E x capacity_factor), 1), t k)
       slots in token order; the rest go to the trash slot E C and are
       dropped. Every token counts, bucket padding (position −1) included,
       so which tokens drop depends on the whole group;
    3. the experts run as one bank product per projection (``torch.einsum``
       over (G, E, C, D), as the reference's ``jnp.einsum``);
    4. combine: ``"gather"`` takes each pair's slot row times its gate and
       sums a token's k; ``"local"`` scales the slot rows by their gates
       (0 in the trash) and adds them into their tokens, in slot order.

    The aux loss ``E · mean(density · mean probs)`` takes both means over
    the global batch: under data parallelism each is averaged over the
    data group (``fsdp.mean_over_data``) before the product is formed.

    Under expert parallelism (the rank holds its experts' slice of the
    banks, ``tp.expert_slice``) the router, top-k, aux loss and dispatch
    run whole on every rank of the model group, whose activations are
    replicated; the rank fills only its experts' slots (the others go to
    the trash), runs its bank slices and combines its slots, and the
    partial outputs are summed over the group (``tp.sum_over_ranks``, in
    fp32). The ``xt`` that fills the buffer and the gates that weight the
    combine are each read here only for the rank's own experts, so their
    gradients are summed over the group (``tp.to_ranks``); the router's
    ``xt`` and the aux loss's ``probs`` are read whole and are not.

    Under sequence parallelism x is the rank's rows: it is gathered over
    the sequence before routing (the reference keeps the sequence whole
    there, its ``layers.py:511``), so the dispatch groups are the
    baseline's; the output is the rank's rows (the partial outputs of
    expert parallelism reduce-scattered over the sequence), and the aux
    loss's mean of ``probs`` is the sum of the ranks' sums over their own
    rows (``tp.row_mean``).
    """
    x = TP.seq_gather(x)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    T = B * S
    G = _rank_groups(T)
    t = T // G
    C = min(max(int(t * k / E * cfg.capacity_factor), 1), t * k)
    e0, El = TP.expert_slice(E, p["wi"].shape[0])
    ep = El != E
    dev = x.device
    xt = x.reshape(G, t, D)

    logits = api.matmul(xt, p["router"]).float()                # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = _top_k(probs, k)                                # (G, t, k)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    density = FSDP.mean_over_data(torch.nn.functional.one_hot(
        ids[..., 0], E).float().mean(dim=(0, 1)))
    aux = E * torch.mean(density * FSDP.mean_over_data(TP.row_mean(
        probs.reshape(B, S, E))))

    # dispatch, every group at once: flat pair i = (token i // k, choice)
    flat_e = ids.reshape(G, t * k)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos_in_e = torch.arange(t * k, device=dev) - torch.gather(start, 1,
                                                              sorted_e)
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))        # E*C: trash
    if ep:          # the rank's experts' slots, from 0; the rest: trash
        mine = (slot >= e0 * C) & (slot < (e0 + El) * C)
        slot = torch.where(mine, slot - e0 * C,
                           torch.full_like(slot, El * C))
        xt_d, gate = TP.to_ranks(xt), TP.to_ranks(gate)
    else:
        xt_d = xt
    trash = El * C
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, t * k)
    buf = torch.zeros((G, trash + 1, D), dtype=x.dtype, device=dev)
    buf[g_idx, slot] = xt_d[g_idx, flat_t[order]]
    slot_for_flat = torch.empty_like(slot).scatter_(1, order, slot)

    h = buf[:, :-1].reshape(G, El, C, D)
    with api.saved_products():        # remat "dots" keeps the banks' outputs
        gi = torch.einsum("gecd,edf->gecf", h, p["wi"]).to(x.dtype)
    g_, u = gi.chunk(2, dim=-1)
    hh = torch.nn.functional.silu(g_) * u
    with api.saved_products():
        out = torch.einsum("gecf,efd->gecd", hh, p["wo"]).to(x.dtype)
    out = torch.cat([out.reshape(G, trash, D),
                     torch.zeros((G, 1, D), dtype=x.dtype, device=dev)], 1)

    def rows(slots):                     # out's rows at slots (G, n)
        return torch.gather(out, 1, slots[..., None].expand(*slots.shape, D))

    if cfg.moe_combine == "local":
        gate_slot = torch.zeros((G, trash + 1), dtype=torch.float32,
                                device=dev)
        gate_slot[g_idx, slot_for_flat] = gate.reshape(G, t * k)
        gate_slot[:, trash] = 0.0        # dropped pairs contribute 0
        upd_slot = gate_slot.to(x.dtype)
        by_slot = torch.sort(slot_for_flat.reshape(G, t, k), dim=-1).values
        y = torch.zeros((G, t, D), dtype=x.dtype, device=dev)
        for j in range(k):
            s_j = by_slot[..., j]
            y = y + rows(s_j) * torch.gather(upd_slot, 1, s_j)[..., None]
    else:
        contrib = rows(slot_for_flat).reshape(G, t, k, D)
        y = torch.sum(contrib * gate[..., None].to(x.dtype), dim=2)
    y = y.reshape(B, S, D)
    y = TP.sum_to_rows(y.float()).to(x.dtype) if ep else TP.rows(y)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], cfg, x, whole=True,
                    d_ff=cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff))
    return y, aux
