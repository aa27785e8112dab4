"""Model assembly for the dense decoder family (``repro/models/
transformer.py``): init, token embedding, forward over a paged KV cache.

Layers are a Python loop over per-layer parameter dicts (the JAX package
stacks them and scans). Other families — MoE, MLA, SSM, hybrid, the
encoders — are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.core import api
from repro_torch.models import layers as Lyr
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.module import dense_init, embed_init, norm_init


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config outside the ported dense
    family (plain GQA + RMSNorm + SwiGLU, untied head)."""
    unsupported = {
        "family": cfg.family != "dense",
        "MLA": cfg.is_mla, "MoE": cfg.is_moe, "SSM": bool(cfg.ssm_state),
        "qk_norm": cfg.qk_norm, "qkv_bias": cfg.qkv_bias,
        "norm": cfg.norm != "rmsnorm", "mlp_act": cfg.mlp_act != "swiglu",
        "n_codebooks": bool(cfg.n_codebooks),
        "first_dense_layers": bool(cfg.first_dense_layers),
        "tie_embeddings": cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet; the port covers "
            f"the dense decoder family (ROADMAP.md)")


def _init_block(gen, cfg: ModelConfig, dtype, device):
    return {"attn_norm": norm_init(cfg.d_model, dtype, device),
            "attn": Lyr.init_attention(gen, cfg, dtype, device),
            "mlp_norm": norm_init(cfg.d_model, dtype, device),
            "mlp": Lyr.init_mlp(gen, cfg, dtype, device)}


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: Union[str, torch.device] = "cuda") -> Dict:
    """Random weights with the reference's shapes and scales, drawn on the
    CPU from ``torch.Generator().manual_seed(seed)`` (the same values on
    every device) and placed on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.param_dtype
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)}
    params["layers"] = [_init_block(gen, cfg, dtype, device)
                        for _ in range(cfg.n_layers)]
    params["final_norm"] = norm_init(cfg.d_model, dtype, device)
    params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype, device,
                                scale=0.02)
    return params


def embed_tokens(params, cfg: ModelConfig, batch) -> torch.Tensor:
    return params["embed"][batch["tokens"]]


def forward(params, cfg: ModelConfig, batch, *,
            caches: Optional[List[Dict]] = None,
            last_cols: Optional[torch.Tensor] = None):
    """Returns (logits, caches). ``batch``: tokens (B, S) [+ positions
    (B, S), block_tables (B, n_blocks)]. ``caches`` — from
    :func:`init_paged_caches`, updated in place — or None for full causal
    self-attention. ``last_cols`` (B,) keeps only column ``last_cols[b]``
    of each row before the final norm and head, so logits are (B, 1,
    vocab): the serving prefill reads just each row's last real token."""
    x = embed_tokens(params, cfg, batch)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    block_tables = batch.get("block_tables")
    for i, lp in enumerate(params["layers"]):
        h, _ = Lyr.attention(lp["attn"], cfg, Lyr.rmsnorm(lp["attn_norm"], x),
                             positions=positions,
                             cache=None if caches is None else caches[i],
                             block_tables=block_tables)
        x = x + h
        x = x + Lyr.mlp(lp["mlp"], cfg, Lyr.rmsnorm(lp["mlp_norm"], x))
    if last_cols is not None:
        x = x[torch.arange(B, device=x.device), last_cols][:, None]
    x = Lyr.rmsnorm(params["final_norm"], x)
    return api.linear(x, params["head"]), caches


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, dtype, device) -> List[Dict]:
    """One paged KV cache per layer (``layers.init_paged_attention_cache``);
    one (batch, n_blocks) block table addresses every layer's pool."""
    check_supported(cfg)
    return [Lyr.init_paged_attention_cache(cfg, batch, n_pages, page_size,
                                           torch_dtype(dtype), device)
            for _ in range(cfg.n_layers)]
