"""Model assembly for the dense decoder family, the Mamba-2 (``ssm``) and
Zamba-2 (``hybrid``) families and the BERT/ViT encoders
(``repro/models/transformer.py``): init, token embedding, forward over
paged or contiguous caches or none, and ``encoder_forward``.

Layers are a Python loop over per-layer parameter dicts (the JAX package
stacks them and scans). A hybrid applies its one weight-shared attention
block after every ``attn_every`` SSD layers. Other families — MoE, MLA,
audio, VLM — are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.core import api
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.module import dense_init, embed_init, norm_init

# What each ported family is: (norm, mlp_act, causal). The encoders are
# the reference's BERT/ViT: LayerNorm, GELU MLP with biases, bidirectional.
# ssm layers are SSD blocks; hybrid adds the shared attention + MLP block.
_FAMILIES = {"dense": ("rmsnorm", "swiglu", True),
             "ssm": ("rmsnorm", "swiglu", True),
             "hybrid": ("rmsnorm", "swiglu", True),
             "bert": ("layernorm", "gelu", False),
             "vit": ("layernorm", "gelu", False)}
SSD_FAMILIES = ("ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config outside the ported families:
    the dense decoder (plain GQA + RMSNorm + SwiGLU, causal, untied head),
    Mamba-2 (SSD blocks only), the Zamba-2 hybrid (SSD blocks and one
    shared attention block every ``attn_every`` layers) and the BERT/ViT
    encoders (MHA + LayerNorm + GELU, bidirectional)."""
    norm, act, causal = _FAMILIES.get(cfg.family, (None, None, None))
    ssd = cfg.family in SSD_FAMILIES
    unsupported = {
        "family": cfg.family not in _FAMILIES,
        "MLA": cfg.is_mla, "MoE": cfg.is_moe,
        "SSM outside the ssm/hybrid families": bool(cfg.ssm_state) != ssd,
        "attn_every outside the hybrid family":
            bool(cfg.attn_every) != (cfg.family == "hybrid"),
        "n_layers not a multiple of attn_every":
            bool(cfg.attn_every) and cfg.n_layers % cfg.attn_every != 0,
        "qk_norm": cfg.qk_norm, "qkv_bias": cfg.qkv_bias,
        "norm": norm is not None and cfg.norm != norm,
        "mlp_act": act is not None and cfg.mlp_act != act,
        "causal": causal is not None and cfg.causal != causal,
        "GQA encoder": cfg.family in ("bert", "vit")
        and cfg.n_kv_heads != cfg.n_heads,
        "n_codebooks": bool(cfg.n_codebooks),
        "first_dense_layers": bool(cfg.first_dense_layers),
        "tie_embeddings": cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet; the port covers "
            f"the dense decoder family, Mamba-2, the Zamba-2 hybrid and the "
            f"BERT/ViT encoders (ROADMAP.md)")


def _init_block(gen, cfg: ModelConfig, dtype, device, kind: str = "attn"):
    if kind == "ssd":
        return {"mix_norm": norm_init(cfg.d_model, dtype, device),
                "ssd": SSM.init_ssd(gen, cfg, dtype, device)}
    bias = cfg.norm == "layernorm"
    return {"attn_norm": norm_init(cfg.d_model, dtype, device, bias),
            "attn": Lyr.init_attention(gen, cfg, dtype, device),
            "mlp_norm": norm_init(cfg.d_model, dtype, device, bias),
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
    if cfg.attn_every:         # zamba-style hybrid: the shared attention block
        params["shared_attn"] = _init_block(gen, cfg, dtype, device)
    kind = "ssd" if cfg.family in SSD_FAMILIES else "attn"
    params["layers"] = [_init_block(gen, cfg, dtype, device, kind)
                        for _ in range(cfg.n_layers)]
    params["final_norm"] = norm_init(cfg.d_model, dtype, device,
                                     cfg.norm == "layernorm")
    params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype, device,
                                scale=0.02)
    return params


def embed_tokens(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings, or ``batch["embeds"]`` (B, S, d_model) — the
    reference's stubbed modality frontend, ViT's patch embeddings — when
    given without tokens."""
    if batch.get("embeds") is not None:
        if batch.get("tokens") is not None:
            raise NotImplementedError(
                "embeds together with tokens (the VLM prefix) is not ported "
                "yet (ROADMAP.md)")
        return batch["embeds"]
    return params["embed"][batch["tokens"]]


def _apply_block(p, cfg: ModelConfig, x, *, positions, cache=None,
                 block_tables=None) -> torch.Tensor:
    """One layer, residuals included: an SSD block (``"ssd" in p``) or
    attention + MLP. A cache is updated in place."""
    if "ssd" in p:
        h, _ = SSM.ssd_block(p["ssd"], cfg, Lyr.rmsnorm(p["mix_norm"], x),
                             cache=cache)
        return x + h
    h, _ = Lyr.attention(p["attn"], cfg, Lyr.apply_norm(cfg, p["attn_norm"], x),
                         positions=positions, cache=cache,
                         block_tables=block_tables)
    x = x + h
    return x + Lyr.mlp(p["mlp"], cfg, Lyr.apply_norm(cfg, p["mlp_norm"], x))


def forward(params, cfg: ModelConfig, batch, *,
            caches: Optional[List[Dict]] = None,
            last_cols: Optional[torch.Tensor] = None):
    """Returns (logits, caches). ``batch``: tokens (B, S) or embeds (B, S,
    d_model) [+ positions (B, S), block_tables (B, n_blocks)]. ``caches``
    — from :func:`init_paged_caches` or :func:`init_caches`, updated in
    place — or None for self-attention over the batch (causal per the
    config; SSD blocks scan the batch from a zero state). ``last_cols``
    (B,) keeps only column ``last_cols[b]`` of each row before the final
    norm and head, so logits are (B, 1, vocab): the serving prefill reads
    just each row's last real token."""
    x = embed_tokens(params, cfg, batch)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    kw = dict(positions=positions, block_tables=batch.get("block_tables"))
    layers = params["layers"]
    L = len(layers)

    def cache(i):
        return None if caches is None else caches[i]

    for i, lp in enumerate(layers):
        x = _apply_block(lp, cfg, x, cache=cache(i), **kw)
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            # the hybrid's shared block closes each group; its caches
            # follow the L layer caches, one per group
            x = _apply_block(params["shared_attn"], cfg, x,
                             cache=cache(L + i // cfg.attn_every), **kw)
    if last_cols is not None:
        x = x[torch.arange(B, device=x.device), last_cols][:, None]
    x = Lyr.apply_norm(cfg, params["final_norm"], x)
    return api.linear(x, params["head"]), caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device) -> List[Dict]:
    """Decoder caches, one per layer: a contiguous (batch, max_len) KV cache
    (``layers.init_attention_cache``) for an attention layer, the conv and
    SSD states (``ssm.init_ssd_cache``) for an SSD layer. A hybrid's list
    holds its SSD layers' caches, then one KV cache per group for the
    shared attention block (the reference's ``{"scan": (ssm, attn)}``)."""
    check_supported(cfg)
    if cfg.family in ("bert", "vit"):
        raise ValueError(f"{cfg.name}: KV caches serve the decoder families; "
                         f"family {cfg.family!r} is an encoder")
    dtype = torch_dtype(dtype)
    if cfg.family == "dense":
        return [Lyr.init_attention_cache(cfg, batch, max_len, dtype, device)
                for _ in range(cfg.n_layers)]
    caches = [SSM.init_ssd_cache(cfg, batch, dtype, device)
              for _ in range(cfg.n_layers)]
    n_groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return caches + [Lyr.init_attention_cache(cfg, batch, max_len, dtype,
                                              device)
                     for _ in range(n_groups)]


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, dtype, device,
                      kv_dtype=None) -> List[Dict]:
    """One paged KV cache per layer (``layers.init_paged_attention_cache``);
    one (batch, n_blocks) block table addresses every layer's pool.
    ``kv_dtype="int8"`` stores every pool int8 with per-page-per-head fp32
    scales. Pure attention stacks only: SSD and conv state has no
    positions to page."""
    check_supported(cfg)
    if cfg.family in SSD_FAMILIES:
        raise NotImplementedError(
            f"paged KV caches require pure-attention layer stacks; family="
            f"{cfg.family!r} attn_every={cfg.attn_every} carries SSD "
            f"recurrent state (docs/serving.md)")
    return [Lyr.init_paged_attention_cache(cfg, batch, n_pages, page_size,
                                           torch_dtype(dtype), device,
                                           kv_dtype=kv_dtype)
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# BERT / ViT (the paper's own evaluation models)
# ---------------------------------------------------------------------------

def bert_config(variant: str) -> ModelConfig:
    dims = {"medium": (8, 512, 8), "base": (12, 768, 12),
            "large": (24, 1024, 16)}[variant]
    L, d, h = dims
    return ModelConfig(
        name=f"bert-{variant}", family="bert", n_layers=L, d_model=d,
        n_heads=h, n_kv_heads=h, d_ff=4 * d, vocab=30522, causal=False,
        mlp_act="gelu", norm="layernorm", source="arXiv:1810.04805")


def vit_config(variant: str) -> ModelConfig:
    dims = {"base": (12, 768, 12, 197), "large": (24, 1024, 16, 197),
            "huge": (32, 1280, 16, 257)}[variant]
    L, d, h, seq = dims
    return ModelConfig(
        name=f"vit-{variant}", family="vit", n_layers=L, d_model=d,
        n_heads=h, n_kv_heads=h, d_ff=4 * d, vocab=1000, causal=False,
        mlp_act="gelu", norm="layernorm", source="arXiv:2010.11929")


def encoder_forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """BERT/ViT: the bidirectional encoder over the whole batch (no cache);
    ViT consumes stubbed patch embeddings (``batch["embeds"]``). Returns
    logits (B, S, vocab) — the head runs over every position."""
    logits, _ = forward(params, cfg, batch)
    return logits
