"""Architecture config schema, copied from ``repro/models/config.py``
without its ``jax.numpy`` import: ``dtype`` stays a string, and
:func:`torch_dtype` maps it to a ``torch.dtype`` where a tensor is made."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm | bert | vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # defaults to d_model // n_heads
    # attention flavor
    qk_norm: bool = False                 # qwen3
    qkv_bias: bool = False                # qwen2
    rope_theta: float = 1e4
    causal: bool = True                   # False → encoder (BERT/ViT)
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0                 # >0 enables MLA
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0             # top-k
    n_shared_experts: int = 0
    moe_d_ff: int = 0                     # per-expert hidden dim
    first_dense_layers: int = 0           # deepseek-v2: layer 0 is dense
    capacity_factor: float = 1.25
    # combine strategy: "gather" re-replicates the expert output buffer
    # over the model axis before the slot gather (simple, collective-heavy);
    # "local" masks the slot gather per expert shard and all-reduces the
    # (G,t,D)-sized result instead — §Perf H4
    moe_combine: str = "gather"
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0                    # >0 enables SSD mixer
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # hybrid (zamba2): shared attention block applied every k SSM blocks
    attn_every: int = 0
    # frontends (audio/vlm are stubs providing precomputed embeddings)
    n_codebooks: int = 0                  # musicgen EnCodec streams
    mlp_act: str = "swiglu"               # swiglu | gelu | gelu_glu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # distribution
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
    remat: bool = True
    # remat policy: "full" (recompute the whole block), "dots" (keep every
    # product's output — K1's, the torch backend's, the unfused
    # attention's einsums, the MoE banks' — and recompute the rest:
    # no GEMM in the recompute, a block's product outputs held until its
    # backward; models/transformer.py::_use_remat), "none" ≡ remat=False
    remat_policy: str = "full"
    # scan-over-layers keeps compile time flat in depth (production default).
    # The dry-run sets False: XLA's cost_analysis counts a while-loop body
    # ONCE regardless of trip count, so exact roofline accounting requires
    # unrolled layers (see DESIGN.md §Roofline-methodology).
    scan_layers: bool = True
    # provenance
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def param_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def d_inner(self) -> int:             # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def overrides_dict(self) -> Dict[str, Optional[str]]:
        return dict(self.sharding_overrides)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (a ``torch.dtype`` passes through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def reduced(cfg: ModelConfig, **kw) -> ModelConfig:
    """Smoke-test shrink: same family/topology, tiny dims."""
    shrink = dict(
        n_layers=4 if cfg.attn_every else min(cfg.n_layers, 2),
        d_model=128,
        n_heads=max(min(cfg.n_heads, 4), 1),
        n_kv_heads=max(min(cfg.n_kv_heads, 2), 1),
        d_ff=256,
        vocab=512,
        d_head=32,
    )
    if cfg.is_mla:
        shrink.update(kv_lora_rank=64, q_lora_rank=96, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32, d_head=None)
    if cfg.is_moe:
        shrink.update(n_experts=min(cfg.n_experts, 8),
                      n_experts_active=min(cfg.n_experts_active, 2),
                      moe_d_ff=64,
                      n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.ssm_state:
        shrink.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_every:
        shrink.update(attn_every=2)
    if cfg.n_kv_heads == cfg.n_heads:  # keep MHA archs MHA
        shrink["n_kv_heads"] = shrink["n_heads"]
    shrink.update(kw)
    return dataclasses.replace(cfg, **shrink)
