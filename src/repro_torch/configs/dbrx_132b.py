"""DBRX 132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8, head_dim 128) expert d_ff=10752
vocab=100352. Same values as ``repro/configs/dbrx_132b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    n_experts_active=4,
    moe_d_ff=10752,
    mlp_act="swiglu",
    rope_theta=5e5,
    # kv=8 heads not divisible by TP=16 → replicate KV projections
    sharding_overrides=(("kv_heads", None),),
    source="hf:databricks/dbrx-base; unverified",
)
