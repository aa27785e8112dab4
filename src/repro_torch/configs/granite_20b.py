"""Granite-20B (code) — GPT-BigCode-style MQA [arXiv:2405.04324; hf].

52L d_model=6144 48H (MQA kv=1, head_dim 128) d_ff=24576 vocab=49152. GELU
MLP with biases (not GLU), per the GPT-BigCode lineage. Same values as
``repro/configs/granite_20b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e4,
    mlp_act="gelu",
    sharding_overrides=(("kv_heads", None),),  # MQA: single KV head replicated
    source="arXiv:2405.04324; hf",
)
