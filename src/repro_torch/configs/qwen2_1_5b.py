"""Qwen2-1.5B — GQA with QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2, head_dim 128) d_ff=8960 vocab=151936.
Same values as ``repro/configs/qwen2_1_5b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    sharding_overrides=(("heads", None), ("kv_heads", None)),
    source="arXiv:2407.10671; hf",
)
