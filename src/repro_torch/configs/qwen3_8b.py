"""Qwen3-8B — dense GQA with qk_norm [hf:Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12288 vocab=151936.
Same values as ``repro/configs/qwen3_8b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    sharding_overrides=(("kv_heads", None),),  # kv=8 < TP=16
    source="hf:Qwen/Qwen3-8B; hf",
)
