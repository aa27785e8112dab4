"""Mamba-2 1.3B — attention-free SSD [arXiv:2405.21060].

48L d_model=2048, ssm_state=128, expand=2 (d_inner=4096, 64 SSD heads).
Same values as ``repro/configs/mamba2_1_3b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,              # SSD heads = d_inner / head_dim
    n_kv_heads=64,
    d_ff=0,                  # attention-free, no FFN (SSD block only)
    vocab=50280,             # not divisible by 16 → vocab dim replicates
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2405.21060; unverified",
)
