"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, ssm_state=64; one weight-shared attention+
MLP block (32H MHA, d_ff=10240) applied every 6 SSM blocks. Same values
as ``repro/configs/zamba2_2_7b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    source="arXiv:2411.15242; hf",
)
