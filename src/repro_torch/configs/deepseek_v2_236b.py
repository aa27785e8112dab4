"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434; hf].

60L d_model=5120 128H (MLA kv_lora=512; q/k head dim 128 nope + 64 rope,
v head dim 128) vocab=102400; 2 shared + 160 routed experts, top-6, expert
d_ff=1536; first layer dense (d_ff=12288). Same values as
``repro/configs/deepseek_v2_236b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,                 # dense first layer width
    vocab=102400,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_experts_active=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    mlp_act="swiglu",
    rope_theta=1e4,
    source="arXiv:2405.04434; hf",
)
