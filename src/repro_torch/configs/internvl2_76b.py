"""InternVL2-76B — InternViT frontend (stub) + InternLM2/Llama3-70B-class
backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=28672 vocab=128256. The
vision tower is a stub: a caller passes 256 precomputed patch embeddings
per image, already projected to d_model, and they are prepended to the
text tokens. Same values as ``repro/configs/internvl2_76b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=5e5,
    sharding_overrides=(("kv_heads", None),),
    source="arXiv:2404.16821; unverified",
)

N_IMAGE_TOKENS = 256
