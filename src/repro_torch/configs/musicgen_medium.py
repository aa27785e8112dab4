"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA, head_dim 64) d_ff=6144 vocab=2048 per codebook
x 4 codebooks. The EnCodec frontend is a stub: tokens are (B, S, 4) ids,
one stream a codebook; the model embeds each stream and sums them, and its
head gives (B, S, 4, vocab) logits. Same values as
``repro/configs/musicgen_medium.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    n_codebooks=4,
    mlp_act="gelu",
    norm="layernorm",
    # 24 heads not divisible by TP=16 → replicate head projections
    sharding_overrides=(("heads", None), ("kv_heads", None)),
    source="arXiv:2306.05284; hf",
)
