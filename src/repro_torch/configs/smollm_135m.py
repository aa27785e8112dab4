"""SmolLM-135M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152. Same values as
``repro/configs/smollm_135m.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    rope_theta=1e4,
    sharding_overrides=(("heads", None), ("kv_heads", None)),
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
