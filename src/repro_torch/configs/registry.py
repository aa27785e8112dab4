"""Architecture registry of the port: every configuration of the JAX
registry (``repro/configs/registry.py``) — the dense family (smollm-135m,
qwen2-1.5b, qwen3-8b, granite-20b), the MoE family (dbrx-132b, and
deepseek-v2-236b with MLA), internvl2-76b (vlm), musicgen-medium (audio),
Mamba-2 and the Zamba-2 hybrid — and the paper's BERT/ViT encoders."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

__all__ = ["ARCHS", "get_config", "get_smoke_config", "reduced"]

ARCHS = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}


def get_config(arch: str) -> ModelConfig:
    """A registered architecture, or ``bert-{medium,base,large}`` /
    ``vit-{base,large,huge}`` (``models/transformer.py``)."""
    if arch.startswith("bert-") or arch.startswith("vit-"):
        from repro_torch.models import transformer as T
        kind, variant = arch.split("-", 1)
        return (T.bert_config if kind == "bert" else T.vit_config)(variant)
    if arch not in ARCHS:
        raise NotImplementedError(
            f"unknown architecture {arch!r} (registered: {sorted(ARCHS)}, "
            f"bert-*, vit-*)")
    return importlib.import_module(ARCHS[arch]).CONFIG


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
