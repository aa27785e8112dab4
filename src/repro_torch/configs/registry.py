"""Architecture registry of the port: the configurations its model code
covers so far — the dense family, Mamba-2, the Zamba-2 hybrid and the
paper's BERT/ViT encoders.
Mirrors ``repro/configs/registry.py``; the other architectures of the JAX
registry are still to be ported (ROADMAP.md)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

__all__ = ["ARCHS", "get_config", "get_smoke_config", "reduced"]

ARCHS = {
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
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
            f"architecture {arch!r} is not ported yet (ported: "
            f"{sorted(ARCHS)}, bert-*, vit-*); see ROADMAP.md")
    return importlib.import_module(ARCHS[arch]).CONFIG


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
