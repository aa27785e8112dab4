"""Architecture registry of the port: every configuration of the JAX
registry (``repro/configs/registry.py``) — the dense family (smollm-135m,
qwen2-1.5b, qwen3-8b, granite-20b), the MoE family (dbrx-132b, and
deepseek-v2-236b with MLA), internvl2-76b (vlm), musicgen-medium (audio),
Mamba-2 and the Zamba-2 hybrid — and the paper's BERT/ViT encoders."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig, reduced

__all__ = ["ARCHS", "get_config", "get_smoke_config", "reduced",
           "ShapeCell", "SHAPES", "cell_applicable", "all_cells"]

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


# ---------------------------------------------------------------------------
# Input-shape cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int           # train/prefill: sequence length; decode: KV context
    batch: int         # global batch


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# long_500k requires sub-quadratic sequence mixing: only SSM/hybrid archs
# run it; pure full-attention archs skip.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True


def all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if cell_applicable(cfg, shape):
                yield arch, shape
