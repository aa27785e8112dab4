"""Abstract inputs for every (arch × shape) cell (``repro/launch/specs.py``):
tensors on the ``meta`` device — shapes and dtypes, no storage — in place
of the reference's ``ShapeDtypeStruct``. Their user is the dry run
(``launch/dryrun.py``), which runs each cell's step on them.

Modality frontends are stubs, as in the reference: musicgen gets 4-stream
token ids, internvl2 gets 256 precomputed patch embeddings.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.registry import ShapeCell
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_axes

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_specs(cfg: ModelConfig, batch: int, seq: int
                ) -> Dict[str, torch.Tensor]:
    if cfg.n_codebooks:
        return {"tokens": _spec((batch, seq, cfg.n_codebooks), torch.int32)}
    if cfg.family == "vlm":
        from repro_torch.configs.internvl2_76b import N_IMAGE_TOKENS
        n_img = min(N_IMAGE_TOKENS, max(seq // 2, 1))
        return {"tokens": _spec((batch, seq - n_img), torch.int32),
                "embeds": _spec((batch, n_img, cfg.d_model),
                                cfg.param_dtype)}
    if cfg.family == "vit":
        return {"embeds": _spec((batch, seq, cfg.d_model), cfg.param_dtype)}
    return {"tokens": _spec((batch, seq), torch.int32)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The cache list :func:`transformer.init_caches` makes, on ``meta``."""
    return T.init_caches(cfg, batch, max_len, cfg.param_dtype, META)


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict:
    """The kwargs of the step function of the cell's kind:

    train   → {"batch": {tokens, ...}}
    prefill → {"batch": {..., "positions"}, "caches": ...}
    decode  → {"tokens": (B, 1), "positions": (B, 1), "caches": ...}
    """
    B, S = shape.batch, shape.seq
    if shape.kind == "train":
        return {"batch": token_specs(cfg, B, S)}
    if shape.kind == "prefill":
        batch = dict(token_specs(cfg, B, S))
        batch["positions"] = _spec((B, S), torch.int32)
        return {"batch": batch, "caches": cache_specs(cfg, B, S)}
    if shape.kind == "decode":
        tok = ((B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1))
        return {"tokens": _spec(tok, torch.int32),
                "positions": _spec((B, 1), torch.int32),
                "caches": cache_specs(cfg, B, S)}
    raise ValueError(shape.kind)


def abstract_params_and_axes(cfg: ModelConfig):
    """(params on ``meta``, the logical-axes tree) with no allocation: the
    full config's params as shapes and dtypes, and ``param_axes``."""
    return T.init_model(cfg, device=META), param_axes(cfg)
