"""Parameter init helpers (``repro/models/module.py``): the same shapes and
scales, drawn from an explicit ``torch.Generator``.

Parameters are nested dicts of tensors. The numbers differ from the JAX
init for the same seed (``jax.random`` and torch's generator are different
streams); tests that compare the two convert the JAX params instead
(``repro_torch/convert.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale
    return w.to(dtype).to(device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32) * 0.02
    return w.to(dtype).to(device)


def norm_init(d: int, dtype: torch.dtype, device: torch.device,
              with_bias: bool = False):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p

