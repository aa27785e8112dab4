"""The guard of the forward-only kernels (K2–K6).

The reference's Pallas kernels have no backward (no ``custom_vjp``), and
neither have their CUDA counterparts here. A wrapper that wrote its result
into a fresh tensor while an input required a gradient would hand autograd
a tensor off the graph: the parameters upstream would get no gradient, and
training would go on silently wrong. So each forward-only wrapper calls
:func:`refuse_grad` first. Serving runs under ``torch.no_grad`` and never
trips it.

Training takes the paper's §4.4 split instead: every GEMM through K1,
which is its own backward (``core/api.py``), and attention through the
``unfused`` policy (``train/loop.py`` pins it).
"""
from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op over ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors, remedy: str = "") -> None:
    """Raise when grad mode is on and one of ``tensors`` requires grad."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel} is forward-only (no backward, as the reference's "
            f"Pallas kernel): train with AttentionPolicy(backend='unfused') "
            f"and a GemmPolicy without int8 weights, as train/loop.py's "
            f"Trainer pins them, or call it under torch.no_grad()"
            + (f"; {remedy}" if remedy else ""))
