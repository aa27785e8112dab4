"""repro_torch: the MatrixFlow system ported to PyTorch and CUDA (Hopper).

It mirrors the JAX package ``repro`` module for module and imports nothing
of it. Entry points default to ``device="cuda"`` and raise without a GPU
unless the caller asks for the CPU, where every kernel wrapper runs its
plain PyTorch version.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent
    (there is no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return dev
