"""LR schedules (``repro/optim/schedule.py``)."""
from __future__ import annotations

import math
from typing import Union

import torch


def cosine_schedule(step: Union[int, torch.Tensor], *, base_lr: float,
                    warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` at step ``warmup - 1`` (non-zero at step
    0: an lr-0 first step would waste the first batch), then a cosine decay
    to ``min_frac * base_lr`` at ``total``. Computed in fp32, as the
    reference; returns a 0-d fp32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
