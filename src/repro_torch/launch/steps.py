"""The optimizer step of the training launcher (``repro/launch/steps.py``:
``make_train_step_fn``). The reference's sharding trees for its meshes
are not ported (ROADMAP.md queue 1 item 9): the mesh here is one device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_map


def value_and_grad(loss_fn: Callable, params) -> Tuple[Tuple, Dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)`` for a tree of
    tensors: ((loss, metrics), grads), grads in the params' tree and
    dtypes; a parameter the loss does not reach gets zeros (the audio
    family's unused ``embed``), as in JAX."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(p)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda t: by_id[id(t)], p))


def make_train_step_fn(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                       total_steps: int = 10000, microbatches: int = 1):
    """One optimizer step: (params, opt_state, batch) → (params,
    opt_state, metrics). With ``microbatches`` > 1 the batch is split along
    its first dim and the gradients are summed in fp32 and averaged — the
    same math, the activations of one microbatch alive at a time. As in the
    reference, the schedule's warmup is fixed at 100 steps here (a
    reference caveat, ROADMAP.md), and the multi-microbatch metrics report
    ``aux`` as 0."""
    opt_cfg = opt_cfg or AdamWConfig()

    def grad_of(params, batch):
        return value_and_grad(lambda p: T.lm_loss(p, cfg, batch), params)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = grad_of(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                (loss_mb, _), g = grad_of(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + loss_mb
            scale = 1.0 / microbatches
            grads = tree_map(lambda g: g * scale, grads)
            loss = loss * scale
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        lr = cosine_schedule(opt_state["step"], base_lr=opt_cfg.lr,
                             warmup=100, total=total_steps)
        params, opt_state, om, _ = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step
