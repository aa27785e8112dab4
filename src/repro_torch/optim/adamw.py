"""AdamW with fp32 moments and optional int8 gradient compression with
error feedback (``repro/optim/adamw.py``), over nested dicts and lists of
tensors.

The reference shards the moments like their parameters (ZeRO over its
mesh). Here each moment lives beside its parameter: on a mesh a rank
runs AdamW on its cut of each param (``launch/steps.py::rank_params``),
and ``adamw_init`` of the cuts gives moments cut the same way. The update
is computed in fp32 and cast back to the parameter's dtype; decoupled
weight decay applies to matrices only, by the whole leaf's rank (two or
more dims): a cut keeps every dim of its leaf, so a shard decays as its
leaf does. The port keeps its layers unstacked, so a
layer's norm scale is 1-D here and takes no decay, where the reference's
stacked (n_layers, d) scale does (ROADMAP.md, reference caveats).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False  # int8 gradients with error feedback


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples of
    tensors) and the matching leaves of ``rest``; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in the reference's order (``jax.tree_util``: dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def adamw_init(params):
    """{"mu", "nu": fp32 zeros like every parameter, "step": int32 0}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


def quantize_int8(g: torch.Tensor, err: Optional[torch.Tensor] = None,
                  amax: Optional[torch.Tensor] = None):
    """Symmetric per-tensor int8 quantization with error feedback: returns
    (the dequantized gradient, the new error). ``amax`` is the whole
    tensor's max |g + err| where ``g`` is a rank's cut of it (default:
    ``g``'s own), so the cut takes the whole tensor's scale."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    if amax is None:
        amax = gf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def adamw_update(params, grads, state, cfg: AdamWConfig, lr,
                 err_state=None, *, gnorm: Optional[torch.Tensor] = None,
                 amax=None):
    """One AdamW step. Returns (new_params, new_state, metrics, new_err);
    nothing is updated in place. ``gnorm`` is the global gradient norm
    the clip divides by, and ``amax`` (a tree like ``grads`` of 0-d
    tensors) each whole gradient's amax that compression scales by, when
    the caller computes them (a rank that holds slices of the params:
    ``launch/steps.py``); default, those of ``grads``."""
    if gnorm is None:
        gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    new_err = err_state
    if cfg.compress_grads:
        if err_state is None:
            err_state = tree_map(lambda g: torch.zeros(
                g.shape, dtype=torch.float32, device=g.device), grads)
        pairs = tree_map(quantize_int8, grads, err_state) if amax is None \
            else tree_map(quantize_int8, grads, err_state, amax)
        grads, new_err = _pick(pairs, 0), _pick(pairs, 1)

    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def upd(p, g, mu, nu):
        # the reference's arithmetic, op for op; the in-place ops write
        # only tensors made here, so at most three of a leaf's size live
        g = g.float() * clip
        mu = (cfg.b1 * mu).add_((1 - cfg.b1) * g)
        nu = (cfg.b2 * nu).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:   # matrices only; a cut has its whole leaf's dims
            delta.add_(cfg.weight_decay * p.float())
        return (p.float() - delta.mul_(lr)).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": _pick(out, 1), "nu": _pick(out, 2), "step": step}
    return _pick(out, 0), new_state, {"grad_norm": gnorm}, new_err


def _pick(tree, i: int):
    """Element ``i`` of every tuple leaf of ``tree`` (a tree_map's output
    of tuples; the containers are dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
