"""Weights from the JAX package: its param pytree, handed over as nested
dicts of numpy arrays, becomes the port's param dicts.

The JAX model stacks every layer's params on a leading axis
(``params["layers"]``, made by ``jax.vmap`` over the layer init); the port
keeps one dict per layer, so that axis is unstacked. numpy has no bfloat16
of its own: a bf16 array (the ``ml_dtypes`` dtype JAX hands numpy) travels
as its uint16 bit pattern and is viewed back as ``torch.bfloat16``, so the
conversion is bitwise.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported


def to_tensor(a: np.ndarray, device: Union[str, torch.device] = "cpu"
              ) -> torch.Tensor:
    """numpy → torch, bitwise; bf16 through its uint16 bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def from_jax_params(np_tree: Dict, cfg: ModelConfig, *,
                    device: Union[str, torch.device] = "cpu") -> Dict:
    """The port's params from the JAX params of a ported model, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives them. Every leaf
    is carried: the LayerNorm and GELU MLP biases, audio's per-codebook
    tables ``embed_cb`` (n_codebooks, vocab, d), the leading dense layers
    ``dense_layer{i}`` (unstacked in both), the MLA projections and norms,
    and the MoE router, shared experts and expert banks — (L, E, d_in,
    d_out) stacked in JAX, (E, d_in, d_out) a layer here."""
    check_supported(cfg)
    device = resolve_device(device)
    out = {k: _tree(v, lambda a: to_tensor(a, device))
           for k, v in np_tree.items() if k != "layers"}
    stacked = np_tree["layers"]
    out["layers"] = [_tree(stacked, lambda a, i=i: to_tensor(a[i], device))
                     for i in range(cfg.n_layers - cfg.first_dense_layers)]
    return out
