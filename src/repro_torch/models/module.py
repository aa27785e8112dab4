"""Parameter init helpers (``repro/models/module.py``): the same shapes and
scales, drawn from an explicit ``torch.Generator``.

Parameters are nested dicts of tensors, drawn on the generator's device.
On the ``meta`` device nothing is drawn: the params are shapes and dtypes
only (``launch/specs.py``).
The numbers differ from the JAX init for the same seed (``jax.random`` and
torch's generator are different streams); tests that compare the two
convert the JAX params instead (``repro_torch/convert.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = _normal(gen, (d_in, d_out), device) * scale
    return w.to(dtype).to(device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    w = _normal(gen, (vocab, d), device) * 0.02
    return w.to(dtype).to(device)


def norm_init(d: int, dtype: torch.dtype, device: torch.device,
              with_bias: bool = False):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p



# ---------------------------------------------------------------------------
# Logical axes (the reference's AxisLeaf trees)
# ---------------------------------------------------------------------------

class AxisLeaf(tuple):
    """A tuple of logical axis names: one per dim of the param it names.

    ``blocks`` (not part of the names, so a leaf equals the reference's)
    is how many equal blocks the last dim concatenates: 2 for SwiGLU's
    gate ‖ up projection, whose rank slice over a model axis takes the
    same columns of each block (``distributed/tp.py``)."""
    blocks = 1


def ax(*names: Optional[str], blocks: int = 1) -> AxisLeaf:
    leaf = AxisLeaf(names)
    leaf.blocks = blocks
    return leaf


def is_axis_leaf(x) -> bool:
    return isinstance(x, AxisLeaf)


def _norm_axes(with_bias: bool = False):
    a = {"scale": ax("embed")}
    if with_bias:
        a["bias"] = ax("embed")
    return a


def _attention_axes(cfg):
    a = {"wq": ax("embed", "heads"), "wk": ax("embed", "kv_heads"),
         "wv": ax("embed", "kv_heads"), "wo": ax("heads", "embed")}
    if cfg.qkv_bias:
        a.update(bq=ax("heads"), bk=ax("kv_heads"), bv=ax("kv_heads"))
    if cfg.qk_norm:
        a.update(q_norm=_norm_axes(), k_norm=_norm_axes())
    return a


def _mla_axes():
    return {"wq_a": ax("embed", "kv_lora"), "q_norm": _norm_axes(),
            "wq_b": ax("kv_lora", "heads"), "wkv_a": ax("embed", "kv_lora"),
            "kv_norm": _norm_axes(), "wkv_b": ax("kv_lora", "heads"),
            "wo": ax("heads", "embed")}


def _mlp_axes(cfg):
    glu = 2 if cfg.mlp_act == "swiglu" else 1
    a = {"wi": ax("embed", "mlp", blocks=glu), "wo": ax("mlp", "embed")}
    if cfg.mlp_act != "swiglu":
        a.update(bi=ax("mlp"), bo=ax("embed"))
    return a


def _moe_axes(cfg):
    f = cfg.moe_d_ff or cfg.d_ff
    a = {"router": ax("embed", None),
         "wi": ax("experts", "embed", None),
         "wo": ax("experts", "embed" if f == cfg.d_model else None, None)}
    if cfg.n_shared_experts:
        a["shared"] = _mlp_axes(cfg)
    return a


def _ssd_axes():
    return {"w_z": ax("embed", "mlp"), "w_x": ax("embed", "mlp"),
            "w_B": ax("embed", None), "w_C": ax("embed", None),
            "w_dt": ax("embed", None), "conv_x": ax("conv", "mlp"),
            "conv_b_x": ax("mlp"), "conv_B": ax("conv", None),
            "conv_b_B": ax(None), "conv_C": ax("conv", None),
            "conv_b_C": ax(None), "A_log": ax(None), "D": ax(None),
            "dt_bias": ax(None), "norm": _norm_axes(),
            "w_out": ax("mlp", "embed")}


def _block_axes(cfg, kind: str, moe_layer: bool):
    if kind == "ssd":
        return {"mix_norm": _norm_axes(), "ssd": _ssd_axes()}
    bias = cfg.norm == "layernorm"
    a = {"attn_norm": _norm_axes(bias),
         "attn": _mla_axes() if cfg.is_mla else _attention_axes(cfg),
         "mlp_norm": _norm_axes(bias)}
    if moe_layer:
        a["moe"] = _moe_axes(cfg)
    else:
        a["mlp"] = _mlp_axes(cfg)
    return a


def param_axes(cfg):
    """The logical axis names of every param of ``transformer.init_model``
    — the reference's ``axes`` tree (``repro/models/module.py`` AxisLeaf
    names) in the port's layout: ``layers`` is a list of per-layer trees,
    with no stacked ``layers`` axis. The sharding rules
    (``distributed/sharding.py``) map these names to mesh axes."""
    a = {"embed": ax("vocab", "embed")}
    if cfg.n_codebooks:
        a["embed_cb"] = ax(None, "vocab", "embed")
    for i in range(cfg.first_dense_layers):
        a[f"dense_layer{i}"] = _block_axes(cfg, "attn", moe_layer=False)
    if cfg.attn_every:
        a["shared_attn"] = _block_axes(cfg, "attn", moe_layer=False)
    kind = "ssd" if cfg.family in ("ssm", "hybrid") else "attn"
    a["layers"] = [_block_axes(cfg, kind, moe_layer=cfg.is_moe)
                   for _ in range(cfg.n_layers - cfg.first_dense_layers)]
    a["final_norm"] = _norm_axes(cfg.norm == "layernorm")
    a["head"] = ax("embed", "vocab")
    return a
