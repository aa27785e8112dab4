"""The closed form of the collectives over the model axis of one
sequence-parallel train step (``act_seq -> model``), which
``tests/test_torch_seqpar.py`` holds the dry run to and ``chip_smoke.py``
phase 32 holds the card's ranks to. It imports torch and ``repro_torch``
only, never JAX or the JAX package.
"""
from __future__ import annotations

from repro_torch.distributed import tp as TP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves


def whole_leaf_bytes(cfg, data, mp):
    """fp32 bytes of a rank's leaves on (``data``, ``mp``) that the model
    axis does not cut: held alike with and without the model axis."""
    meta = T.init_model(cfg, device="meta")
    cut = ST.rank_params(cfg, meta, Mesh.abstract((data, mp),
                                                  ("data", "model")))
    alone = ST.rank_params(cfg, meta, Mesh.abstract((data, 1),
                                                    ("data", "model")))
    return sum(4 * a.numel() for a, b in zip(tree_leaves(cut),
                                             tree_leaves(alone))
               if a.shape == b.shape)


def closed_form(cfg, rows, seq, data, mp, act_bytes):
    """The collectives over model of one sequence-parallel train step of
    a dense decoder under remat "full" or "dots", at a rank of ``rows``
    rows of ``seq`` columns on (``data``, ``mp``) (s = seq / mp columns a
    rank):

      * a block gathers its normed input twice (attention, MLP), in the
        forward and again in remat's recompute; each row-parallel output
        (the MLP's down projection, and attention's when its heads are
        cut) reduce-scatters in the forward and again in the recompute
        but for the block's last (the recompute stops once it has every
        saved activation: torch's checkpoint early stop); backward, a
        reduce-scatter of each gather and an all-gather of each scatter;
      * the embedding's rows reduce-scatter, the final norm's all-gather
        before the head, and the backward of each;
      * all-reduces: three of the vocab-parallel loss over rows x (seq -
        1) fp32, the sum of the whole leaves' gradients
        (:func:`whole_leaf_bytes`) and the norm.

    Bytes as ``tp.collectives`` counts them: the gathered tensor, the
    rank's part of a scatter; activations ``act_bytes`` an element,
    partial sums and their gradients fp32. Returns {kind: (calls,
    bytes)}."""
    D, L = cfg.d_model, cfg.n_layers
    ctx = TP.make_context(Mesh.abstract((1, mp), ("data", "model")),
                          overrides=cfg.overrides_dict())
    heads_cut = TP.param_cut(ctx, ("heads", "embed"),
                             (cfg.n_heads * cfg.head_dim, D),
                             {"heads": cfg.n_heads}) is not None
    g, r = 2, 1 + heads_cut
    whole, part = rows * seq * D, rows * (seq // mp) * D
    return {"all_gather": (L * (2 * g + r) + 2,
                           L * (2 * g * whole * act_bytes + r * whole * 4)
                           + 2 * whole * act_bytes),
            "reduce_scatter": (L * (2 * r - 1 + g) + 2,
                               L * ((2 * r - 1) * part * 4
                                    + g * part * act_bytes)
                               + 2 * part * act_bytes),
            "all_reduce": (5, 3 * rows * (seq - 1) * 4 + 8
                           + whole_leaf_bytes(cfg, data, mp))}
