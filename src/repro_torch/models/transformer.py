"""Model assembly for every family of the JAX registry
(``repro/models/transformer.py``): the dense decoders, MoE (dbrx; with MLA
and a leading dense layer, deepseek-v2), the VLM (image embeddings ⊕
text), audio (summed per-codebook embeddings, a head per codebook),
Mamba-2 (``ssm``), Zamba-2 (``hybrid``) and the BERT/ViT encoders: init,
token embedding, forward over paged or contiguous caches or none, and
``encoder_forward``.

Layers are a Python loop over per-layer parameter dicts (the JAX package
stacks them and scans). ``first_dense_layers`` leading layers
(``dense_layer{i}``, with an MLP in place of the experts) run before the
stack, and their caches come first in the cache list. A hybrid applies its
one weight-shared attention block after every ``attn_every`` SSD layers.

Training: ``forward`` returns the MoE load-balance loss summed over the
layers, and ``lm_loss`` the reference's next-token loss. With ``cfg.remat``
each block of a cache-less forward under autograd runs through
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` per scanned
layer): its activations are recomputed in the backward pass, which
changes memory, never a value. Under an FSDP context
(``distributed/fsdp.py``) each block gathers its leaves inside the block's
function, so remat frees them after the forward and gathers them again in
the recompute; the embedding table, the final norm and the head are
gathered where they are used. Under a model axis the loss is
vocab-parallel: the logits stay the rank's vocab columns, as the
reference keeps them sharded over ``act_vocab``.

Sequence parallelism: where the rules cut the residual stream's sequence
over the model axis (``act_seq``, ``tp.seq_parallel``), a cache-less
forward holds the rank's contiguous 1/mp of the sequence between blocks —
the embedding's output, every block's output (which remat saves), the
final norm's input — and gathers the rows whole before the head, whose
logits keep the sequence whole as the reference's spec does. A serving
step whose sequence the rules would cut raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import api
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed import tp as TP
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.module import dense_init, embed_init, norm_init

# What each ported family is: (norm, mlp_acts, causal). The encoders are
# the reference's BERT/ViT: LayerNorm, GELU MLP with biases, bidirectional.
# A dense decoder's MLP is SwiGLU, or (granite-20b) the biased GELU MLP
# the encoders use; audio (musicgen) takes the encoders' norm and MLP,
# causal. moe layers hold the experts (their own SwiGLU) in place of the
# MLP. ssm layers are SSD blocks; hybrid adds the shared attention + MLP
# block.
_FAMILIES = {"dense": ("rmsnorm", ("swiglu", "gelu"), True),
             "moe": ("rmsnorm", ("swiglu",), True),
             "vlm": ("rmsnorm", ("swiglu",), True),
             "audio": ("layernorm", ("gelu",), True),
             "ssm": ("rmsnorm", ("swiglu",), True),
             "hybrid": ("rmsnorm", ("swiglu",), True),
             "bert": ("layernorm", ("gelu",), False),
             "vit": ("layernorm", ("gelu",), False)}
SSD_FAMILIES = ("ssm", "hybrid")
ENCODER_FAMILIES = ("bert", "vit")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config outside the ported families
    (``_FAMILIES``): every config of the registry passes. Refused: an
    unknown family, a norm, MLP or causality its family does not take
    (``gelu_glu`` among them), MLA, MoE or ``first_dense_layers`` in an
    SSD family or an encoder, SSM state outside the SSD families,
    ``attn_every`` outside the hybrid, ``n_codebooks`` outside audio, a GQA
    encoder, and tied embeddings."""
    norm, acts, causal = _FAMILIES.get(cfg.family, (None, None, None))
    ssd = cfg.family in SSD_FAMILIES
    plain = ssd or cfg.family in ENCODER_FAMILIES
    unsupported = {
        "family": cfg.family not in _FAMILIES,
        "MLA in an SSD family or an encoder": cfg.is_mla and plain,
        "MoE in an SSD family or an encoder": cfg.is_moe and plain,
        "first_dense_layers in an SSD family or an encoder":
            bool(cfg.first_dense_layers) and plain,
        "SSM outside the ssm/hybrid families": bool(cfg.ssm_state) != ssd,
        "attn_every outside the hybrid family":
            bool(cfg.attn_every) != (cfg.family == "hybrid"),
        "n_layers not a multiple of attn_every":
            bool(cfg.attn_every) and cfg.n_layers % cfg.attn_every != 0,
        "norm": norm is not None and cfg.norm != norm,
        "mlp_act": acts is not None and cfg.mlp_act not in acts,
        "causal": causal is not None and cfg.causal != causal,
        "GQA encoder": cfg.family in ENCODER_FAMILIES
        and cfg.n_kv_heads != cfg.n_heads,
        "n_codebooks outside the audio family":
            bool(cfg.n_codebooks) != (cfg.family == "audio"),
        "tie_embeddings": cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported; the port covers the "
            f"configurations of the JAX registry and the BERT/ViT encoders "
            f"(ROADMAP.md)")


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of a leading dense layer: the experts off."""
    return dataclasses.replace(cfg, n_experts=0)


def _init_block(gen, cfg: ModelConfig, dtype, device, kind: str = "attn"):
    if kind == "ssd":
        return {"mix_norm": norm_init(cfg.d_model, dtype, device),
                "ssd": SSM.init_ssd(gen, cfg, dtype, device)}
    bias = cfg.norm == "layernorm"
    attn = Lyr.init_mla if cfg.is_mla else Lyr.init_attention
    p = {"attn_norm": norm_init(cfg.d_model, dtype, device, bias),
         "attn": attn(gen, cfg, dtype, device),
         "mlp_norm": norm_init(cfg.d_model, dtype, device, bias)}
    if cfg.is_moe:
        p["moe"] = Lyr.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = Lyr.init_mlp(gen, cfg, dtype, device)
    return p


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: Union[str, torch.device] = "cuda",
               draw_device: Union[str, torch.device] = "cpu") -> Dict:
    """Random weights with the reference's shapes and scales, drawn from
    ``torch.Generator(draw_device).manual_seed(seed)`` and placed on
    ``device``. Drawn on the CPU (the default) they are the same values on
    every device; drawn on the card (``draw_device="cuda"``) they are
    other values, made without the host draw that takes minutes for a
    model of billions of parameters."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.param_dtype
    gen = torch.Generator(resolve_device(draw_device)).manual_seed(seed)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)}
    if cfg.n_codebooks:        # musicgen: one table per codebook (the plain
        # "embed" is carried unused, as in the reference's tree)
        params["embed_cb"] = torch.stack([
            embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
            for _ in range(cfg.n_codebooks)])
    for i in range(cfg.first_dense_layers):
        params[f"dense_layer{i}"] = _init_block(gen, _dense_cfg(cfg), dtype,
                                                device)
    if cfg.attn_every:         # zamba-style hybrid: the shared attention block
        params["shared_attn"] = _init_block(gen, cfg, dtype, device)
    kind = "ssd" if cfg.family in SSD_FAMILIES else "attn"
    params["layers"] = [_init_block(gen, cfg, dtype, device, kind)
                        for _ in range(cfg.n_layers - cfg.first_dense_layers)]
    params["final_norm"] = norm_init(cfg.d_model, dtype, device,
                                     cfg.norm == "layernorm")
    params["head"] = dense_init(gen, cfg.d_model,
                                cfg.vocab * max(cfg.n_codebooks, 1), dtype,
                                device, scale=0.02)
    return params


def seq_columns(batch) -> int:
    """The columns of a batch's sequence: its tokens', its embeddings',
    or (vlm) both."""
    embeds, tokens = batch.get("embeds"), batch.get("tokens")
    return (0 if embeds is None else embeds.shape[1]) + \
        (0 if tokens is None else tokens.shape[1])


def embed_tokens(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings; ``batch["embeds"]`` (B, S_e, d_model) — the
    reference's stubbed modality frontend: ViT's patch embeddings alone,
    the VLM's image embeddings followed by the text tokens' (S_e + S
    columns); for (B, S, n_codebooks) tokens (audio) the per-codebook
    embeddings summed. Under sequence parallelism, the rank's rows of
    them."""
    embeds, tokens = batch.get("embeds"), batch.get("tokens")
    if embeds is not None and tokens is None:
        return TP.rows(embeds)
    if cfg.n_codebooks:
        table = FSDP.gathered(params["embed_cb"], "embed_cb")
        return TP.rows(sum(table[c][tokens[..., c]]
                           for c in range(cfg.n_codebooks)))
    # vlm: img ⊕ text
    return TP.embed(FSDP.gathered(params["embed"], "embed"), tokens,
                    vocab=cfg.vocab, prefix=embeds)


def _apply_block(p, cfg: ModelConfig, x, *, positions, cache=None,
                 block_tables=None):
    """One layer, residuals included: an SSD block (``"ssd" in p``) or
    attention (GQA, or MLA) + MLP (or the experts). Returns (x, the
    experts' load-balance loss, or None without experts). A cache is
    updated in place."""
    if "ssd" in p:
        h, _ = SSM.ssd_block(p["ssd"], cfg, Lyr.rmsnorm(p["mix_norm"], x),
                             cache=cache)
        return x + h, None
    attn = Lyr.mla_attention if cfg.is_mla else Lyr.attention
    h, _ = attn(p["attn"], cfg, Lyr.apply_norm(cfg, p["attn_norm"], x),
                positions=positions, cache=cache, block_tables=block_tables)
    x = x + h
    h = Lyr.apply_norm(cfg, p["mlp_norm"], x)
    if "moe" in p:
        y, aux = Lyr.moe(p["moe"], cfg, h)
        return x + y, aux
    return x + Lyr.mlp(p["mlp"], cfg, h), None


def _use_remat(cfg: ModelConfig, caches) -> bool:
    """Whether blocks recompute their activations in the backward pass:
    ``cfg.remat`` unless ``remat_policy`` is "none", and only for a
    cache-less forward under autograd (a serving step has no backward).
    ``"full"`` recomputes the whole block; ``"dots"`` (the reference's
    ``checkpoint_dots``) recomputes it with every product's output kept
    from the forward (``api.SavedDots``): no GEMM runs in the recompute."""
    if not cfg.remat or cfg.remat_policy == "none" or caches is not None \
            or not torch.is_grad_enabled():
        return False
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: 'full', "
                         f"'dots' or 'none'")
    return True


def forward(params, cfg: ModelConfig, batch, *,
            caches: Optional[List[Dict]] = None,
            last_cols: Optional[torch.Tensor] = None,
            gather_logits: bool = True):
    """Returns (logits, caches, aux). ``batch``: tokens (B, S), (B, S,
    n_codebooks) for audio, or embeds (B, S, d_model), or (vlm) embeds (B,
    S_e, d_model) and tokens (B, S) for S_e + S columns [+ positions and
    block_tables (B, n_blocks) over all columns]. ``caches`` — from
    :func:`init_paged_caches` or :func:`init_caches`, updated in place —
    or None for self-attention over the batch (causal per the config; SSD
    blocks scan the batch from a zero state). ``last_cols`` (B,) keeps only
    column ``last_cols[b]`` of each row before the final norm and head, so
    logits are (B, 1, vocab): the serving prefill reads just each row's
    last real token. Audio logits are (B, S, n_codebooks, vocab). ``aux``
    is the experts' load-balance loss summed over the layers (fp32, 0
    without experts; a hybrid's shared block adds none, as in the
    reference). ``cfg.remat`` recomputes each block in the backward pass
    (:func:`_use_remat`). Under a model axis the vocab-parallel head's
    logits are gathered whole for sampling; ``gather_logits=False`` keeps
    the rank's vocab columns (:func:`lm_loss`). Under sequence
    parallelism (:func:`seq_parallel`) the blocks run on the rank's rows."""
    ctx = TP.current_tp()
    if seq_parallel(cfg, batch):
        if caches is not None:
            raise NotImplementedError(
                "act_seq -> model would cut a serving step's sequence over "
                "the model axis; sequence parallelism is ported for "
                "training and cache-less forwards (decode's one column "
                "stays whole)")
        ctx = TP.with_seq_parallel(ctx)
    with TP.use_tp(ctx):
        return _forward(params, cfg, batch, caches, last_cols, gather_logits)


def seq_parallel(cfg: ModelConfig, batch) -> bool:
    """Whether the active rules cut ``batch``'s residual stream over the
    model axis (``tp.seq_parallel`` of its columns)."""
    return TP.seq_parallel(TP.current_tp(), seq_columns(batch),
                           D=cfg.d_model)


def _forward(params, cfg: ModelConfig, batch, caches, last_cols,
             gather_logits):
    x = embed_tokens(params, cfg, batch)
    B, S = x.shape[0], seq_columns(batch)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    kw = dict(positions=positions, block_tables=batch.get("block_tables"))
    layers = params["layers"]
    nd = cfg.first_dense_layers
    L = nd + len(layers)
    use_remat = _use_remat(cfg, caches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    gemm, attn = api.current_policy(), api.current_attention_policy()
    tpctx, fsctx = TP.current_tp(), FSDP.current_fsdp()

    def apply(p, path, c, x_, cache):
        # the block's leaves gathered over data inside the block's function
        return _apply_block(FSDP.gathered(p, *path), c, x_, cache=cache,
                            **kw)

    def recompute(p, path, c, cache):
        # the backward pass (and so the recompute) may run on autograd's
        # device thread, where the thread-local policies and contexts are
        # the defaults; under "dots" the block's record of its products
        # lives here, one a call of the block
        dots = api.SavedDots() if cfg.remat_policy == "dots" else None

        def run(x_):
            with api.use_policy(gemm), api.use_attention_policy(attn), \
                    TP.use_tp(tpctx), FSDP.use_fsdp(fsctx), \
                    api.saving_dots(dots):
                return apply(p, path, c, x_, cache)
        return run

    def block(path, c, x, cache):
        p = params
        for k in path:
            p = p[k]
        if use_remat:
            return checkpoint(recompute(p, path, c, cache), x,
                              use_reentrant=False)
        return apply(p, path, c, x, cache)

    def cache(i):
        return None if caches is None else caches[i]

    for i in range(nd):                # deepseek's leading dense layers
        x, _ = block((f"dense_layer{i}",), _dense_cfg(cfg), x, cache(i))
    for i in range(len(layers)):
        x, aux_i = block(("layers", i), cfg, x, cache(nd + i))
        if aux_i is not None:
            aux = aux + aux_i
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            # the hybrid's shared block closes each group; its caches
            # follow the L layer caches, one per group
            x, _ = block(("shared_attn",), cfg, x,
                         cache(L + i // cfg.attn_every))
    final_norm = FSDP.gathered(params["final_norm"], "final_norm")
    if last_cols is not None:
        x = TP.seq_gather(x)[torch.arange(B, device=x.device),
                             last_cols][:, None]
        x = Lyr.apply_norm(cfg, final_norm, x)
    else:        # the rank's rows normed, then the whole sequence (SP)
        x = TP.seq_gather(Lyr.apply_norm(cfg, final_norm, x))
    # vocab-column-parallel under TP, gathered whole for sampling
    logits = TP.linear(x, FSDP.gathered(params["head"], "head"),
                       axes=("embed", "vocab"),
                       full=(cfg.d_model, cfg.vocab * max(cfg.n_codebooks, 1)),
                       gather_out=gather_logits)
    if cfg.n_codebooks:
        logits = logits.reshape(*x.shape[:2], cfg.n_codebooks, cfg.vocab)
    return logits, caches, aux


def vocab_parallel(cfg: ModelConfig) -> bool:
    """Whether :func:`lm_loss` takes the vocab-parallel loss under the
    active TP context: the head's vocab columns are cut over the model
    axis, each rank's a whole vocab slice (not so for the audio family's
    ``vocab × n_codebooks`` head, whose loss gathers its logits)."""
    ctx = TP.current_tp()
    return (ctx is not None and ctx.model_size > 1 and not cfg.n_codebooks
            and TP.param_cut(ctx, ("embed", "vocab"),
                             (cfg.d_model, cfg.vocab)) is not None)


def lm_loss(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01):
    """The reference's training loss (``transformer.lm_loss``): the mean
    next-token cross-entropy in fp32, plus ``aux_weight`` times the experts'
    load-balance loss. Audio predicts every codebook of the next frame;
    the VLM's image-embedding columns predict nothing; explicit
    ``batch["labels"]`` label every text column. Under a model axis the
    cross-entropy is vocab-parallel (:func:`vocab_parallel`,
    ``tp.vocab_parallel_nll``). Under sequence parallelism a loss that is
    not vocab-parallel sums each rank's own rows and then the ranks' sums
    (``tp.row_mask``), so each rank's gradient reaches its rows alone, as
    a block's gradients are each rank's share. Returns (loss, {"ce",
    "aux"})."""
    sharded = vocab_parallel(cfg)
    own = None
    if not sharded and seq_parallel(cfg, batch):
        own = TP.row_mask(seq_columns(batch), batch["tokens"].device)
    logits, _, aux = forward(params, cfg, batch, gather_logits=not sharded)
    tokens = batch["tokens"]
    if cfg.n_codebooks:
        labels = tokens[:, 1:, :]
        lg = logits[:, :-1]
    else:
        labels = batch.get("labels")
        # vlm: image embeds occupy the first positions; only text predicts
        n_img = (batch["embeds"].shape[1]
                 if batch.get("embeds") is not None else 0)
        if labels is None:
            labels = tokens[:, 1:]
            lg = logits[:, n_img:-1]
            own = None if own is None else own[n_img:-1]
        else:
            lg = logits[:, n_img:]
            own = None if own is None else own[n_img:]
    if cfg.n_codebooks and own is not None:
        own = own[:-1, None]                  # (S - 1, 1) over codebooks
    if sharded:
        nll = TP.vocab_parallel_nll(lg, labels)
    else:
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])
    if own is None:
        loss = torch.mean(nll)
    else:
        loss = TP.sum_over_ranks(torch.where(own[..., None], nll,
                                             torch.zeros_like(nll)).sum()) \
            / nll.numel()
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _rank_kv_cfg(cfg: ModelConfig, tpctx) -> ModelConfig:
    """The config whose ``n_kv_heads`` is what this rank's caches hold:
    its slice of the KV heads when ``tp.head_sharding`` shards them."""
    _, shard_kv = TP.head_sharding(tpctx, cfg.n_heads, cfg.n_kv_heads)
    if not shard_kv:
        return cfg
    return dataclasses.replace(
        cfg, n_kv_heads=cfg.n_kv_heads // tpctx.model_size)


def cache_leaf(cfg: ModelConfig, batch: int, max_len: int):
    """(name, the reference's global shape) of the leaf that holds a
    decoder's contiguous cache columns: MLA's latent ``ckv`` (batch,
    max_len, kv_lora_rank), else ``k`` (batch, max_len, n_kv_heads,
    head_dim)."""
    if cfg.is_mla:
        return "ckv", (batch, max_len, cfg.kv_lora_rank)
    return "k", (batch, max_len, cfg.n_kv_heads, cfg.head_dim)


def cache_seq_cut(cfg: ModelConfig, batch: int, max_len: int, tpctx):
    """``tp.seq_cut`` of a decoder's contiguous cache (:func:`cache_leaf`)
    under the TP context ``tpctx``."""
    return TP.seq_cut(tpctx, *cache_leaf(cfg, batch, max_len))


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device, tpctx=None) -> List[Dict]:
    """Decoder caches, one per layer: a contiguous (batch, max_len) KV cache
    (``layers.init_attention_cache``) for an attention layer, the latent
    cache (``layers.init_mla_cache``) for an MLA layer, the conv and SSD
    states (``ssm.init_ssd_cache``) for an SSD layer. Leading dense layers'
    caches come first (the reference's ``"dense"``, then ``"scan"``). A
    hybrid's list holds its SSD layers' caches, then one KV cache per group
    for the shared attention block (the reference's ``{"scan": (ssm,
    attn)}``). Under a TP context (``tpctx``) KV caches hold the rank's
    KV heads and, where the context's cache rules cut their sequence
    (``act_kv_seq``; ``tp.seq_cut``, from the reference's (batch, max_len,
    n_kv_heads, head_dim); MLA's latent from ``ckv``'s (batch, max_len,
    kv_lora_rank): :func:`cache_seq_cut`), the rank's columns."""
    check_supported(cfg)
    if cfg.family in ENCODER_FAMILIES:
        raise ValueError(f"{cfg.name}: KV caches serve the decoder families; "
                         f"family {cfg.family!r} is an encoder")
    dtype = torch_dtype(dtype)
    kv_cfg = _rank_kv_cfg(cfg, tpctx)
    cut = cache_seq_cut(cfg, batch, max_len, tpctx)
    if cfg.is_mla:
        return [Lyr.init_mla_cache(cfg, batch, max_len, dtype, device,
                                   seq_cut=cut)
                for _ in range(cfg.n_layers)]

    def kv_cache():
        return Lyr.init_attention_cache(kv_cfg, batch, max_len, dtype,
                                        device, seq_cut=cut)
    if cfg.family not in SSD_FAMILIES:
        return [kv_cache() for _ in range(cfg.n_layers)]
    caches = [SSM.init_ssd_cache(cfg, batch, dtype, device)
              for _ in range(cfg.n_layers)]
    n_groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return caches + [kv_cache() for _ in range(n_groups)]


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, dtype, device,
                      kv_dtype=None, tpctx=None) -> List[Dict]:
    """One paged KV cache per layer (``layers.init_paged_attention_cache``);
    one (batch, n_blocks) block table addresses every layer's pool.
    ``kv_dtype="int8"`` stores every pool int8 with per-page-per-head fp32
    scales. GQA attention stacks only: SSD and conv state has no
    positions to page, and the MLA latent cache stays contiguous. Under a
    TP context (``tpctx``) the pools and scales hold the rank's KV
    heads."""
    check_supported(cfg)
    if cfg.family in SSD_FAMILIES:
        raise NotImplementedError(
            f"paged KV caches require pure-attention layer stacks; family="
            f"{cfg.family!r} attn_every={cfg.attn_every} carries SSD "
            f"recurrent state (docs/serving.md)")
    if cfg.is_mla:
        raise NotImplementedError(
            "paged KV caches cover GQA attention; the MLA latent cache "
            "stays contiguous (docs/serving.md)")
    kv_cfg = _rank_kv_cfg(cfg, tpctx)
    return [Lyr.init_paged_attention_cache(kv_cfg, batch, n_pages, page_size,
                                           torch_dtype(dtype), device,
                                           kv_dtype=kv_dtype)
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# BERT / ViT (the paper's own evaluation models)
# ---------------------------------------------------------------------------

def bert_config(variant: str) -> ModelConfig:
    dims = {"medium": (8, 512, 8), "base": (12, 768, 12),
            "large": (24, 1024, 16)}[variant]
    L, d, h = dims
    return ModelConfig(
        name=f"bert-{variant}", family="bert", n_layers=L, d_model=d,
        n_heads=h, n_kv_heads=h, d_ff=4 * d, vocab=30522, causal=False,
        mlp_act="gelu", norm="layernorm", source="arXiv:1810.04805")


def vit_config(variant: str) -> ModelConfig:
    dims = {"base": (12, 768, 12, 197), "large": (24, 1024, 16, 197),
            "huge": (32, 1280, 16, 257)}[variant]
    L, d, h, seq = dims
    return ModelConfig(
        name=f"vit-{variant}", family="vit", n_layers=L, d_model=d,
        n_heads=h, n_kv_heads=h, d_ff=4 * d, vocab=1000, causal=False,
        mlp_act="gelu", norm="layernorm", source="arXiv:2010.11929")


def encoder_forward(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """BERT/ViT: the bidirectional encoder over the whole batch (no cache);
    ViT consumes stubbed patch embeddings (``batch["embeds"]``). Returns
    logits (B, S, vocab) — the head runs over every position."""
    logits, _, _ = forward(params, cfg, batch)
    return logits
