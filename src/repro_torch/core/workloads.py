"""Op-level workload extraction: model config → (GEMMs, elementwise ops).

Feeds core/sysmodel.py; the GEMM tags mirror the paper's Fig. 8 runtime
breakdown categories (QKV / scores / attn·V / proj / FF1 / FF2 / softmax /
layernorm / residual / transpose). A copy of ``repro/core/workloads.py``,
which imports nothing of JAX: the port keeps its own.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.sysmodel import Elementwise, Gemm, Workload


def transformer_workload(
    n_layers: int,
    d_model: int,
    n_heads: int,
    seq: int,
    d_ff: Optional[int] = None,
    n_kv_heads: Optional[int] = None,
    vocab: int = 0,
    batch: int = 1,
) -> Workload:
    """Encoder/decoder transformer forward pass as a GEMM + elementwise list."""
    d_ff = d_ff or 4 * d_model
    n_kv = n_kv_heads or n_heads
    dh = d_model // n_heads
    S = seq
    Lc = n_layers * batch
    gemms = (
        Gemm(S, d_model, d_model, count=Lc, tag="QKV"),                 # Q
        Gemm(S, d_model, n_kv * dh, count=2 * Lc, tag="QKV"),           # K,V
        Gemm(S, dh, S, count=Lc * n_heads, tag="scores"),               # QKᵀ
        Gemm(S, S, dh, count=Lc * n_heads, tag="attnV"),                # PV
        Gemm(S, d_model, d_model, count=Lc, tag="proj"),
        Gemm(S, d_model, d_ff, count=Lc, tag="FF1"),
        Gemm(S, d_ff, d_model, count=Lc, tag="FF2"),
    )
    if vocab:
        gemms = gemms + (Gemm(S, d_model, vocab, count=batch, tag="head"),)
    elems = (
        Elementwise(n_heads * S * S, count=Lc, tag="softmax"),
        Elementwise(S * d_model, count=2 * Lc, tag="layernorm"),
        Elementwise(S * d_model, count=2 * Lc, tag="residual"),
        Elementwise(S * d_model, count=2 * Lc, tag="transpose"),
        Elementwise(S * d_ff, count=Lc, tag="activation"),
    )
    if S % 16 != 0:
        # unaligned sequence (ViT 197/257): per-layer CPU block repack —
        # accelerator-only cost, see sysmodel.SystemConfig.repack_cyc_per_elem
        elems = elems + (Elementwise(S * d_model, count=Lc, tag="repack"),)
    return gemms, elems


# The paper's evaluated models (§4.1): BERT medium/base/large, ViT base/large/huge.
PAPER_MODELS = {
    "bert-medium": dict(n_layers=8, d_model=512, n_heads=8, seq=128),
    "bert-base": dict(n_layers=12, d_model=768, n_heads=12, seq=128),
    "bert-large": dict(n_layers=24, d_model=1024, n_heads=16, seq=128),
    "vit-base": dict(n_layers=12, d_model=768, n_heads=12, seq=197),
    "vit-large": dict(n_layers=24, d_model=1024, n_heads=16, seq=197),
    "vit-huge": dict(n_layers=32, d_model=1280, n_heads=16, seq=257),
}

# Paper Table 3 (speedup vs single-thread CPU) for validation side-by-side.
PAPER_TABLE3 = {
    "bert-medium": {"omp": 23.7, "smaug": 88.0, "ticsat": 58.3, "mf_dc": 453.9},
    "bert-base": {"omp": 24.3, "ticsat": 69.3, "mf_dc": 633.7},
    "bert-large": {"omp": 25.6, "ticsat": 89.5, "mf_dc": 698.2},
    "vit-base": {"omp": 23.7, "ticsat": 69.4, "mf_dc": 327.9},
    "vit-large": {"omp": 24.3, "ticsat": 82.5, "mf_dc": 392.0},
    "vit-huge": {"omp": 25.6, "ticsat": 82.7, "mf_dc": 427.6},
}


def paper_workload(name: str) -> Workload:
    return transformer_workload(**PAPER_MODELS[name])
