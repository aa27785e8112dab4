"""The port's roofline (``roofline/analysis.py``) against the reference's
``repro/roofline/analysis.py``, its H100 constants, the collective bytes
read from ``tp.collectives``' counts, and ``launch_cost`` — the least
work of one kernel launch — at the shapes of the bounds in ``PERF.md``
§6 (``chip_smoke.py`` computes them through it), to the printed digits:
K1 0.082 ms a smollm-135m decode step, 0.151 a prefill (bytes) and 0.228
a bert-base forward (operations); K3 0.023 ms a bert-base forward; K4
0.009 ms a decode step; K6 0.995 ms a mamba2-1.3b 8 × 384 prefill."""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import numpy as np
import pytest

from repro.roofline import analysis as JRA
from repro_torch.configs.registry import get_config
from repro_torch.roofline import analysis as RA

COSTS = [({"flops": 3.2e12, "bytes accessed": 4.1e9}, 2.5e8),
         ({"flops": 1.0e9, "bytes accessed": 7.0e10}, 0.0),
         ({"flops": 5.0e6, "bytes accessed": 1.0e3}, 9.0e9),
         ({"flops": 0.0, "bytes accessed": 0.0}, 0.0)]


@pytest.mark.parametrize("cost,coll", COSTS)
@pytest.mark.parametrize("model_flops,links", [(None, 1), (2.4e12, 4)])
def test_roofline_terms_equal_reference(cost, coll, model_flops, links):
    jhw = JRA.HW()
    hw = RA.HW(peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw,
               ici_bw=jhw.ici_bw)
    assert RA.roofline_terms(cost, coll, hw, model_flops, links) == \
        JRA.roofline_terms(cost, coll, jhw, model_flops, links)


@pytest.mark.parametrize("kind", ["train", "infer"])
def test_model_flops_estimate_equals_reference(kind):
    assert RA.model_flops_estimate(1.35e8, 4096, kind) == \
        JRA.model_flops_estimate(1.35e8, 4096, kind)


def test_h100_defaults_and_typed_peaks():
    hw = RA.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 450e9)
    assert [hw.peak(d) for d in ("bfloat16", "float32", "int8")] == \
        [989e12, 67e12, 1979e12]
    # a cost typed by dtype divides each type's FLOPs by its own peak
    t = RA.roofline_terms({"flops": 1.056e12, "bytes accessed": 0.0,
                           "flops_by_dtype": {"bfloat16": 989e9,
                                              "float32": 67e9}}, 0.0)
    np.testing.assert_allclose(t["t_compute_s"], 2e-3, rtol=1e-12)


def test_collective_bytes_from_counts():
    snap = {"calls": {"all_reduce": 6, "broadcast": 1},
            "bytes": {"all_reduce": 3020800, "broadcast": 64}}
    out = RA.collective_bytes_from_counts(snap)
    assert out == {"all_reduce": 3020800.0, "broadcast": 64.0,
                   "total": 3020864.0,
                   "counts": {"all_reduce": 6, "broadcast": 1}}


def _gemm_ms(cells, dtype="bfloat16"):
    """Σ bound × uses over (M, K, N, uses), and what bounds it as
    chip_smoke.py's ``aggregate`` says: bytes when the bytes-bound cells
    make at least half of it."""
    total = by_bytes = 0.0
    for M, K, N, uses in cells:
        t, b = RA.bound(RA.launch_cost("matrixflow_gemm", "wgmma", M=M, N=N,
                                       K=K, dtype=dtype))
        total += t * uses
        by_bytes += t * uses if b == "bytes" else 0.0
    return total * 1e3, "bytes" if by_bytes >= total / 2 else "operations"


def _smollm_layer(cfg):
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return [(d, qd, 2 * L), (d, kvd, 2 * L), (d, 2 * f, L), (f, d, L)]


def test_launch_cost_reproduces_perf_bounds_k1():
    """chip_smoke.py's gemm cells: smollm-135m at 8 slots (decode, the
    head at M = 8) and 8 × 64 (prefill), bert-base at 8 × 128."""
    cfg, bert = get_config("smollm-135m"), get_config("bert-base")
    layer = _smollm_layer(cfg)
    ms, by = _gemm_ms([(8, K, N, u) for K, N, u in layer]
                      + [(8, cfg.d_model, cfg.vocab, 1)])
    assert (round(ms, 3), by) == (0.082, "bytes")
    ms, by = _gemm_ms([(512, K, N, u) for K, N, u in layer])
    assert (round(ms, 3), by) == (0.151, "bytes")
    d, f, L = bert.d_model, bert.d_ff, bert.n_layers
    ms, by = _gemm_ms([(1024, K, N, u) for K, N, u in
                       ((d, d, 4 * L), (d, f, L), (f, d, L),
                        (d, bert.vocab, 1))])
    assert (round(ms, 3), by) == (0.228, "operations")


def test_launch_cost_reproduces_perf_bounds_attention_and_scan():
    bert, mamba = get_config("bert-base"), get_config("mamba2-1.3b")
    t, by = RA.bound(RA.launch_cost(
        "flash_attention", "rows", B=8, Sq=128, Sk=128, H=bert.n_heads,
        Hkv=bert.n_kv_heads, D=bert.head_dim, dtype="bfloat16"))
    assert (round(t * 1e3 * bert.n_layers, 3), by) == (0.023, "bytes")
    # K4 at smollm's decode step: chip_smoke.py's first bf16 draw of
    # lengths, the pages and (query, key) pairs that data needs
    cfg = get_config("smollm-135m")
    lens = np.random.default_rng(1).integers(17, 256, 8)
    pages = int((-(-lens // 16)).sum())
    t, by = RA.bound(RA.launch_cost(
        "paged_attention", "split", B=8, Sq=1, H=cfg.n_heads,
        Hkv=cfg.n_kv_heads, D=cfg.head_dim, page_size=16, n_blocks=16,
        dtype="bfloat16", pages=pages, pairs=int(lens.sum())))
    assert (round(t * 1e3 * cfg.n_layers, 3), by) == (0.009, "bytes")
    t, by = RA.bound(RA.launch_cost(
        "ssd_scan", "walk", B=8, S=384, H=mamba.ssm_heads,
        P=mamba.ssm_head_dim, N=mamba.ssm_state, dtype="bfloat16"))
    assert (round(t * 1e3 * mamba.n_layers, 3), by) == (0.995, "bytes")


def test_launch_cost_types_and_ledger():
    """Each route's operations run at their type's peak: K2 at int8's,
    fp32 on the CUDA cores at fp32's; a ledger sums what is recorded."""
    k2 = RA.launch_cost("matrixflow_gemm_dequant", "wgmma", M=1024, N=768,
                        K=768, out_dtype="bfloat16")
    assert k2["dtype"] == "int8"
    assert k2["bytes"] == 1024 * 768 + 768 * 768 + 4 * (1024 + 768) \
        + 1024 * 768 * 2
    fa = RA.launch_cost("flash_attention", "cuda_cores_bf16kv", B=1, Sq=1,
                        Sk=32, H=2, Hkv=1, D=64, dtype="float32",
                        kv_dtype="bfloat16")
    assert fa["dtype"] == "float32" and fa["flops"] == 2.0 * 128 * 2 * 32
    ledger = RA.CostLedger()
    with RA.use_ledger(ledger):
        RA.record_launch("matrixflow_gemm", "wgmma", M=8, N=8, K=8,
                         dtype="bfloat16")
        RA.record_launch("paged_attention", "split",
                         name="paged_attention_int8", B=1, Sq=1, H=2,
                         Hkv=1, D=64, page_size=16, n_blocks=2,
                         dtype="bfloat16", kv_dtype="int8")
    RA.record_launch("matrixflow_gemm", "wgmma", M=8, N=8, K=8,
                     dtype="bfloat16")                    # no ledger active
    assert ledger.launches == {"matrixflow_gemm": {"wgmma": 1},
                               "paged_attention_int8": {"split": 1}}
    assert ledger.flops == 2.0 * 512 + 4.0 * 64 * 2 * 32
