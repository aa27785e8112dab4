#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each fatal on failure:

1. build   — compile csrc/matrixflow_gemm.cu, paged_attention.cu,
             flash_attention.cu and ssd_scan.cu with nvcc for sm_90a, all
             at once.
2. kernels — each kernel against its plain PyTorch version on the card at
             the main paths' shapes, bf16 and fp32 (TF32 off): the
             MatrixFlow GEMM at every full-width smollm-135m projection
             (M = batch_slots and M = slots x prompt bucket) and every
             bert-base / vit-base projection (M = 8 x 128, 8 x 197); paged
             attention at H=9, Hkv=3, D=64, page 16, decode and a bucketed
             prefill over shuffled block tables; flash attention at the
             encoders' shapes (bert-base S 128, vit-base S 197, vit-huge S
             257 at D 80) and smollm's contiguous decode, prefill bucket,
             chunked-prefill offset and bottom-right default. Times the
             kernel, the plain version and one PyTorch call for the same
             function (torch.matmul; SDPA) after an L2 flush. Each GEMM
             cell records the route K1 took (its per-route launch
             counters): a bf16 cell must run on the tensor cores (wgmma at
             bm 64, mma.sync at bm 16 and 32), an fp32 cell on the CUDA
             cores. So too each attention cell: K3 and K4 in bf16 on the
             tensor-core route their chooser names (rows, or split at
             decode), in fp32 on the CUDA cores; every cell is launched
             twice and the two results must be bitwise equal. The paged
             cells' block tables hold an out-of-range page id in every
             entry past a slot's valid keys (the kernels must never read
             one; the plain version reads a valid copy), and a decode cell
             has slots of 0, 1, 128 (a page boundary) and 255 keys.
3. serving — full-width smollm-135m in bf16 from seeded random weights,
             served through the paged engine's submit/step: more requests
             than slots, a pool small enough to preempt. Both kernels'
             launch counters must grow and every request must complete.
             Then one batched generate() on the same engine.
4. parity  — full width in fp32: the kernel path on the card against the
             plain path (the same code on the CPU, where every wrapper runs
             its plain version): prefill and first-decode logits within
             LOGIT_TOL, greedy streams equal or first diverging where the
             plain path's top-2 margin is below LOGIT_TOL.
5. encoders — full-width bert-base (B 8 x S 128 tokens) and vit-base (B 8 x
             197 stub patch embeddings, head 1000) in bf16 through
             encoder_forward under the default policies: the MatrixFlow GEMM
             and flash attention must both launch; logits finite. Then
             bert-base in fp32, kernel path on the card against the plain
             path on the CPU, logits within LOGIT_TOL.
6. contiguous serving — full-width smollm-135m served from contiguous KV
             caches (AttentionPolicy("fused")): 12 requests through
             submit/step in bf16, all complete, the GEMM and flash kernels
             launched; then generate(). In fp32 the same prompts' greedy
             streams equal the paged engine's on the card and the CPU plain
             path's, or first diverge where the plain top-2 margin is below
             LOGIT_TOL.
7. int8 serving — full-width smollm-135m in bf16 with weight_dtype="int8"
             (every projection and the head through the W8A8 GEMM, K2) and
             kv_dtype="int8" (int8 pages through K5): the same 12 requests x
             32 tokens under the 24-page pool, all complete with preemption,
             K2 launched on both tensor-core routes (wgmma at prefill, mma
             at decode) and K5 on both (rows, split), neither on the CUDA
             cores, K1 and K4 not; a preempted request's stream
             equals its solo stream. Then fp32 at full width, the card
             against the CPU plain path: greedy streams equal, or parting
             where the plain top-2 margin is below LOGIT_TOL or after an
             int8 value the two runs rounded differently from an ulp apart
             on a .5 tie (every quantization before it must agree to fp32
             noise: W8A8 and the frozen KV page scales amplify one such
             rounding into a whole quantization step).

8. SSM serving — full-width mamba2-1.3b (48 layers, d_model 2048, 64 SSD
             heads x 64, N 128) in bf16 from contiguous caches under the
             default ServeConfig, whose policy resolves to fused: generate() of 8 prompts x 384 tokens (Q 128, the
             state carried over 3 chunks) x 16 tokens; then a single-slot
             engine: a 200-token prompt (Q 100) through submit/step equals
             generate() of it, and a 131-token request (Q 1) on the
             recycled slot equals its solo run on a fresh engine (conv and
             SSD state zeroed). K1 and the SSD scan (K6) launched, K6 on
             its tensor-core walk route and never on the CUDA cores, the
             paged kernels (K4, K5) not.
9. hybrid serving — full-width zamba2-2.7b (54 SSD layers, d_model 2560,
             one shared attention block every 6 at head_dim 80) in bf16:
             generate() of 8 prompts x 64 tokens x 16 tokens under the fused
             policy; K1, K3 and K6 (walk) launched, K4 and K5 not.
10. SSM parity — fp32, full width cut in depth (mamba2 to 4 layers, zamba2
             to 6, one attention group): the card against the CPU plain
             path, prefill of 2 prompts (200 and 64 tokens) and 8 decode
             steps fed the same tokens, logits within LOGIT_TOL at every
             step, greedy tokens equal or differing only where the plain
             top-2 margin is below LOGIT_TOL.

The kernel phases (2) also hold the W8A8 GEMM (K2) bitwise against its
plain version at smollm-135m's decode and prefill GEMMs and bert-base's
1024-row GEMMs, each on the tensor-core route its chooser names, with
torch._int_mm plus the rescale as its yardstick, and paged attention
over int8 pages (K5) at decode, the prefill bucket and a chunked prefill
(bf16 q on the tensor-core route its chooser names, fp32 q on the CUDA
cores; tables poisoned past the valid keys, two launches bitwise equal),
with SDPA over the dequantized pages as its yardstick;
the SSD scan (K6) against its plain version at the SSM paths' prefills
(mamba2 B 8 x S 384 and 64, B 1 x S 200, 131 and 4096, B 2 x S 1000;
zamba2 B 8 x S 64), fp32 y and state within (1e-4, 1e-4), bf16 y within
TOLS["bfloat16"] and its fp32 state within (1e-4, 1e-4), each on the
route its chooser names (bf16: walk, or chunks from 513 steps; fp32: the
CUDA cores), two launches bitwise equal, timed per call and, from
torch.profiler, per kernel of the route (no single PyTorch call computes
the scan: no yardstick);
K1 at the SSM models' decode GEMMs and mamba2's prefill GEMMs; K3 at
zamba2's head_dim-80 prefill and decode.

Every kernel counter is set to 0 just before each path (3, 5-9) is
driven and read just after; a kernel of the path that never launched fails
it. K1-K6 are counted per route too: every bf16 path must have launched
K1 (or, with int8 weights, K2) on both tensor-core routes (the encoders:
wgmma), K3, K4 or K5 on both of theirs (the encoders: rows), K6 on a
tensor-core route, and none of them on the CUDA cores.
Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Exits non-zero, printing no result, without a
GPU or outside a checkout.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Tolerances (atol, rtol) of kernel vs plain version on the card: the
# reference's own (tests/parity.py TOLS and ATTN_TOLS).
GEMM_TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}
ATTN_TOLS = {"float32": (3e-5, 3e-5), "bfloat16": (3e-2, 3e-2)}
# Full-width fp32 logits, kernel path on the card vs plain path on the CPU:
# 30 layers of fp32 GEMMs summed in another order, random weights.
LOGIT_TOL = 1e-3
# The SSD scan (K6) against its plain version: fp32 within the reference's
# ssd_chunked tolerance (tests/test_ssm.py), bf16 y within parity's TOLS.
# The SSM models' fp32 logits, card vs CPU, are held to LOGIT_TOL as the
# other full-width paths are: K1 sums each fp32 dot product in one running
# sum, and at zamba2's K = 10240 (its shared MLP) that parts the logits
# (up to ~4.6) from the CPU's by ~2e-4 on an H100, where torch.matmul
# parts them by ~4e-5 (scripts/torch_fp32_backend_diff.py); parity's
# TOLS["float32"] (1e-4, 1e-5) is below both.
SSD_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s per dtype.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# The serving paths: full-width smollm-135m.
ARCH = "smollm-135m"
SLOTS = 8
MAX_LEN = 256
PAGE = 16
PROMPT_BUCKET = 64           # prompts of 16..64 tokens → a 64-column bucket
N_REQUESTS = 12
GEN_LEN = 32
CACHE_PAGES = 24             # < 8 slots x 6 pages: decode growth preempts
# The encoder path: the paper's models at full published width.
ENC_BATCH = 8
BERT_SEQ = 128
VIT_SEQ = 197                # 196 patches + the class token
PARITY_BATCH = 2             # bert-base fp32, card vs CPU
# The SSM paths: full-width mamba2-1.3b and zamba2-2.7b, contiguous caches.
MAMBA, ZAMBA = "mamba2-1.3b", "zamba2-2.7b"
SSM_SLOTS = 8
SSM_MAX_LEN = 512
SSM_GEN = 16
MAMBA_PROMPT = 384           # Q 128: the state carried over three chunks
SOLO_PROMPTS = (200, 131)    # Q 100 over two chunks; Q 1 over 131
ZAMBA_PROMPT = 64
SSM_PARITY = {MAMBA: (4, 200), ZAMBA: (6, 64)}   # layers, prompt tokens
SSM_PARITY_STEPS = 8


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Timer:
    """Device time of one call, the median of `iters` calls, each after an
    L2 flush (the serving path meets its weights cold: 270 MB of bf16
    weights per decode step against a 50 MB L2). Before each timed call
    the card spins for twice the host time the call takes to enqueue its
    work plus ~1 ms, with Python's garbage collector paused, so the start
    event fires only once all of it is queued even when the shared host
    stalls: the interval is device time, not host overhead. A stall longer
    than the spin still lets the card idle inside one call's interval (a
    10.8 us kernel once read 0.47 ms as a mean of 20); the median drops
    that call."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin_cycles = int(2 * enqueue_s * 2e9) + 2_000_000  # ~2 GHz SM clock
        gc.disable()
        try:
            times = [self._timed(fn, spin_cycles) for _ in range(self.iters)]
        finally:
            gc.enable()
        return statistics.median(times)

    def _timed(self, fn, spin_cycles: int) -> float:
        self.flush_buf.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


ATTN_ROUTES = ("rows", "split", "cuda_cores")
K2_ROUTES = ("wgmma", "mma")
SSD_ROUTES = ("walk", "chunks", "cuda_cores")
SSD_TC_ROUTES = ("walk", "chunks")


def kernel_wrappers():
    """Each kernel's launch counter: (the wrapper, its attribute) or (a
    dict of counts by route, its key). The paged wrapper launches K4 for fp
    pools and K5 for int8 pools, and counts them apart."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matrixflow_gemm as MF
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_scan as K6
    k1 = MF.matrixflow_gemm_block_major
    fa, pa = FA.flash_attention, PA.paged_attention
    return {"matrixflow_gemm": (k1, "launches"),
            # K1 by route: bf16 on the tensor cores (wgmma at bm 64, mma.sync
            # at bm 16/32), fp32 and int8 on the CUDA cores
            "matrixflow_gemm_wgmma": (k1, "wgmma_launches"),
            "matrixflow_gemm_mma": (k1, "mma_launches"),
            "matrixflow_gemm_cuda_core": (k1, "cuda_core_launches"),
            "paged_attention": (pa, "launches"),
            "flash_attention": (fa, "launches"),
            # K3 and K4 by route: bf16 on the tensor cores (rows: more than
            # 16 rows a CTA; split: decode), fp32 on the CUDA cores
            **{f"flash_attention_{r}": (fa.launches_by_route, r)
               for r in ATTN_ROUTES},
            **{f"paged_attention_{r}": (pa.launches_by_route, r)
               for r in ATTN_ROUTES},
            "matrixflow_gemm_dequant": (MF.matrixflow_gemm_dequant,
                                        "launches"),
            # K2 by route: wgmma at bm 64, mma.sync at bm 16/32
            **{f"matrixflow_gemm_dequant_{r}": (MF.matrixflow_gemm_dequant,
                                                f"{r}_launches")
               for r in K2_ROUTES},
            "paged_attention_int8": (pa, "launches_int8"),
            # K5 by route: bf16 q on the tensor cores, fp32 q on the CUDA cores
            **{f"paged_attention_int8_{r}": (pa.launches_int8_by_route, r)
               for r in ATTN_ROUTES},
            "ssd_scan": (K6.ssd_scan, "launches"),
            # K6 by route: bf16 on the tensor cores (walk: a row's tiles in
            # one CTA; chunks: segments over CTAs), fp32 on the CUDA cores
            **{f"ssd_scan_{r}": (K6.ssd_scan.launches_by_route, r)
               for r in SSD_ROUTES}}


def counts() -> dict:
    return {k: c[key] if isinstance(c, dict) else getattr(c, key)
            for k, (c, key) in kernel_wrappers().items()}


def reset_counts() -> None:
    for c, key in kernel_wrappers().values():
        if isinstance(c, dict):
            c[key] = 0
        else:
            setattr(c, key, 0)


# What a bf16 path that prefills (or encodes) and decodes must launch: K1
# on both tensor-core routes, never on the CUDA cores; so too K3 or K4.
K1_BF16 = ("matrixflow_gemm", "matrixflow_gemm_wgmma", "matrixflow_gemm_mma")
K3_BF16 = ("flash_attention", "flash_attention_rows", "flash_attention_split")
K4_BF16 = ("paged_attention", "paged_attention_rows", "paged_attention_split")
# K6 at the SSM paths' prefills (S <= 512): the walk route
K6_BF16 = ("ssd_scan", "ssd_scan_walk")
K2_K5_BF16 = ("matrixflow_gemm_dequant", "matrixflow_gemm_dequant_wgmma",
              "matrixflow_gemm_dequant_mma", "paged_attention_int8",
              "paged_attention_int8_rows", "paged_attention_int8_split")
CUDA_CORE_COUNTERS = ("matrixflow_gemm_cuda_core", "flash_attention_cuda_cores",
                      "paged_attention_cuda_cores",
                      "paged_attention_int8_cuda_cores", "ssd_scan_cuda_cores")


def read_counts(path: str, required) -> dict:
    """The launch counts since reset_counts(); fails if a kernel of the
    path never launched, or if K1, K3, K4, K5 or K6 ran on the CUDA cores
    (every path read here is bf16 or int8 with bf16 activations, and none
    may take that route; K2 has no CUDA-core route)."""
    counts_now = counts()
    for name in required:
        if counts_now[name] <= 0:
            fail(f"{path}: kernel {name} was never launched")
    for name in CUDA_CORE_COUNTERS:
        if counts_now[name]:
            fail(f"{path}: {name} counted {counts_now[name]} launches on "
                 f"the CUDA cores")
    return counts_now


def route_taken(before: dict, after: dict, kernel: str,
                routes=ATTN_ROUTES) -> str:
    """The one route of ``kernel`` whose counter grew between two counts()
    snapshots; fails unless exactly one did."""
    grew = [r for r in routes
            if after[f"{kernel}_{r}"] > before[f"{kernel}_{r}"]]
    if len(grew) != 1:
        fail(f"{kernel}: routes {grew} counted launches, expected one")
    return grew[0]


def check_close(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: kernel output is not finite")
    if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        fail(f"{name}: max |kernel - plain| = {err:.3e} exceeds atol={atol} "
             f"rtol={rtol}")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_cells(cfg, bert, vit, ssm_cfgs=()):
    """(name, M, K, N, path, uses per run of the path) of every projection
    of the serving paths (smollm-135m; the SSM models' decode steps and
    mamba2's prefill) and the encoder paths."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd, L = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.n_layers
    layer = [("q/o", d, qd, 2 * L), ("k/v", d, kvd, 2 * L),
             ("mlp-in", d, 2 * f, L), ("mlp-out", f, d, L)]
    cells = [(f"decode {n}", SLOTS, K, N, "decode step", c)
             for n, K, N, c in layer]
    # prefill reads last columns only: the head runs at M = SLOTS too
    cells.append(("head", SLOTS, d, V, "decode step", 1))
    cells += [(f"prefill {n}", SLOTS * PROMPT_BUCKET, K, N, "prefill", c)
              for n, K, N, c in layer]
    for scfg in ssm_cfgs:
        d, di, L = scfg.d_model, scfg.d_inner, scfg.n_layers
        ssd = [("z/x", d, di, 2 * L), ("B/C", d, scfg.ssm_state, 2 * L),
               ("dt", d, scfg.ssm_heads, L), ("out", di, d, L)]
        if scfg.attn_every:        # the shared block, once per group
            g, hd = L // scfg.attn_every, scfg.n_heads * scfg.head_dim
            ssd += [("shared q/k/v/o", d, hd, 4 * g),
                    ("shared mlp-in", d, 2 * scfg.d_ff, g),
                    ("shared mlp-out", scfg.d_ff, d, g)]
        step = f"{scfg.name} decode step"
        cells += [(f"{scfg.name} decode {n}", SSM_SLOTS, K, N, step, c)
                  for n, K, N, c in ssd + [("head", d, scfg.vocab, 1)]]
        if not scfg.attn_every:    # mamba2's generate prefill, 8 x 384 rows
            cells += [(f"{scfg.name} prefill {n}", SSM_SLOTS * MAMBA_PROMPT,
                       K, N, f"{scfg.name} prefill", c) for n, K, N, c in ssd]
    for ecfg, M in ((bert, ENC_BATCH * BERT_SEQ),
                    (vit, ENC_BATCH * VIT_SEQ)):
        d, f, L = ecfg.d_model, ecfg.d_ff, ecfg.n_layers
        path = f"{ecfg.name} forward"
        cells += [(f"{ecfg.name} {n}", M, K, N, path, c) for n, K, N, c in
                  (("q/k/v/o", d, d, 4 * L), ("mlp-in", d, f, L),
                   ("mlp-out", f, d, L), ("head", d, ecfg.vocab, 1))]
    return cells


def run_gemm_phase(timer, cfg, bert, vit, ssm_cfgs):
    from repro_torch.core import layout as L
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, pack_weight
    from repro_torch.kernels import matrixflow_gemm as MF

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = GEMM_TOLS[dtype_name]
        for name, M, K, N, path, uses in gemm_cells(cfg, bert, vit,
                                                    ssm_cfgs):
            a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            pw = pack_weight(w, GemmPolicy())          # as the engine packs
            blk = layout_for_packed(M, pw)
            a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
            before = counts()
            got = MF.matrixflow_gemm_block_major(a_bm, pw.data, out_dtype=dt)
            after = counts()
            want = MF.plain(a_bm, pw.data, out_dtype=dt)
            torch.cuda.synchronize()
            cell = f"matrixflow_gemm {name} M={M} K={K} N={N} {dtype_name}"
            route = [r for r in ("wgmma", "mma", "cuda_core")
                     if after[f"matrixflow_gemm_{r}"]
                     > before[f"matrixflow_gemm_{r}"]]
            allowed = (("wgmma", "mma") if dtype_name == "bfloat16"
                       else ("cuda_core",))
            if len(route) != 1 or route[0] not in allowed:
                fail(f"{cell}: ran route {route}, expected one of {allowed}")
            tile = (MF.tc_tile(blk.bm, blk.bn, a_bm.shape[0],
                               pw.data.shape[0], a_bm.shape[1], blk.bk)
                    if route[0] != "cuda_core" else None)
            err = check_close(cell, got, want, atol, rtol)
            t_k = timer.ms(lambda: MF.matrixflow_gemm_block_major(
                a_bm, pw.data, out_dtype=dt))
            t_p = timer.ms(lambda: MF.plain(a_bm, pw.data, out_dtype=dt))
            t_lib = timer.ms(lambda: torch.matmul(a, w))
            nbytes = (M * K + K * N + M * N) * dt.itemsize
            b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K, dtype_name)
            rows.append(dict(cell=cell, dtype=dtype_name, M=M, K=K, N=N,
                             block=[blk.bm, blk.bn, blk.bk], route=route[0],
                             tile=tile, path=path, uses=uses, max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: blocks {blk.bm}x{blk.bn}x{blk.bk} route {route[0]} "
                f"tile {tile} max|d|={err:.2e} "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms matmul {t_lib:.4f} "
                f"ms bound {b_ms:.4f} ms ({b_by})")
    return rows


def paged_case(gen, dt, *, B, Sq, lens, q_start, H, Hkv, D, ps, nb):
    """Shuffled block tables over a pool with garbage distractor pages;
    row b holds lens[b] keys; its queries sit at q_start[b] + s (-1 past
    the row's real queries, as bucketed prefill pads). Returns the tables
    twice: valid page ids everywhere (for the plain version, which gathers
    every entry), and with every entry past a row's valid keys out of the
    pool's range (for the kernels, which must never read one)."""
    P = B * nb + 5
    kp = torch.randn((P, ps, Hkv, D), generator=gen, device="cuda").to(dt) * 3
    vp = torch.randn((P, ps, Hkv, D), generator=gen, device="cuda").to(dt) * 3
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
    tables = perm.reshape(B, nb).to(torch.int32)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
    qpos = np.full((B, Sq), -1, np.int32)
    for b in range(B):
        n_real = lens[b] - q_start[b]
        qpos[b, :n_real] = q_start[b] + np.arange(n_real)
    qpos = torch.from_numpy(qpos).cuda()
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(nb, device="cuda")[None] >= -(-kvl[:, None] // ps)
    poisoned = torch.where(dead, torch.full_like(tables, P + (1 << 20)),
                           tables)
    return q, kp, vp, tables, poisoned, qpos, kvl


def run_attention_phase(timer, cfg):
    from repro_torch.kernels import paged_attention as PA

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nb = MAX_LEN // PAGE
    rng = np.random.default_rng(1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        dec_lens = rng.integers(17, MAX_LEN, SLOTS).tolist()
        pf_lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS).tolist()
        # a slot with no key (its row masked), one key, keys ending exactly
        # on a page boundary, and the longest a 256-token slot decodes
        edge_lens = [0, 1, 8 * PAGE, MAX_LEN - 1] + \
            rng.integers(17, MAX_LEN, SLOTS - 4).tolist()
        cases = [
            ("decode", 1, dec_lens, [n - 1 for n in dec_lens], "decode step"),
            ("decode edge lengths", 1, edge_lens,
             [n - 1 for n in edge_lens], "decode step, edge lengths"),
            ("prefill", PROMPT_BUCKET, pf_lens, [0] * SLOTS, "prefill"),
        ]
        for name, Sq, lens, q_start, path in cases:
            q, kp, vp, bt, dead_bt, qpos, kvl = paged_case(
                gen, dt, B=SLOTS, Sq=Sq, lens=lens, q_start=q_start,
                H=H, Hkv=Hkv, D=D, ps=PAGE, nb=nb)
            scale = D ** -0.5
            before = counts()
            got = PA.paged_attention(q, kp, vp, dead_bt, qpos, kvl)
            again = PA.paged_attention(q, kp, vp, dead_bt, qpos, kvl)
            route = route_taken(before, counts(), "paged_attention")
            want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl,
                                            causal=True, scale=scale,
                                            soft_cap=None)
            torch.cuda.synchronize()
            cell = f"paged_attention {name} B={SLOTS} Sq={Sq} {dtype_name}"
            expect = PA.route_for(dt, Sq, H // Hkv)
            if route != expect or (dtype_name == "float32") != (
                    route == "cuda_cores"):
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            if not torch.equal(got, again):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, got, want, atol, rtol)
            masked = qpos < 0
            if bool(masked.any()) and float(got[masked].abs().max()) != 0.0:
                fail(f"{cell}: masked query rows are not exactly zero")
            # SDPA over the gathered pages, as a yardstick (gather excluded)
            kd = PA.gather_pages(kp, bt).repeat_interleave(H // Hkv, 2)
            vd = PA.gather_pages(vp, bt).repeat_interleave(H // Hkv, 2)
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, kd, vd))
            cols = torch.arange(nb * PAGE, device="cuda")
            mask = ((cols[None, None, :] < kvl[:, None, None])
                    & (cols[None, None, :] <= qpos[:, :, None]))[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_k = timer.ms(lambda: PA.paged_attention(q, kp, vp, dead_bt,
                                                      qpos, kvl))
            t_p = timer.ms(lambda: PA.paged_attention_plain(
                q, kp, vp, bt, qpos, kvl, causal=True, scale=scale,
                soft_cap=None))
            t_lib = timer.ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
            # what this run's data needs: each visible page of K and V once,
            # q, the tables and the output; 2·(D + Dv) FLOPs per visible key
            qmax = qpos.max(dim=1).values
            horizon = torch.minimum(kvl, qmax + 1).clamp(min=0)
            pages = int((-(-horizon // PAGE)).sum())
            nbytes = (2 * pages * PAGE * Hkv * D + 2 * q.numel()) * dt.itemsize \
                + bt.numel() * 4 + qpos.numel() * 4
            vis = torch.minimum(kvl[:, None], qpos + 1).clamp(min=0)
            flops = float(vis.sum()) * H * 4 * D
            b_ms, b_by = bound_ms(nbytes, flops, dtype_name)
            rows.append(dict(cell=cell, dtype=dtype_name, Sq=Sq, lens=lens,
                             path=path, uses=cfg.n_layers, route=route,
                             max_abs_err=err, ms=t_k, plain_ms=t_p,
                             library_ms=t_lib, bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2c: flash attention against its plain version
# ---------------------------------------------------------------------------

def flash_cells(cfg, bert, vit, vit_huge, zamba, rng):
    """(name, B, Sq, Sk, H, Hkv, D, causal, q_positions, kv_valid_len,
    path, uses per run) at the encoder paths' and the contiguous serving
    path's shapes. q_positions / kv_valid_len are numpy arrays or None (the
    wrapper's bottom-right default / Sk)."""
    H, Hkv, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    cells = [(e.name, ENC_BATCH, S, S, e.n_heads, e.n_kv_heads, e.head_dim,
              False, None, None, f"{e.name} forward", e.n_layers)
             for e, S in ((bert, BERT_SEQ), (vit, VIT_SEQ),
                          (vit_huge, 257))]
    # contiguous decode: ragged lengths, one masked row (position -1)
    lens = rng.integers(17, MAX_LEN + 1, SLOTS)
    lens[3] = 0
    qpos = (lens - 1)[:, None].astype(np.int32)
    cells.append(("smollm decode", SLOTS, 1, MAX_LEN, H, Hkv, D, True, qpos,
                  lens.astype(np.int32), "decode step", L))
    # the engine's single-slot prefill: one real row of a 64-column bucket,
    # 40 real columns, every other row masked
    qpos = np.full((SLOTS, PROMPT_BUCKET), -1, np.int32)
    qpos[0, :40] = np.arange(40)
    lens = np.zeros(SLOTS, np.int32)
    lens[0] = 40
    cells.append(("smollm prefill bucket", SLOTS, PROMPT_BUCKET, MAX_LEN, H,
                  Hkv, D, True, qpos, lens, "prefill", L))
    # chunked prefill: 32-column chunks continuing ragged caches
    starts = rng.integers(0, MAX_LEN - 32, SLOTS)
    qpos = (starts[:, None] + np.arange(32)).astype(np.int32)
    cells.append(("chunked prefill offset", SLOTS, 32, MAX_LEN, H, Hkv, D,
                  True, qpos, (starts + 32).astype(np.int32), "chunk", L))
    cells.append(("bottom-right default", SLOTS, PROMPT_BUCKET, MAX_LEN, H,
                  Hkv, D, True, None, None, "default", L))
    # zamba2's shared block (head_dim 80) over its contiguous caches: the
    # generate prefill and a decode step, once per attention group
    z, G = zamba, zamba.n_layers // zamba.attn_every
    qpos = np.broadcast_to(np.arange(ZAMBA_PROMPT, dtype=np.int32),
                           (SSM_SLOTS, ZAMBA_PROMPT)).copy()
    cells.append(("zamba2 prefill", SSM_SLOTS, ZAMBA_PROMPT, SSM_MAX_LEN,
                  z.n_heads, z.n_kv_heads, z.head_dim, True, qpos,
                  np.full(SSM_SLOTS, ZAMBA_PROMPT, np.int32), "zamba2 prefill",
                  G))
    pos = ZAMBA_PROMPT + rng.integers(0, SSM_GEN, SSM_SLOTS).astype(np.int32)
    cells.append(("zamba2 decode", SSM_SLOTS, 1, SSM_MAX_LEN, z.n_heads,
                  z.n_kv_heads, z.head_dim, True, pos[:, None], pos + 1,
                  "zamba2 decode step", G))
    return cells


def run_flash_phase(timer, cells):
    from repro_torch.kernels import flash_attention as FA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        for (name, B, Sq, Sk, H, Hkv, D, causal, qpos_np, kvl_np, path,
             uses) in cells:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                       for shape in ((B, Sq, H, D), (B, Sk, Hkv, D),
                                     (B, Sk, Hkv, D)))
            qpos = None if qpos_np is None else torch.from_numpy(qpos_np).cuda()
            kvl = None if kvl_np is None else torch.from_numpy(kvl_np).cuda()
            before = counts()
            got = FA.flash_attention(q, k, v, qpos, kvl, causal=causal)
            again = FA.flash_attention(q, k, v, qpos, kvl, causal=causal)
            route = route_taken(before, counts(), "flash_attention")
            qpos_r = qpos if qpos is not None else (
                torch.arange(Sq, device="cuda") + (Sk - Sq)).expand(
                    B, Sq).to(torch.int32)
            kvl_r = kvl if kvl is not None else torch.full(
                (B,), Sk, dtype=torch.int32, device="cuda")
            scale = D ** -0.5
            want = FA.flash_attention_plain(q, k, v, qpos_r, kvl_r,
                                            causal=causal, scale=scale,
                                            soft_cap=None)
            torch.cuda.synchronize()
            cell = (f"flash_attention {name} B={B} Sq={Sq} Sk={Sk} H={H} "
                    f"Hkv={Hkv} D={D} {dtype_name}")
            expect = FA.route_for(dt, Sq, H // Hkv)
            if route != expect or (dtype_name == "float32") != (
                    route == "cuda_cores"):
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            if not torch.equal(got, again):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, got, want, atol, rtol)
            masked = qpos_r < 0
            if causal and bool(masked.any()) \
                    and float(got[masked].abs().max()) != 0.0:
                fail(f"{cell}: masked query rows are not exactly zero")
            # SDPA on (B, H, S, D) copies with K/V repeated per query head
            # and the same visibility as a boolean mask (copies not timed)
            rep = H // Hkv
            qs = q.transpose(1, 2).contiguous()
            ks, vs = (x.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
                      for x in (k, v))
            cols = torch.arange(Sk, device="cuda")
            vis = cols[None, None, :] < kvl_r[:, None, None]
            if causal:
                vis = vis & (cols[None, None, :] <= qpos_r[:, :, None])
            mask = None if bool(vis.all()) else vis[:, None]
            t_k = timer.ms(lambda: FA.flash_attention(q, k, v, qpos, kvl,
                                                      causal=causal))
            t_p = timer.ms(lambda: FA.flash_attention_plain(
                q, k, v, qpos_r, kvl_r, causal=causal, scale=scale,
                soft_cap=None))
            t_lib = timer.ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
            # what this run's data needs: each row's visible keys of K and V
            # once per kv head, q and the output once; 4·D FLOPs per
            # visible (query, head, key)
            horizon = kvl_r.clamp(min=0)
            if causal:
                horizon = torch.minimum(horizon, qpos_r.max(dim=1).values + 1)
            horizon = horizon.clamp(min=0)
            nbytes = (2 * int(horizon.sum()) * Hkv * D + 2 * q.numel()) \
                * dt.itemsize + 4 * (qpos_r.numel() + kvl_r.numel())
            flops = 4.0 * D * H * float(vis.sum())
            b_ms, b_by = bound_ms(nbytes, flops, dtype_name)
            rows.append(dict(cell=cell, dtype=dtype_name, path=path,
                             uses=uses, route=route, max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2d: the W8A8 GEMM (K2) against its plain version
# ---------------------------------------------------------------------------

def run_quant_gemm_phase(timer, cfg, bert, vit):
    """K2 at smollm-135m's decode (M = 8) and 64-column prefill GEMMs and
    bert-base's 1024-row GEMMs, fp32 and bf16 out: bitwise equal to the
    plain version, on the tensor-core route its chooser names (wgmma at bm
    64, mma.sync at bm 16/32). The activations are quantized per row as
    the W8A8 route does; the weights are packed as the engine packs
    them."""
    from repro_torch.core import layout as L
    from repro_torch.core import quant as Q
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, pack_weight
    from repro_torch.kernels import matrixflow_gemm as MF

    cells = [c for c in gemm_cells(cfg, bert, vit)
             if c[4] != f"{vit.name} forward"]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(10)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for name, M, K, N, path, uses in cells:
            a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            pw = pack_weight(w, GemmPolicy(), quantize="int8")
            blk = layout_for_packed(M, pw)
            aq, sa = Q.quantize_activations(a)
            a_bm = L.to_block_major_a(aq, blk.bm, blk.bk)

            def kernel():
                return MF.matrixflow_gemm_dequant(a_bm, pw.data, sa,
                                                  pw.scales, out_dtype=dt)

            before = counts()
            got = kernel()
            route = route_taken(before, counts(), "matrixflow_gemm_dequant",
                                K2_ROUTES)
            want = MF.plain(a_bm, pw.data, out_dtype=dt, scale_a=sa,
                            scale_b=pw.scales)
            torch.cuda.synchronize()
            cell = (f"matrixflow_gemm_dequant {name} M={M} K={K} N={N} "
                    f"{dtype_name}")
            expect = MF.route_for(torch.int8, blk.bm, dequant=True)
            if route != expect:
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            tile = MF.tc_tile(blk.bm, blk.bn, a_bm.shape[0], pw.data.shape[0],
                              a_bm.shape[1], blk.bk)
            if not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                fail(f"{cell}: kernel and plain version differ (max |d| "
                     f"{err:.3e}); the W8A8 GEMM must match bitwise")
            # yardstick: torch._int_mm (cuBLASLt, needs M > 16 and K, N
            # multiples of 8: decode rows padded to 32, N to a multiple of
            # 8) followed by the rank-1 rescale
            Mp, Np = max(M, 32), -(-N // 8) * 8
            a_pad = torch.zeros((Mp, K), dtype=torch.int8, device="cuda")
            a_pad[:M] = aq
            w_pad = torch.zeros((K, Np), dtype=torch.int8, device="cuda")
            w_pad[:, :N] = pw.unpack_quantized()
            sa_pad = torch.ones(Mp, device="cuda")
            sa_pad[:M] = sa
            sb_pad = torch.ones(Np, device="cuda")
            sb_pad[:N] = pw.scales

            def library():
                c = torch._int_mm(a_pad, w_pad).float()
                return (c * sa_pad[:, None] * sb_pad[None, :]).to(dt)

            t_k = timer.ms(kernel)
            t_p = timer.ms(lambda: MF.plain(a_bm, pw.data, out_dtype=dt,
                                            scale_a=sa, scale_b=pw.scales))
            t_lib = timer.ms(library)
            nbytes = M * K + K * N + 4 * (M + N) + M * N * dt.itemsize
            b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K, "int8")
            rows.append(dict(cell=cell, dtype=dtype_name, M=M, K=K, N=N,
                             block=[blk.bm, blk.bn, blk.bk], route=route,
                             tile=tile, path=path,
                             uses=uses, max_abs_err=0.0, ms=t_k,
                             plain_ms=t_p, library_ms=t_lib,
                             library_padding=[Mp - M, Np - N],
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: blocks {blk.bm}x{blk.bn}x{blk.bk} route {route} "
                f"tile {tile} bitwise kernel "
                f"{t_k:.4f} ms plain {t_p:.4f} ms _int_mm+rescale "
                f"{t_lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2e: paged attention over int8 pages (K5) against its plain version
# ---------------------------------------------------------------------------

def run_int8_attention_phase(timer, cfg):
    """K5 at smollm-135m's decode, prefill bucket and chunked prefill, q in
    bf16 and fp32, over int8 pools with per-(page, kv head) scales through
    shuffled block tables whose entries past a slot's valid keys are out
    of range (the kernels read neither those pages nor their scales);
    within ATTN_TOLS, masked rows exactly 0, two launches bitwise equal,
    on the route the chooser names (bf16 q: split at decode, rows above 16
    rows a CTA; fp32 q: the CUDA cores)."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import paged_attention as PA

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nb = MAX_LEN // PAGE
    rng = np.random.default_rng(11)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        dec_lens = rng.integers(17, MAX_LEN, SLOTS).tolist()
        pf_lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS).tolist()
        starts = rng.integers(0, MAX_LEN - 32, SLOTS).tolist()
        cases = [
            ("decode", 1, dec_lens, [n - 1 for n in dec_lens], "decode step"),
            ("prefill", PROMPT_BUCKET, pf_lens, [0] * SLOTS, "prefill"),
            ("chunked prefill", 32, [t + 32 for t in starts], starts,
             "chunk"),
        ]
        for name, Sq, lens, q_start, path in cases:
            q, kp, vp, bt, dead_bt, qpos, kvl = paged_case(
                gen, torch.float32, B=SLOTS, Sq=Sq, lens=lens,
                q_start=q_start, H=H, Hkv=Hkv, D=D, ps=PAGE, nb=nb)
            q = q.to(dt)
            (qk, ks), (qv, vs) = Q.quantize_kv_pages(kp), \
                Q.quantize_kv_pages(vp)
            scale = D ** -0.5

            def kernel():
                return PA.paged_attention(q, qk, qv, dead_bt, qpos, kvl,
                                          kv_scales=(ks, vs))

            def plain():
                return PA.paged_attention_plain(
                    q, qk, qv, bt, qpos, kvl, causal=True, scale=scale,
                    soft_cap=None, kv_scales=(ks, vs))

            before = counts()
            got, again = kernel(), kernel()
            route = route_taken(before, counts(), "paged_attention_int8")
            want = plain()
            torch.cuda.synchronize()
            cell = (f"paged_attention_int8 {name} B={SLOTS} Sq={Sq} q "
                    f"{dtype_name}")
            expect = PA.route_for(dt, Sq, H // Hkv)
            if route != expect or (dtype_name == "float32") != (
                    route == "cuda_cores"):
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            if not torch.equal(got, again):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, got, want, atol, rtol)
            masked = qpos < 0
            if bool(masked.any()) and float(got[masked].abs().max()) != 0.0:
                fail(f"{cell}: masked query rows are not exactly zero")
            # SDPA over the gathered, dequantized pages (not timed)
            rep = H // Hkv
            kd = PA.gather_pages(Q.dequantize_kv_pages(qk, ks, dt), bt)
            vd = PA.gather_pages(Q.dequantize_kv_pages(qv, vs, dt), bt)
            qs, kss, vss = (x.transpose(1, 2).contiguous() for x in (
                q, kd.repeat_interleave(rep, 2), vd.repeat_interleave(rep, 2)))
            cols = torch.arange(nb * PAGE, device="cuda")
            mask = ((cols[None, None, :] < kvl[:, None, None])
                    & (cols[None, None, :] <= qpos[:, :, None]))[:, None]
            t_k = timer.ms(kernel)
            t_p = timer.ms(plain)
            t_lib = timer.ms(lambda: sdpa(qs, kss, vss, attn_mask=mask))
            # what this run's data needs: each visible page of K and V once
            # as int8 plus its two fp32 scales, q and the output, the
            # tables; 4·D operations per visible (query, head, key)
            qmax = qpos.max(dim=1).values
            horizon = torch.minimum(kvl, qmax + 1).clamp(min=0)
            pages = int((-(-horizon // PAGE)).sum())
            nbytes = 2 * pages * (PAGE * Hkv * D + 4 * Hkv) \
                + 2 * q.numel() * dt.itemsize + 4 * (bt.numel() + qpos.numel())
            vis = torch.minimum(kvl[:, None], qpos + 1).clamp(min=0)
            flops = float(vis.sum()) * H * 4 * D
            b_ms, b_by = bound_ms(nbytes, flops, dtype_name)
            rows.append(dict(cell=cell, dtype=dtype_name, Sq=Sq, lens=lens,
                             path=path, uses=cfg.n_layers, route=route,
                             max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2f: the SSD scan (K6) against its plain version
# ---------------------------------------------------------------------------

def ssd_cells(mamba, zamba):
    """(name, B, S, cfg, path) of the SSD scans the SSM paths run (one per
    SSD layer of a prefill), plus mamba2 at B 8 x S 64 (one chunk), a
    4096-token prompt (32 chunks) and B 2 x S 1000 (Q 125)."""
    return [(f"{mamba.name} generate prefill", SSM_SLOTS, MAMBA_PROMPT, mamba),
            (f"{mamba.name} submit prefill", 1, SOLO_PROMPTS[0], mamba),
            (f"{mamba.name} recycled-slot prefill", 1, SOLO_PROMPTS[1], mamba),
            (f"{mamba.name} prefill", SSM_SLOTS, 64, mamba),
            (f"{mamba.name} long prefill", 1, 4096, mamba),
            (f"{mamba.name} prefill", 2, 1000, mamba),
            (f"{zamba.name} generate prefill", SSM_SLOTS, ZAMBA_PROMPT, zamba)]


def ssd_bound(B, S, H, P, N, dtype_name):
    """Bytes of x, dt, A, B, C, y and the final state, each moved once;
    operations of this run's chunks: C Bᵀ over each chunk's lower triangle
    once per (row, chunk) — it is shared by the heads — then per head the
    decay-masked product with dt x, C hᵀ for every chunk after the first
    (the state is zero before it) and the state update."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_size

    Q = ssd_chunk_size(S, 128)
    nc, tri = S // Q, Q * (Q + 1) / 2
    item = torch.finfo(getattr(torch, dtype_name)).bits // 8
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * item \
        + 4 * (B * S * H + H + B * H * P * N)
    flops = B * nc * tri * 2 * N + B * H * (
        nc * (tri * (2 * P + 1) + 2 * Q * P * N + 3 * Q * P)
        + (nc - 1) * 2 * Q * N * P)
    return bound_ms(nbytes, flops, dtype_name)


# K6's kernels by phase (csrc/ssd_scan.cu): the chunks route launches all
# three, the walk route the last one; fp32 runs ssd_scan_kernel.
SSD_PHASES = (("ssd_segment_state_kernel", "segment states"),
              ("ssd_segment_pass_kernel", "segment pass"),
              ("ssd_walk_kernel", "walk"), ("ssd_scan_kernel", "cuda cores"))


def ssd_phase_ms(fn, n=5):
    """Device time per call of each of K6's kernels over ``n`` calls, from
    torch.profiler (L2 warm: the calls run back to back)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for sub, phase in SSD_PHASES:
            if sub in e.name:
                out[phase] = out.get(phase, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / n
    return out


def run_ssd_phase(timer, mamba, zamba):
    """K6 at every SSM path's prefill shape, bf16 and fp32: the route its
    chooser names (bf16 on a tensor-core route, fp32 on the CUDA cores),
    two launches bitwise equal, y and the fp32 state against the plain
    version, the time per call and, per route, per kernel (phase)."""
    from repro_torch.kernels import ssd_scan as K6

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(15)
    for dtype_name in ("bfloat16", "float32"):
        dt_ = getattr(torch, dtype_name)
        atol, rtol = SSD_TOLS[dtype_name]
        for name, B, S, scfg in ssd_cells(mamba, zamba):
            H, P, N = scfg.ssm_heads, scfg.ssm_head_dim, scfg.ssm_state
            # the distributions of tests/test_flash_ssd_kernels.py, which
            # the fp32 tolerance was set for: the error of a sum in another
            # order grows with the terms' scale, and with unscaled B and C
            # (C·B ~ 11 at N 128) kernel and plain part by ~1e-3 on outputs
            # near 0, 1e-5 of the terms summed
            x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dt_)
            dt = torch.nn.functional.softplus(torch.randn(
                (B, S, H), generator=gen, device="cuda"))
            A = -torch.exp(0.5 * torch.randn((H,), generator=gen,
                                             device="cuda"))
            Bc, Cc = ((0.5 * torch.randn((B, S, N), generator=gen,
                                         device="cuda")).to(dt_)
                      for _ in range(2))
            before = counts()
            y, h = K6.ssd_scan(x, dt, A, Bc, Cc)
            y2, h2 = K6.ssd_scan(x, dt, A, Bc, Cc)
            torch.cuda.synchronize()
            route = route_taken(before, counts(), "ssd_scan", SSD_ROUTES)
            want_route = K6.route_for(dt_, S, P, N)
            if route != want_route or (route in SSD_TC_ROUTES) != (
                    dtype_name == "bfloat16"):
                fail(f"ssd_scan {name} B={B} S={S} {dtype_name}: ran on "
                     f"{route}, the chooser names {want_route}")
            want_y, want_h = K6.ssd_scan_plain(x, dt, A, Bc, Cc)
            torch.cuda.synchronize()
            Q = K6.ssd_chunk_size(S, 128)
            cell = (f"ssd_scan {name} B={B} S={S} H={H} P={P} N={N} Q={Q} "
                    f"{dtype_name} ({route})")
            if not (torch.equal(y, y2) and torch.equal(h, h2)):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, y, want_y, atol, rtol)
            err_h = check_close(f"{cell} final state", h, want_h, 1e-4, 1e-4)
            t_k = timer.ms(lambda: K6.ssd_scan(x, dt, A, Bc, Cc))
            t_p = timer.ms(lambda: K6.ssd_scan_plain(x, dt, A, Bc, Cc))
            phases = ssd_phase_ms(lambda: K6.ssd_scan(x, dt, A, Bc, Cc))
            b_ms, b_by = ssd_bound(B, S, H, P, N, dtype_name)
            rows.append(dict(cell=cell, dtype=dtype_name, B=B, S=S, Q=Q,
                             route=route, path=f"{name} B{B}xS{S}",
                             uses=scfg.n_layers, max_abs_err=err,
                             state_max_abs_err=err_h, ms=t_k, plain_ms=t_p,
                             phase_ms_warm_l2=phases, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: max|d| y {err:.2e} state {err_h:.2e} kernel "
                f"{t_k:.4f} ms (by kernel, L2 warm: "
                f"{', '.join(f'{k} {v:.4f}' for k, v in phases.items())}) "
                f"plain {t_p:.4f} ms bound {b_ms:.4f} ms ({b_by}); no "
                f"library call")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------

def serve_requests(eng, prompts, limit_s):
    """Drive submit/step until every prompt has GEN_LEN tokens, cancelling
    each as it gets there. Handles are slot ids (contiguous) or request ids
    (paged); the streams are returned in prompt order."""
    pending, owner, streams = list(enumerate(prompts)), {}, {}
    decode_deltas, n_tokens = [], 0
    t0 = time.perf_counter()
    while pending or eng.slot_live.any() or eng.wait:
        while pending:
            h = eng.submit(pending[0][1])
            if h is None:
                break
            owner[h] = pending.pop(0)[0]
            streams[owner[h]] = []
        before = (counts(), eng.prefill_tokens)
        out = eng.step()
        if eng.prefill_tokens == before[1] and not eng.wait and out:
            decode_deltas.append(tuple(
                n - before[0][k] for k, n in counts().items()))
        n_tokens += len(out)
        for h, t in out.items():
            streams[owner[h]].append(t)
            if len(streams[owner[h]]) >= GEN_LEN:
                eng.cancel(h)
        if time.perf_counter() - t0 > limit_s:
            fail(f"serving did not finish within {limit_s} s")
    got = [streams.get(i, []) for i in range(len(prompts))]
    per_step = dict(zip(kernel_wrappers(), max(
        set(decode_deltas), key=decode_deltas.count))) if decode_deltas \
        else None
    return got, n_tokens, per_step


def check_streams(path, streams, vocab):
    for i, toks in enumerate(streams):
        if len(toks) < GEN_LEN or min(toks) < 0 or max(toks) >= vocab:
            fail(f"{path}: request {i} incomplete or malformed: {toks}")


def run_serving_phase(cfg):
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.kernels import matrixflow_gemm as MF
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    params = T.init_model(cfg, seed=0, device="cuda")
    sc = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype=cfg.dtype,
                     pack_weights=True,
                     attention=AttentionPolicy(backend="paged", page_size=PAGE),
                     cache_pages=CACHE_PAGES, device="cuda")
    eng = ServingEngine(cfg, params, sc)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("serving", K1_BF16 + K4_BF16)
    check_streams("serving", streams, cfg.vocab)
    if eng.n_preemptions < 1:
        fail("serving: the pool never ran dry (no preemption)")
    # the batched entry point on the same engine: one 16-token prompt per
    # slot, whose 48-token horizons fill the 24-page pool exactly
    prompts = rng.integers(0, cfg.vocab, (SLOTS, 16))
    before = MF.matrixflow_gemm_block_major.launches
    t1 = time.perf_counter()
    gen_out = eng.generate(prompts, GEN_LEN)
    gen_s = time.perf_counter() - t1
    if gen_out.shape != (SLOTS, GEN_LEN) or gen_out.min() < 0 \
            or gen_out.max() >= cfg.vocab:
        fail(f"generate: malformed output {gen_out.shape}")
    if MF.matrixflow_gemm_block_major.launches == before:
        fail("generate: the MatrixFlow kernel was never launched")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               preemptions=eng.n_preemptions, launches=launches,
               launches_per_decode_step=per_step,
               generate_tokens_per_s=SLOTS * GEN_LEN / gen_s,
               stats=eng.stats())
    log(f"serving: {N_REQUESTS} requests x {GEN_LEN} tokens, {n_tokens} "
        f"tokens in {dt:.3f} s ({res['tokens_per_s']:.1f} tok/s), peak "
        f"{res['peak_mem_gib']:.3f} GiB, {eng.n_preemptions} preemptions, "
        f"launches {launches}, per decode step {per_step}; generate() "
        f"{SLOTS}x{GEN_LEN} tokens in {gen_s:.3f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 4: kernel path (card) vs plain path (CPU), full width, fp32
# ---------------------------------------------------------------------------

def greedy_run(cfg, params, device, prompts, n_steps, kv_dtype=None):
    from repro_torch.core import api
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.models import transformer as T

    B, S = prompts.shape
    nb = MAX_LEN // PAGE
    caches = T.init_paged_caches(cfg, B, B * nb, PAGE, "float32", device,
                                 kv_dtype=kv_dtype)
    bt = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb).to(device)
    logits_all, toks = [], []
    with torch.no_grad(), api.use_attention_policy(
            AttentionPolicy(backend="paged", page_size=PAGE)):
        batch = {"tokens": torch.from_numpy(prompts).to(device),
                 "positions": torch.arange(S).expand(B, S).to(device),
                 "block_tables": bt}
        last = torch.full((B,), S - 1, device=device)
        logits, _ = T.forward(params, cfg, batch, caches=caches,
                              last_cols=last)
        for i in range(n_steps + 1):
            lg = logits[:, -1].float().cpu()
            logits_all.append(lg)
            tok = lg.argmax(-1)
            toks.append(tok)
            if i == n_steps:
                break
            batch = {"tokens": tok[:, None].to(device),
                     "positions": torch.full((B, 1), S + i).to(device),
                     "block_tables": bt}
            logits, _ = T.forward(params, cfg, batch, caches=caches)
    return torch.stack(toks, 1), logits_all


def run_parity_phase(cfg):
    from repro_torch.core.api import pack_model_weights
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu_params = pack_model_weights(T.init_model(cfg32, seed=3, device="cpu"))
    gpu_params = T.init_model(cfg32, seed=3, device="cuda")
    gpu_params = pack_model_weights(gpu_params)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24))
    n_steps = 8
    t0 = time.perf_counter()
    toks_g, lg_g = greedy_run(cfg32, gpu_params, "cuda", prompts, n_steps)
    toks_c, lg_c = greedy_run(cfg32, cpu_params, "cpu", prompts, n_steps)
    errs = [float((a - b).abs().max()) for a, b in zip(lg_g, lg_c)]
    for i, name in ((0, "prefill"), (1, "first decode")):
        if not np.isfinite(errs[i]) or errs[i] > LOGIT_TOL:
            fail(f"parity: {name} logits max |kernel - plain| = {errs[i]:.3e}"
                 f" > {LOGIT_TOL}")
    diverged = None
    for b in range(toks_g.shape[0]):
        for i in range(toks_g.shape[1]):
            if int(toks_g[b, i]) != int(toks_c[b, i]):
                top2 = lg_c[i][b].topk(2).values
                margin = float(top2[0] - top2[1])
                if margin >= LOGIT_TOL:
                    fail(f"parity: greedy streams diverge at row {b} step {i} "
                         f"with plain top-2 margin {margin:.3e} >= {LOGIT_TOL}")
                diverged = dict(row=b, step=i, margin=margin)
                break
    res = dict(logit_max_abs_err=errs, streams_equal=diverged is None,
               first_divergence=diverged, seconds=time.perf_counter() - t0)
    log(f"parity fp32 full width: logits max|d| per step "
        f"{[f'{e:.2e}' for e in errs]}; streams "
        f"{'equal' if diverged is None else f'diverge at a near-tie {diverged}'}")
    return res


# ---------------------------------------------------------------------------
# Phase 5: the BERT/ViT encoders
# ---------------------------------------------------------------------------

def encoder_batch(ecfg, B, S, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    if ecfg.family == "vit":      # stub patch embeddings, as the reference
        return {"embeds": torch.randn((B, S, ecfg.d_model), generator=gen)
                .to(device=device, dtype=dtype)}
    return {"tokens": torch.randint(0, ecfg.vocab, (B, S), generator=gen)
            .to(device)}


def run_encoder_phase(bert, vit):
    from repro_torch.core.api import pack_model_weights
    from repro_torch.models import transformer as T

    res = {}
    for ecfg, S in ((bert, BERT_SEQ), (vit, VIT_SEQ)):
        params = pack_model_weights(T.init_model(ecfg, seed=5, device="cuda"))
        batch = encoder_batch(ecfg, ENC_BATCH, S, ecfg.param_dtype, "cuda", 5)
        with torch.no_grad():
            T.encoder_forward(params, ecfg, batch)       # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            logits = T.encoder_forward(params, ecfg, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts(f"encoder {ecfg.name}",
                             ("matrixflow_gemm", "matrixflow_gemm_wgmma",
                              "flash_attention", "flash_attention_rows"))
        if tuple(logits.shape) != (ENC_BATCH, S, ecfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"encoder {ecfg.name}: logits {tuple(logits.shape)} "
                 f"malformed or not finite")
        res[ecfg.name] = dict(batch=ENC_BATCH, seq=S, dtype=ecfg.dtype,
                              forward_wall_ms=wall_ms, launches=counts)
        log(f"encoder {ecfg.name} {ecfg.dtype} B={ENC_BATCH} S={S}: forward "
            f"{wall_ms:.3f} ms (host clock), launches {counts}")
    # fp32 parity: the kernel path on the card against the plain path on
    # the CPU, the same seeded weights
    cfg32 = dataclasses.replace(bert, dtype="float32")
    batch = encoder_batch(cfg32, PARITY_BATCH, BERT_SEQ, torch.float32,
                          "cpu", 6)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = {}
        for device in ("cuda", "cpu"):
            params = pack_model_weights(T.init_model(cfg32, seed=6,
                                                     device=device))
            out[device] = T.encoder_forward(
                params, cfg32, {k: v.to(device) for k, v in batch.items()}
            ).cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    if not np.isfinite(err) or err > LOGIT_TOL:
        fail(f"encoder parity: bert-base fp32 logits max |kernel - plain| = "
             f"{err:.3e} > {LOGIT_TOL}")
    res["parity"] = dict(arch=bert.name, batch=PARITY_BATCH, seq=BERT_SEQ,
                         logit_max_abs_err=err,
                         seconds=time.perf_counter() - t0)
    log(f"encoder parity bert-base fp32 B={PARITY_BATCH} S={BERT_SEQ}: "
        f"logits max|d| {err:.2e} (tolerance {LOGIT_TOL})")
    return res


# ---------------------------------------------------------------------------
# Phase 6: serving from contiguous KV caches
# ---------------------------------------------------------------------------

def first_divergence(cfg32, params_cpu, prompt, a, b):
    """None if streams a and b agree; else the step where they first
    differ, failing unless the plain path's top-2 logit margin there is
    below LOGIT_TOL (a near-tie that fp32 summation order may flip)."""
    from repro_torch.models import transformer as T

    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        toks = torch.tensor([prompt + a[:i]])
        with torch.no_grad():
            logits, _ = T.forward(params_cpu, cfg32, {"tokens": toks})
        top2 = logits[0, -1].float().topk(2).values
        margin = float(top2[0] - top2[1])
        if margin >= LOGIT_TOL:
            fail(f"contiguous serving fp32: streams diverge at step {i} with "
                 f"plain top-2 margin {margin:.3e} >= {LOGIT_TOL}")
        return dict(step=i, margin=margin)
    if len(a) != len(b):
        fail(f"contiguous serving fp32: stream lengths {len(a)} != {len(b)}")
    return None


def run_contiguous_phase(cfg):
    from repro_torch.core.api import pack_model_weights
    from repro_torch.core.plan import FUSED, AttentionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    eng = ServingEngine(cfg, T.init_model(cfg, seed=0, device="cuda"),
                        ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                    cache_dtype=cfg.dtype, pack_weights=True,
                                    attention=FUSED, device="cuda"))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("contiguous serving", K1_BF16 + K3_BF16)
    check_streams("contiguous serving", streams, cfg.vocab)
    gen_prompts = rng.integers(0, cfg.vocab, (SLOTS, 16))
    reset_counts()
    t1 = time.perf_counter()
    gen_out = eng.generate(gen_prompts, GEN_LEN)
    gen_s = time.perf_counter() - t1
    gen_launches = read_counts("contiguous generate", K1_BF16 + K3_BF16)
    if gen_out.shape != (SLOTS, GEN_LEN) or gen_out.min() < 0 \
            or gen_out.max() >= cfg.vocab:
        fail(f"contiguous generate: malformed output {gen_out.shape}")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt, launches=launches,
               launches_per_decode_step=per_step,
               generate_tokens_per_s=SLOTS * GEN_LEN / gen_s,
               generate_launches=gen_launches, stats=eng.stats())
    log(f"contiguous serving: {N_REQUESTS} requests x {GEN_LEN} tokens, "
        f"{n_tokens} tokens in {dt:.3f} s ({res['tokens_per_s']:.1f} tok/s), "
        f"launches {launches}, per decode step {per_step}; generate() "
        f"{SLOTS}x{GEN_LEN} tokens in {gen_s:.3f} s")
    del eng

    # fp32: the same prompts through the contiguous engine on the card, the
    # paged engine on the card and the contiguous engine on the CPU (plain
    # versions); greedy streams must agree
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_model(cfg32, seed=8, device="cpu")
    runs = {}
    t0 = time.perf_counter()
    for name, device, attn in (
            ("fused card", "cuda", FUSED),
            ("paged card", "cuda", AttentionPolicy("paged", PAGE)),
            ("fused cpu plain", "cpu", FUSED)):
        e = ServingEngine(cfg32, params32, ServeConfig(
            batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype="float32",
            pack_weights=True, attention=attn, device=device))
        runs[name] = serve_requests(e, prompts, 600)[0]
        del e
    params_cpu = pack_model_weights(params32)
    ties = {}
    for other in ("paged card", "fused cpu plain"):
        for i, p in enumerate(prompts):
            d = first_divergence(cfg32, params_cpu, p, runs["fused card"][i],
                                 runs[other][i])
            if d is not None:
                ties[f"{other} request {i}"] = d
    res["fp32_streams"] = dict(equal=not ties, near_ties=ties,
                               seconds=time.perf_counter() - t0)
    log(f"contiguous serving fp32: streams of {N_REQUESTS} requests "
        f"{'equal' if not ties else f'equal up to near-ties {ties}'} across "
        f"fused card / paged card / CPU plain")
    return res


# ---------------------------------------------------------------------------
# Phase 7: int8 serving (W8A8 weights through K2, int8 KV pages through K5)
# ---------------------------------------------------------------------------

class QuantRecorder:
    """Every int8 quantization of a run — each W8A8 GEMM input and each KV
    write — as (fp32 values, scale, int8 payload) on the host, in call
    order."""

    def __enter__(self):
        from repro_torch.core import quant as Q
        self.Q, self.calls = Q, []
        self.saved = (Q.quantize_activations, Q.quantize_kv_rows)
        qa, qkv = self.saved

        def act(x):
            out = qa(x)
            self.calls.append((x.float().cpu(), out[1][..., None].cpu(),
                               out[0].cpu()))
            return out

        def kv(rows, scales):
            out = qkv(rows, scales)
            self.calls.append((rows.float().cpu(),
                               scales.float()[..., None].cpu(), out.cpu()))
            return out

        Q.quantize_activations, Q.quantize_kv_rows = act, kv
        return self

    def __exit__(self, *exc):
        self.Q.quantize_activations, self.Q.quantize_kv_rows = self.saved


def tie_flip(calls_a, calls_b):
    """Where two int8 runs part: the first call whose int8 payloads
    differ. Fails unless every quantization before it saw the same fp32
    values and scales up to fp32 noise (1e-5 relative) and every differing
    value there differs by one step on a .5 tie of the grid (x / s within
    1e-3 of k + 0.5): an ulp of fp32 difference rounded to another int8
    value, not a fault of the kernels."""
    if len(calls_a) != len(calls_b):
        fail(f"int8 parity: {len(calls_a)} vs {len(calls_b)} quantizations")
    for g, ((ax, as_, aq), (bx, bs, bq)) in enumerate(zip(calls_a, calls_b)):
        if ax.shape != bx.shape:
            fail(f"int8 parity: call {g} shapes {ax.shape} vs {bx.shape}")
        noise = 1e-5 * max(float(bx.abs().max()), 1.0)
        if float((ax - bx).abs().max()) > noise or not torch.allclose(
                as_, bs, rtol=1e-5, atol=0):
            fail(f"int8 parity: quantization call {g} saw fp32 values "
                 f"{float((ax - bx).abs().max()):.3e} apart before any int8 "
                 f"value differed")
        flips = aq != bq
        if bool(flips.any()):
            step = (aq[flips].int() - bq[flips].int()).abs()
            scaled = (bx / bs).expand_as(bx)[flips]
            off_tie = (scaled - scaled.trunc()).abs().sub(0.5).abs()
            if bool((step != 1).any()) or float(off_tie.max()) >= 1e-3:
                fail(f"int8 parity: call {g} rounds {int(flips.sum())} "
                     f"values differently, not one step on a .5 tie "
                     f"(largest distance from a tie {float(off_tie.max()):.3e})")
            return dict(call=g, of=len(calls_a), values=int(flips.sum()),
                        all_later=sum(int((a[2] != b[2]).sum()) for a, b in
                                      zip(calls_a[g:], calls_b[g:])))
    return None


def run_int8_serving_phase(cfg):
    """Full-width smollm-135m, bf16, paged, weight_dtype and kv_dtype int8:
    12 requests through submit/step under a 24-page pool (preemption), K2
    and K5 launched on both tensor-core routes each (K2: wgmma at
    prefill, mma at decode; K5: rows, split), none on the CUDA cores, and
    K1 and K4 not; one preempted request's stream equals its solo stream
    on the card; then fp32, the card against the CPU plain path over
    greedy_run."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    sc = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype=cfg.dtype,
                     attention=AttentionPolicy(backend="paged", page_size=PAGE),
                     cache_pages=CACHE_PAGES, weight_dtype="int8",
                     kv_dtype="int8", device="cuda")
    params = T.init_model(cfg, seed=0, device="cuda")
    eng = ServingEngine(cfg, params, sc)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    preempted = []
    preempt = eng._preempt
    eng._preempt = lambda slot: (preempted.append(int(eng.slot_rid[slot])),
                                 preempt(slot))[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("int8 serving", K2_K5_BF16)
    if launches["matrixflow_gemm"] or launches["paged_attention"]:
        fail(f"int8 serving: an fp kernel ran on the int8 path: {launches}")
    check_streams("int8 serving", streams, cfg.vocab)
    if not preempted:
        fail("int8 serving: the pool never ran dry (no preemption)")
    stats = eng.stats()
    del eng
    # request ids are given in submission order, which is prompt order
    rid = preempted[0]
    solo = ServingEngine(cfg, params, sc)
    h = solo.submit(prompts[rid])
    alone = []
    while len(alone) < GEN_LEN:
        alone.append(solo.step()[h])
    del solo
    if alone != streams[rid]:
        fail(f"int8 serving: preempted request {rid}'s stream "
             f"{streams[rid]} differs from its solo stream {alone}")
    log(f"int8 serving: {N_REQUESTS} requests x {GEN_LEN} tokens, {n_tokens} "
        f"tokens in {dt:.3f} s ({n_tokens / dt:.1f} tok/s), "
        f"{len(preempted)} preemptions, launches {launches}, per decode "
        f"step {per_step}; preempted request {rid} equals its solo stream; "
        f"pool {stats['kv_page_bytes']} B/page ({stats['kv_dtype']})")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               preemptions=len(preempted), launches=launches,
               launches_per_decode_step=per_step, solo_checked_request=rid,
               stats=stats)

    # fp32: the card's int8 path against the CPU plain path
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    prompts2 = np.random.default_rng(13).integers(0, cfg.vocab, (2, 24))
    n_steps = 8
    runs = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        p32 = pack_model_weights(T.init_model(cfg32, seed=14, device=device),
                                 quantize="int8")
        with QuantRecorder() as rec:
            toks, lg = greedy_run(cfg32, p32, device, prompts2, n_steps,
                                  kv_dtype="int8")
        runs[device] = (toks, lg, rec.calls)
        del p32
    (toks_g, lg_g, calls_g), (toks_c, lg_c, calls_c) = runs["cuda"], runs["cpu"]
    errs = [float((a - b).abs().max()) for a, b in zip(lg_g, lg_c)]
    if not all(np.isfinite(errs)):
        fail(f"int8 parity: non-finite logits {errs}")
    flip = tie_flip(calls_g, calls_c)
    parted = None
    for b in range(toks_g.shape[0]):
        i = next((i for i in range(toks_g.shape[1])
                  if int(toks_g[b, i]) != int(toks_c[b, i])), None)
        if i is None:
            continue
        top2 = lg_c[i][b].topk(2).values
        margin = float(top2[0] - top2[1])
        if margin >= LOGIT_TOL and flip is None:
            fail(f"int8 parity: greedy streams part at row {b} step {i} "
                 f"with plain top-2 margin {margin:.3e} >= {LOGIT_TOL} and "
                 f"no int8 value rounded differently")
        parted = parted or dict(row=b, step=i, margin=margin)
    res["fp32_parity"] = dict(logit_max_abs_err=errs,
                              streams_equal=parted is None,
                              first_divergence=parted, first_tie_flip=flip,
                              seconds=time.perf_counter() - t0)
    log(f"int8 parity fp32 full width (W8A8 + int8 KV): logits max|d| per "
        f"step {[f'{e:.2e}' for e in errs]}; streams "
        f"{'equal' if parted is None else f'part at {parted}'}; first int8 "
        f"value rounded differently: {flip}")
    return res


# ---------------------------------------------------------------------------
# Phases 8-10: the SSM families (Mamba-2, the Zamba-2 hybrid)
# ---------------------------------------------------------------------------

def ssm_engine(cfg, params, slots):
    """The SSM engine under the default policy, which resolves to the
    contiguous ``fused`` backend on the card for the SSD families."""
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=slots, max_len=SSM_MAX_LEN, cache_dtype=cfg.dtype,
        pack_weights=True, device="cuda"))
    if eng.attn.backend != "fused":
        fail(f"{cfg.name}: the default policy resolved to "
             f"{eng.attn.backend!r}, not 'fused'")
    return eng


def solo_stream(eng, prompt):
    h = eng.submit(prompt)
    out = [eng.step()[h] for _ in range(SSM_GEN)]
    eng.cancel(h)
    return out


def run_ssm_serving_phase(cfg, prompt_len, required, single_slot):
    """generate() of SSM_SLOTS prompts x SSM_GEN tokens at full width; with
    ``single_slot``, then the single-slot submit/step checks. Counters are
    reset before and read after the whole path."""
    from repro_torch.models import transformer as T

    params = T.init_model(cfg, seed=20, device="cuda")
    rng = np.random.default_rng(21)
    prompts = rng.integers(0, cfg.vocab, (SSM_SLOTS, prompt_len))
    eng = ssm_engine(cfg, params, SSM_SLOTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, SSM_GEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del eng
    if out.shape != (SSM_SLOTS, SSM_GEN) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        fail(f"{cfg.name} generate: malformed output {out.shape}")
    res = dict(slots=SSM_SLOTS, prompt=prompt_len, tokens=SSM_GEN,
               generate_s=gen_s, generate_tokens_per_s=out.size / gen_s)
    if single_slot:
        first, second = (rng.integers(0, cfg.vocab, n).tolist()
                         for n in SOLO_PROMPTS)
        one = ssm_engine(cfg, params, 1)
        want = one.generate(np.asarray([first]), SSM_GEN)[0].tolist()
        got = solo_stream(one, first)
        if got != want:
            fail(f"{cfg.name}: the {len(first)}-token prompt's submit/step "
                 f"stream {got} differs from generate()'s {want}")
        recycled = solo_stream(one, second)
        del one
        fresh = solo_stream(ssm_engine(cfg, params, 1), second)
        if recycled != fresh:
            fail(f"{cfg.name}: the request on the recycled slot gave "
                 f"{recycled}, its solo run on a fresh engine {fresh}")
        res.update(solo_prompts=list(SOLO_PROMPTS), submit_equals_generate=True,
                   recycled_equals_fresh=True)
    torch.cuda.synchronize()
    launches = read_counts(f"{cfg.name} serving", required)
    if launches["paged_attention"] or launches["paged_attention_int8"]:
        fail(f"{cfg.name} serving: a paged kernel ran: {launches}")
    on_tc = sum(launches[f"ssd_scan_{r}"] for r in SSD_TC_ROUTES)
    if on_tc != launches["ssd_scan"]:
        fail(f"{cfg.name} serving: {launches['ssd_scan'] - on_tc} of "
             f"{launches['ssd_scan']} K6 launches were off the tensor-core "
             f"routes {SSD_TC_ROUTES}")
    res.update(launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{cfg.name} serving bf16: generate() {SSM_SLOTS}x{prompt_len} "
        f"prompts x {SSM_GEN} tokens in {gen_s:.3f} s "
        f"({res['generate_tokens_per_s']:.1f} tok/s)"
        + (f"; single-slot submit of {SOLO_PROMPTS[0]} tokens equals "
           f"generate(), the {SOLO_PROMPTS[1]}-token request on the recycled "
           f"slot equals its fresh solo run" if single_slot else "")
        + f"; launches {launches}; peak {res['peak_mem_gib']:.2f} GiB")
    return res


def ssm_greedy_run(cfg, params, device, prompts, n_steps, feed=None):
    """Prefill then ``n_steps`` decode steps over contiguous caches (fused
    policy). Each step is fed ``feed[:, i]`` when given (the same tokens on
    both devices), else its own argmax. Returns (argmax (B, n_steps + 1),
    the last-position logits of every step on the CPU)."""
    from repro_torch.core import api
    from repro_torch.core.plan import FUSED
    from repro_torch.models import transformer as T

    B, S = prompts.shape
    caches = T.init_caches(cfg, B, S + n_steps + 1, "float32", device)
    toks, logits_all = [], []
    with torch.no_grad(), api.use_attention_policy(FUSED):
        batch = {"tokens": torch.from_numpy(prompts).to(device),
                 "positions": torch.arange(S).expand(B, S).to(device)}
        logits, _ = T.forward(params, cfg, batch, caches=caches,
                              last_cols=torch.full((B,), S - 1, device=device))
        for i in range(n_steps + 1):
            lg = logits[:, -1].float().cpu()
            logits_all.append(lg)
            toks.append(lg.argmax(-1))
            if i == n_steps:
                break
            nxt = toks[-1] if feed is None else feed[:, i]
            batch = {"tokens": nxt[:, None].to(device),
                     "positions": torch.full((B, 1), S + i).to(device)}
            logits, _ = T.forward(params, cfg, batch, caches=caches)
    return torch.stack(toks, 1), logits_all


def run_ssm_parity_phase(cfg):
    """fp32, full width cut in depth: the card's kernels against the CPU's
    plain versions on the same seeded weights and tokens."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.models import transformer as T

    n_layers, S = SSM_PARITY[cfg.name]
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers)
    prompts = np.random.default_rng(22).integers(0, cfg.vocab, (2, S))
    t0 = time.perf_counter()
    params = pack_model_weights(T.init_model(cfg32, seed=23, device="cpu"))
    toks_c, lg_c = ssm_greedy_run(cfg32, params, "cpu", prompts,
                                  SSM_PARITY_STEPS)
    params = pack_model_weights(T.init_model(cfg32, seed=23, device="cuda"))
    toks_g, lg_g = ssm_greedy_run(cfg32, params, "cuda", prompts,
                                  SSM_PARITY_STEPS, feed=toks_c)
    del params
    errs, ties = [], []
    for i, (g, c) in enumerate(zip(lg_g, lg_c)):
        errs.append(float((g - c).abs().max()))
        if not np.isfinite(errs[-1]) or errs[-1] > LOGIT_TOL:
            fail(f"{cfg.name} parity fp32: step {i} logits max |card - plain| "
                 f"= {errs[-1]:.3e} > {LOGIT_TOL}")
        for b in range(g.shape[0]):
            if int(toks_g[b, i]) != int(toks_c[b, i]):
                top2 = c[b].topk(2).values
                margin = float(top2[0] - top2[1])
                if margin >= LOGIT_TOL:
                    fail(f"{cfg.name} parity fp32: greedy tokens differ at row "
                         f"{b} step {i} with plain top-2 margin {margin:.3e} "
                         f">= {LOGIT_TOL}")
                ties.append(dict(row=b, step=i, margin=margin))
    res = dict(layers=n_layers, prompt=S, steps=SSM_PARITY_STEPS,
               logit_max_abs_err=errs, streams_equal=not ties, near_ties=ties,
               seconds=time.perf_counter() - t0)
    log(f"{cfg.name} parity fp32, {n_layers} layers at full width, 2 x {S} "
        f"tokens + {SSM_PARITY_STEPS} steps: logits max|d| per step "
        f"{[f'{e:.2e}' for e in errs]}; greedy streams "
        f"{'equal' if not ties else f'equal but at near-ties {ties}'}")
    return res


def aggregate(rows, dtype, path="decode step"):
    """Per run of ``path`` (a decode step, an encoder forward): each of its
    cells weighted by its uses per run."""
    sel = [r for r in rows if r["dtype"] == dtype and r["path"] == path]
    tot = {k: sum(r[k] * r["uses"] for r in sel)
           for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in sel]
    tot["library_ms"] = None if None in lib else sum(
        t * r["uses"] for t, r in zip(lib, sel))
    by = sum(r["uses"] * r["bound_ms"] for r in sel
             if r["bound_by"] == "bytes")
    tot["bound_by"] = "bytes" if by >= tot["bound_ms"] / 2 else "operations"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows
                             if r["dtype"] == dtype)
    return tot


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no answer"
    print(card, flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    build_logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in build_logs.items()))
    log(f"build: {sorted(build_logs) or 'cached'} in {report['build_s']:.1f} s")

    cfg = get_config(ARCH)
    bert, vit = get_config("bert-base"), get_config("vit-base")
    mamba, zamba = get_config(MAMBA), get_config(ZAMBA)
    timer = Timer()
    report["gemm"] = run_gemm_phase(timer, cfg, bert, vit, (mamba, zamba))
    report["attention"] = run_attention_phase(timer, cfg)
    report["flash"] = run_flash_phase(timer, flash_cells(
        cfg, bert, vit, get_config("vit-huge"), zamba,
        np.random.default_rng(3)))
    report["quant_gemm"] = run_quant_gemm_phase(timer, cfg, bert, vit)
    report["int8_attention"] = run_int8_attention_phase(timer, cfg)
    report["ssd"] = run_ssd_phase(timer, mamba, zamba)
    del timer
    report["serving"] = run_serving_phase(cfg)
    report["parity"] = run_parity_phase(cfg)
    report["encoders"] = run_encoder_phase(bert, vit)
    report["contiguous"] = run_contiguous_phase(cfg)
    report["int8_serving"] = run_int8_serving_phase(cfg)
    report["mamba2_serving"] = run_ssm_serving_phase(
        mamba, MAMBA_PROMPT, K1_BF16 + K6_BF16, True)
    report["zamba2_serving"] = run_ssm_serving_phase(
        zamba, ZAMBA_PROMPT, K1_BF16 + K3_BF16 + K6_BF16, False)
    report["ssm_parity"] = {c.name: run_ssm_parity_phase(c)
                            for c in (mamba, zamba)}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    by_path = {"paged serving": report["serving"]["launches"],
               **{f"{n} forward": report["encoders"][n]["launches"]
                  for n in (bert.name, vit.name)},
               "contiguous serving": report["contiguous"]["launches"],
               "int8 paged serving": report["int8_serving"]["launches"],
               f"{MAMBA} serving": report["mamba2_serving"]["launches"],
               f"{ZAMBA} serving": report["zamba2_serving"]["launches"]}

    def entry(name, source, replaces, rows, path, other_paths):
        launches = {p: c[name] for p, c in by_path.items() if c[name]}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "times_per": path,
                **aggregate(rows, "bfloat16", path),
                "other_runs": {p: aggregate(rows, "bfloat16", p)
                               for p in other_paths}}

    ssd_paths = sorted({r["path"] for r in report["ssd"]})
    main_ssd = f"{MAMBA} generate prefill B{SSM_SLOTS}xS{MAMBA_PROMPT}"
    def on_route(route, phase="gemm"):
        return [r for r in report[phase] if r["route"] == route]

    k1 = entry("matrixflow_gemm", "matrixflow_gemm",
               "src/repro/kernels/matrixflow_gemm.py:137", report["gemm"],
               "decode step", (f"{bert.name} forward", f"{vit.name} forward",
                               f"{MAMBA} decode step", f"{MAMBA} prefill",
                               f"{ZAMBA} decode step"))
    k1["launches_by_route"] = {
        r: sum(c[f"matrixflow_gemm_{r}"] for c in by_path.values())
        for r in ("wgmma", "mma", "cuda_core")}
    by_route = {
        k: {r: sum(c[f"{k}_{r}"] for c in by_path.values()) for r in routes}
        for k, routes in (("flash_attention", ATTN_ROUTES),
                          ("paged_attention", ATTN_ROUTES),
                          ("paged_attention_int8", ATTN_ROUTES),
                          ("matrixflow_gemm_dequant", K2_ROUTES),
                          ("ssd_scan", SSD_ROUTES))}
    kernels = [
        k1,
        entry("matrixflow_gemm_wgmma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:137", on_route("wgmma"),
              f"{bert.name} forward", (f"{vit.name} forward", "prefill",
                                       f"{MAMBA} prefill")),
        entry("matrixflow_gemm_mma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:137", on_route("mma"),
              "decode step", (f"{MAMBA} decode step", f"{ZAMBA} decode step")),
        entry("matrixflow_gemm_dequant", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:154",
              report["quant_gemm"], "decode step",
              ("prefill", f"{bert.name} forward")),
        entry("matrixflow_gemm_dequant_wgmma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:154",
              on_route("wgmma", "quant_gemm"), f"{bert.name} forward",
              ("prefill",)),
        entry("matrixflow_gemm_dequant_mma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:154",
              on_route("mma", "quant_gemm"), "decode step", ()),
        entry("flash_attention", "flash_attention",
              "src/repro/kernels/flash_attention.py:199", report["flash"],
              f"{bert.name} forward", (f"{vit.name} forward", "decode step",
                                       "zamba2 prefill", "zamba2 decode step")),
        entry("flash_attention_rows", "flash_attention",
              "src/repro/kernels/flash_attention.py:199",
              on_route("rows", "flash"), f"{bert.name} forward",
              (f"{vit.name} forward", "vit-huge forward", "prefill", "chunk",
               "zamba2 prefill")),
        entry("flash_attention_split", "flash_attention",
              "src/repro/kernels/flash_attention.py:199",
              on_route("split", "flash"), "decode step",
              ("zamba2 decode step",)),
        entry("paged_attention", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              report["attention"], "decode step", ("prefill",)),
        entry("paged_attention_rows", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              on_route("rows", "attention"), "prefill", ()),
        entry("paged_attention_split", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              on_route("split", "attention"), "decode step",
              ("decode step, edge lengths",)),
        entry("paged_attention_int8", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              report["int8_attention"], "decode step", ("prefill", "chunk")),
        entry("paged_attention_int8_split", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              on_route("split", "int8_attention"), "decode step", ()),
        entry("paged_attention_int8_rows", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              on_route("rows", "int8_attention"), "prefill", ("chunk",)),
        entry("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:117",
              report["ssd"], main_ssd,
              [p for p in ssd_paths if p != main_ssd]),
    ]
    for k in kernels:
        if k["name"] in by_route:
            k["launches_by_route"] = by_route[k["name"]]
    # K6 per route: ms per run of each path the route takes, and per kernel
    # (phase) of a call, bf16
    k6 = next(k for k in kernels if k["name"] == "ssd_scan")
    k6["ms_by_route"] = {
        r: {p: aggregate(sel, "bfloat16", p)["ms"]
            for p in sorted({row["path"] for row in sel})}
        for r in SSD_TC_ROUTES
        for sel in [[row for row in report["ssd"] if row["route"] == r
                     and row["dtype"] == "bfloat16"]]}
    k6["phase_ms_per_call_warm_l2"] = {
        row["path"]: row["phase_ms_warm_l2"] for row in report["ssd"]
        if row["dtype"] == "bfloat16"}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
