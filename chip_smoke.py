#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each fatal on failure:

1. build   — compile csrc/matrixflow_gemm.cu and csrc/paged_attention.cu
             with nvcc for sm_90a, both at once.
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (full-width smollm-135m: every
             projection at M = batch_slots and M = slots x prompt bucket,
             bf16 and fp32; paged attention at H=9, Hkv=3, D=64, page 16,
             decode and a bucketed prefill over shuffled block tables).
             Times the kernel, the plain version and one PyTorch call for
             the same function (torch.matmul; SDPA over gathered pages).
3. serving — full-width smollm-135m in bf16 from seeded random weights,
             served through ServingEngine.submit/step: more requests than
             slots, a pool small enough to preempt. Both kernels' launch
             counters must grow and every request must complete. Then one
             batched generate() on the same engine.
4. parity  — full width in fp32: the kernel path on the card against the
             plain path (the same code on the CPU, where every wrapper runs
             its plain version): prefill and first-decode logits within
             LOGIT_TOL, greedy streams equal or first diverging where the
             plain path's top-2 margin is below LOGIT_TOL.

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Exits non-zero, printing no result, without a
GPU or outside a checkout.
"""
from __future__ import annotations

import dataclasses
import json
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

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s per dtype.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# The main path: full-width smollm-135m serving.
ARCH = "smollm-135m"
SLOTS = 8
MAX_LEN = 256
PAGE = 16
PROMPT_BUCKET = 64           # prompts of 16..64 tokens → a 64-column bucket
N_REQUESTS = 12
GEN_LEN = 32
CACHE_PAGES = 24             # < 8 slots x 6 pages: decode growth preempts


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Timer:
    """Device time of one call, averaged over `iters` calls, each after an
    L2 flush (the serving path meets its weights cold: 270 MB of bf16
    weights per decode step against a 50 MB L2). Before each timed call
    the card spins for twice the host time the call takes to enqueue its
    work, so the start event fires only once all of it is queued: the
    interval is device time, not host overhead."""

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
        spin_cycles = int(2 * enqueue_s * 2e9) + 100_000   # ~2 GHz SM clock
        total = 0.0
        for _ in range(self.iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(spin_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.iters


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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

def gemm_cells(cfg):
    """(name, M, K, N, uses per decode step) of every projection."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd, L = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.n_layers
    layer = [("q/o", d, qd, 2 * L), ("k/v", d, kvd, 2 * L),
             ("mlp-in", d, 2 * f, L), ("mlp-out", f, d, L)]
    cells = [(f"decode {n}", SLOTS, K, N, c) for n, K, N, c in layer]
    cells.append(("head", SLOTS, d, V, 1))   # prefill reads last columns too
    cells += [(f"prefill {n}", SLOTS * PROMPT_BUCKET, K, N, 0)
              for n, K, N, _ in layer]
    return cells


def run_gemm_phase(timer, cfg):
    from repro_torch.core import layout as L
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, pack_weight
    from repro_torch.kernels import matrixflow_gemm as MF

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = GEMM_TOLS[dtype_name]
        for name, M, K, N, per_step in gemm_cells(cfg):
            a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            pw = pack_weight(w, GemmPolicy())          # as the engine packs
            blk = layout_for_packed(M, pw)
            a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
            got = MF.matrixflow_gemm_block_major(a_bm, pw.data, out_dtype=dt)
            want = MF.plain(a_bm, pw.data, out_dtype=dt)
            torch.cuda.synchronize()
            cell = f"matrixflow_gemm {name} M={M} K={K} N={N} {dtype_name}"
            err = check_close(cell, got, want, atol, rtol)
            t_k = timer.ms(lambda: MF.matrixflow_gemm_block_major(
                a_bm, pw.data, out_dtype=dt))
            t_p = timer.ms(lambda: MF.plain(a_bm, pw.data, out_dtype=dt))
            t_lib = timer.ms(lambda: torch.matmul(a, w))
            nbytes = (M * K + K * N + M * N) * dt.itemsize
            b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K, dtype_name)
            rows.append(dict(cell=cell, dtype=dtype_name, M=M, K=K, N=N,
                             block=[blk.bm, blk.bn, blk.bk],
                             per_decode_step=per_step, max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: blocks {blk.bm}x{blk.bn}x{blk.bk} max|d|={err:.2e} "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms matmul {t_lib:.4f} "
                f"ms bound {b_ms:.4f} ms ({b_by})")
    return rows


def paged_case(gen, dt, *, B, Sq, lens, q_start, H, Hkv, D, ps, nb):
    """Shuffled block tables over a pool with garbage distractor pages;
    row b holds lens[b] keys; its queries sit at q_start[b] + s (-1 past
    the row's real queries, as bucketed prefill pads)."""
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
    return q, kp, vp, tables, qpos, kvl


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
        cases = [
            ("decode", 1, dec_lens, [n - 1 for n in dec_lens], cfg.n_layers),
            ("prefill", PROMPT_BUCKET, pf_lens, [0] * SLOTS, 0),
        ]
        for name, Sq, lens, q_start, per_step in cases:
            q, kp, vp, bt, qpos, kvl = paged_case(
                gen, dt, B=SLOTS, Sq=Sq, lens=lens, q_start=q_start,
                H=H, Hkv=Hkv, D=D, ps=PAGE, nb=nb)
            scale = D ** -0.5
            got = PA.paged_attention(q, kp, vp, bt, qpos, kvl)
            want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl,
                                            causal=True, scale=scale,
                                            soft_cap=None)
            torch.cuda.synchronize()
            cell = f"paged_attention {name} B={SLOTS} Sq={Sq} {dtype_name}"
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
            t_k = timer.ms(lambda: PA.paged_attention(q, kp, vp, bt, qpos, kvl))
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
                             per_decode_step=per_step, max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------

def run_serving_phase(cfg):
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.kernels import matrixflow_gemm as MF
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    params = T.init_model(cfg, seed=0, device="cuda")
    sc = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype=cfg.dtype,
                     pack_weights=True,
                     attention=AttentionPolicy(backend="paged", page_size=PAGE),
                     cache_pages=CACHE_PAGES, device="cuda")
    eng = ServingEngine(cfg, params, sc)
    rng = np.random.default_rng(2)
    pending = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MF.matrixflow_gemm_block_major.launches = 0
    PA.paged_attention.launches = 0
    done, n_tokens, decode_deltas = {}, 0, []
    t0 = time.perf_counter()
    while pending or eng.slot_live.any() or eng.wait:
        while pending:
            rid = eng.submit(pending[0])
            if rid is None:
                break
            pending.pop(0)
        before = (MF.matrixflow_gemm_block_major.launches,
                  PA.paged_attention.launches, eng.prefill_tokens)
        out = eng.step()
        if eng.prefill_tokens == before[2] and not eng.wait and out:
            decode_deltas.append(
                (MF.matrixflow_gemm_block_major.launches - before[0],
                 PA.paged_attention.launches - before[1]))
        n_tokens += len(out)
        for rid in list(out):
            if len(eng.request_out[rid]) >= GEN_LEN:
                done[rid] = list(eng.request_out[rid])
                eng.cancel(rid)
        if time.perf_counter() - t0 > 300:
            fail("serving phase did not finish within 300 s")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"matrixflow_gemm": MF.matrixflow_gemm_block_major.launches,
                "paged_attention": PA.paged_attention.launches}
    if len(done) != N_REQUESTS:
        fail(f"serving: {len(done)} of {N_REQUESTS} requests completed")
    if eng.n_preemptions < 1:
        fail("serving: the pool never ran dry (no preemption)")
    for name, n in launches.items():
        if n <= 0:
            fail(f"serving: kernel {name} was never launched")
    for rid, toks in done.items():
        if len(toks) < GEN_LEN or min(toks) < 0 or max(toks) >= cfg.vocab:
            fail(f"serving: request {rid} stream malformed: {toks}")
    per_step = max(set(decode_deltas), key=decode_deltas.count) \
        if decode_deltas else (None, None)
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
               launches_per_decode_step={"matrixflow_gemm": per_step[0],
                                         "paged_attention": per_step[1]},
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

def greedy_run(cfg, params, device, prompts, n_steps):
    from repro_torch.core import api
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.models import transformer as T

    B, S = prompts.shape
    nb = MAX_LEN // PAGE
    caches = T.init_paged_caches(cfg, B, B * nb, PAGE, "float32", device)
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


def aggregate(rows, dtype):
    """Per decode step: each decode cell weighted by its uses per step."""
    sel = [r for r in rows if r["dtype"] == dtype and r["per_decode_step"]]
    tot = {k: sum(r[k] * r["per_decode_step"] for r in sel)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = sum(r["per_decode_step"] * r["bound_ms"] for r in sel
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
    timer = Timer()
    report["gemm"] = run_gemm_phase(timer, cfg)
    report["attention"] = run_attention_phase(timer, cfg)
    report["serving"] = run_serving_phase(cfg)
    report["parity"] = run_parity_phase(cfg)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    launches = report["serving"]["launches"]
    g, a = aggregate(report["gemm"], cfg.dtype), \
        aggregate(report["attention"], cfg.dtype)
    kernels = [
        {"name": "matrixflow_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/matrixflow_gemm.cu",
         "replaces": "src/repro/kernels/matrixflow_gemm.py:137",
         "launches": launches["matrixflow_gemm"], **g},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:188",
         "launches": launches["paged_attention"], **a},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
