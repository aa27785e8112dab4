"""Serving launcher of the port: batched generate plus continuous
batching, on the GPU by default (``repro/launch/serve.py``).

Usage:
  python -m repro_torch.launch.serve --arch smollm-135m \
      --n-requests 8 --prompt-len 16 --gen-len 24 --pack-weights
  python -m repro_torch.launch.serve --arch smollm-135m \
      --attn-backend fused          # contiguous KV caches, flash kernel
  python -m repro_torch.launch.serve --arch smollm-135m \
      --weight-dtype int8 --kv-dtype int8   # W8A8 GEMMs, int8 KV pages
  python -m repro_torch.launch.serve --arch smollm-135m --smoke \
      --device cpu --max-len 64     # plain versions of the kernels, on CPU
  python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --batch-slots 1               # Mamba-2 (the SSD kernel), contiguous
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.plan import AttentionPolicy, GemmPolicy
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import Scheduler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gemm-backend", default="auto",
                    help="GEMM backend (auto|matrixflow|blockflow|torch)")
    ap.add_argument("--gemm-mode", default="auto",
                    choices=["auto", "dc", "dm"],
                    help="paper access mode; auto = per-shape sysmodel pick")
    ap.add_argument("--pack-weights", action="store_true",
                    help="lay weights out block-major once (resident)")
    ap.add_argument("--weight-dtype", default=None, choices=["int8"],
                    help="int8 → the W8A8 GEMM route: weights quantized "
                         "per channel at pack time and held resident")
    ap.add_argument("--attn-backend", default=None,
                    choices=["auto", "fused", "paged", "unfused"],
                    help="paged = page-pool KV cache, page-bound admission "
                         "and preemption (the paged kernel); fused = "
                         "contiguous (slots, max_len) KV caches through the "
                         "flash kernel, slot-bound admission; unfused = the "
                         "plain masked softmax over contiguous caches; auto "
                         "= paged on a GPU (fused for SSM/hybrid archs), "
                         "unfused on the CPU. Default: paged, or auto for "
                         "the SSM/hybrid archs, whose state cannot be paged")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged: tokens per KV page (the paged kernel's "
                         "key block)")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="paged only: int8 → int8 KV pages with one fp32 "
                         "scale per (page, kv head), dequantized inside the "
                         "paged kernel")
    ap.add_argument("--cache-pages", type=int, default=None,
                    help="paged: total pages in the KV pool; default = "
                         "batch_slots * ceil(max_len / page_size). Smaller "
                         "values oversubscribe (page-bound admission + "
                         "preemption)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens of prefill per engine step (chunked "
                         "prefill); default: whole prompt at submit")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    pageable = cfg.family not in T.SSD_FAMILIES
    backend = args.attn_backend or ("paged" if pageable else "auto")
    if args.kv_dtype and backend != "paged":
        ap.error("--kv-dtype requires the paged attention backend "
                 "(--attn-backend paged)")

    policy = GemmPolicy(backend=args.gemm_backend, mode=args.gemm_mode)
    attn = AttentionPolicy(backend=backend, page_size=args.page_size)
    scheduler = (Scheduler(prefill_chunk=args.prefill_chunk)
                 if args.prefill_chunk else None)
    params = T.init_model(cfg, seed=args.seed, device=args.device)
    sc = ServeConfig(
        batch_slots=args.batch_slots, max_len=args.max_len,
        temperature=args.temperature, cache_dtype=cfg.dtype, gemm=policy,
        attention=attn, pack_weights=args.pack_weights,
        weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype,
        cache_pages=args.cache_pages, scheduler=scheduler,
        device=args.device)
    engine = ServingEngine(cfg, params, sc)
    dev = engine.device
    print(f"[serve] arch={cfg.name} device={dev} slots={args.batch_slots} "
          f"max_len={args.max_len} gemm={policy.resolved_backend(dev)}/"
          f"{policy.mode} attn={engine.attn.backend} "
          f"page_size={args.page_size} packed={args.pack_weights} "
          f"weight_dtype={args.weight_dtype} kv_dtype={args.kv_dtype}")
    gen = (torch.Generator().manual_seed(args.seed)
           if args.temperature > 0 else None)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch_slots, args.prompt_len))
    _sync(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen_len, generator=gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] batched generate: {out.shape} in {dt:.2f}s "
          f"({args.batch_slots * args.gen_len / dt:.1f} tok/s)")

    # slot admission needs position-masked cache updates; SSM/hybrid
    # recurrent state has none, so multi-slot submit() is refused
    if cfg.family in T.SSD_FAMILIES and args.batch_slots > 1:
        print("[serve] continuous batching skipped: ssm/hybrid families "
              "support slot admission only with --batch-slots 1")
        return 0
    lo = max(1, min(4, args.prompt_len))
    pending = [rng.integers(0, cfg.vocab,
                            rng.integers(lo, args.prompt_len + 1)).tolist()
               for _ in range(args.n_requests)]
    streams = {}            # handle (request id, or slot id) → its tokens
    done_tokens = 0
    t0 = time.perf_counter()
    while pending or engine.slot_live.any() or engine.wait:
        while pending:
            handle = engine.submit(pending[0], generator=gen)
            if handle is None:
                break
            streams[handle] = []
            pending.pop(0)
        out = engine.step(generator=gen)
        done_tokens += len(out)
        for handle, tok in out.items():
            streams[handle].append(tok)
            if len(streams[handle]) >= args.gen_len:
                engine.cancel(handle)       # done: free its slot (and pages)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] continuous batching: {args.n_requests} requests, "
          f"{done_tokens} tokens in {dt:.2f}s "
          f"({done_tokens / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] stats: {engine.stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
