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
  python -m repro_torch.launch.serve --arch smollm-135m \
      --prefix-cache --shared-prefix-len 32 --spec ngram \
      --async-demo 8 --trace-out trace.json --metrics-json metrics.json
  python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu \
      --tp 2                        # tensor parallel over two local ranks

``--tp N`` starts N local ranks itself (one gloo group,
``distributed/launch.py``; on the card every rank runs on ``cuda:0``),
serves on a (1, N) ``make_host_mesh`` — the same requests on every rank —
and only rank 0 prints.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.plan import AttentionPolicy, GemmPolicy
from repro_torch.distributed.launch import run_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.frontend import AsyncServingEngine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.spec_decode import make_drafter


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
                         "= paged on a GPU (fused for SSM/hybrid archs and "
                         "MLA), unfused on the CPU. Default: paged, or auto "
                         "for the SSM/hybrid archs and MLA (deepseek-v2), "
                         "whose state cannot be paged")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged only: share full prompt-prefix KV pages "
                         "across requests (copy-on-write radix cache)")
    ap.add_argument("--prefix-watermark", type=int, default=0,
                    help="with --prefix-cache: evict cold cached entries "
                         "each step until this many pool pages are free "
                         "(0 = evict only on demand)")
    ap.add_argument("--spec", default=None, metavar="DRAFTER",
                    help="speculative decoding on the continuous-batching "
                         "path: 'ngram' (prompt-lookup self-speculation) or "
                         "'draft:<arch>' (a registry draft model on the same "
                         "device) — greedy only; step() then emits bursts "
                         "of verified tokens")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="with --spec: draft budget per request per step")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="continuous-batching workload: prepend this many "
                         "shared tokens to every prompt (the system-prompt "
                         "traffic the prefix cache serves)")
    ap.add_argument("--async-demo", type=int, default=0, metavar="N",
                    help="also run N concurrent requests through the "
                         "AsyncServingEngine streaming frontend")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable observability and write a Perfetto/Chrome "
                         "trace of the serving engines to PATH")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="enable observability and write the metrics "
                         "registry snapshot to PATH as JSON")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallel: start this many local ranks and "
                         "serve on a mesh with a model axis of this size "
                         "(heads, d_ff and vocab shard where they divide)")
    args = ap.parse_args(argv)
    if args.tp > 1 and (args.pack_weights or args.weight_dtype):
        ap.error("--tp: resident packed weights (--pack-weights, "
                 "--weight-dtype) have no rank slice")
    if args.tp > 1 and not dist.is_initialized():
        return run_cli("repro_torch.launch.serve",
                       sys.argv[1:] if argv is None else argv, args.tp)
    mesh = make_host_mesh(model=args.tp) if args.tp > 1 else None
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    pageable = cfg.family not in T.SSD_FAMILIES and not cfg.is_mla
    backend = args.attn_backend or ("paged" if pageable else "auto")
    if args.kv_dtype and backend != "paged":
        ap.error("--kv-dtype requires the paged attention backend "
                 "(--attn-backend paged)")
    if args.prefix_cache and backend != "paged":
        ap.error("--prefix-cache requires the paged attention backend "
                 "(--attn-backend paged)")
    if args.spec and args.temperature > 0:
        ap.error("--spec requires greedy sampling (--temperature 0)")
    if args.spec and not pageable:
        ap.error("--spec requires position-masked cache writes; the "
                 "ssm/hybrid families' recurrent state has none")

    policy = GemmPolicy(backend=args.gemm_backend, mode=args.gemm_mode)
    attn = AttentionPolicy(backend=backend, page_size=args.page_size)
    scheduler = (Scheduler(prefill_chunk=args.prefill_chunk)
                 if args.prefill_chunk else None)
    params = T.init_model(cfg, seed=args.seed, device=args.device)
    # one recorder across the continuous-batching and async engines: their
    # phase spans land on shared tracks, request ids on async tracks
    obs = (Observability() if (args.trace_out or args.metrics_json)
           else NULL_OBS)
    spec = None
    if args.spec:
        spec = make_drafter(args.spec, k=args.spec_k, max_len=args.max_len,
                            smoke=args.smoke, seed=args.seed + 1,
                            device=args.device,
                            pack_weights=args.pack_weights)
        print(f"[serve] speculative decoding: {args.spec} k={args.spec_k}")
    sc = ServeConfig(
        batch_slots=args.batch_slots, max_len=args.max_len,
        temperature=args.temperature, cache_dtype=cfg.dtype, gemm=policy,
        attention=attn, pack_weights=args.pack_weights,
        weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype,
        cache_pages=args.cache_pages, scheduler=scheduler,
        prefix_cache=args.prefix_cache,
        prefix_watermark=args.prefix_watermark, spec=spec, obs=obs,
        device=args.device, mesh=mesh)
    engine = ServingEngine(cfg, params, sc)
    dev = engine.device
    print(f"[serve] arch={cfg.name} device={dev} slots={args.batch_slots} "
          f"max_len={args.max_len} gemm={policy.resolved_backend(dev)}/"
          f"{policy.mode} attn={engine.attn.backend} "
          f"page_size={args.page_size} packed={args.pack_weights} "
          f"weight_dtype={args.weight_dtype} kv_dtype={args.kv_dtype} "
          f"prefix_cache={args.prefix_cache}"
          + (f" tp={args.tp} kv_shards={engine.kv_shards()}" if mesh else ""))
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
        _write_obs(args, obs)
        return 0
    lo = max(1, min(4, args.prompt_len))
    shared = rng.integers(0, cfg.vocab, args.shared_prefix_len).tolist()
    pending = [shared + rng.integers(0, cfg.vocab,
                                     rng.integers(lo, args.prompt_len + 1))
               .tolist() for _ in range(args.n_requests)]
    streams = {}            # handle (request id, or slot id) → its tokens
    done_tokens = 0
    _sync(dev)
    t0 = time.perf_counter()
    while pending or engine.slot_live.any() or engine.wait:
        while pending:
            handle = engine.submit(pending[0], generator=gen)
            if handle is None:
                break
            streams[handle] = []
            pending.pop(0)
        out = engine.step(generator=gen)
        for handle, tok in out.items():
            # spec engines emit {handle: [tokens]} bursts, plain ones
            # {handle: token}
            burst = tok if isinstance(tok, list) else [tok]
            done_tokens += len(burst)
            streams[handle].extend(burst)
            if len(streams[handle]) >= args.gen_len:
                engine.cancel(handle)       # done: free its slot (and pages)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] continuous batching: {args.n_requests} requests, "
          f"{done_tokens} tokens in {dt:.2f}s "
          f"({done_tokens / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] stats: {engine.stats()}")

    if args.async_demo > 0:
        engine3 = ServingEngine(cfg, params, sc)
        aeng = AsyncServingEngine(engine3)

        async def one(i: int) -> int:
            prompt = shared + rng.integers(
                0, cfg.vocab, max(lo, args.prompt_len // 2)).tolist()
            n = 0
            async for _tok in aeng.stream(prompt, args.gen_len,
                                          priority=i % 2):
                n += 1
            return n

        async def demo():
            return await asyncio.gather(
                *(one(i) for i in range(args.async_demo)))

        _sync(dev)
        t0 = time.perf_counter()
        counts = asyncio.run(demo())
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"[serve] async streaming: {args.async_demo} concurrent "
              f"requests, {sum(counts)} tokens in {dt:.2f}s "
              f"({sum(counts) / max(dt, 1e-9):.1f} tok/s)")
        print(f"[serve] async stats: {engine3.stats()}")
        print(f"[serve] async slo: {json.dumps(aeng.slo_report())}")
    _write_obs(args, obs)
    return 0


def _write_obs(args, obs) -> None:
    """Write the requested observability artifacts (nothing when neither
    --trace-out nor --metrics-json was given)."""
    if args.trace_out:
        n = obs.trace.write(args.trace_out)
        print(f"[serve] trace: {n} events -> {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(obs.metrics.snapshot(), f, indent=2, sort_keys=True)
        print(f"[serve] metrics: snapshot -> {args.metrics_json}")


if __name__ == "__main__":
    raise SystemExit(main())
