#!/usr/bin/env python3
"""Where a decode step — or an encoder forward — of the PyTorch/CUDA port
spends its time, on one GPU.

    PYTHONPATH=src python3 scripts/torch_decode_profile.py [--steps 20]
        [--attn-backend paged|fused] [--weight-dtype int8] [--kv-dtype int8]
    PYTHONPATH=src python3 scripts/torch_decode_profile.py --encoder bert-base
    PYTHONPATH=src python3 scripts/torch_decode_profile.py --arch mamba2-1.3b \
        --attn-backend fused --prompt-len 384

Decode (the default): serves full-width smollm-135m (bf16, seeded random
weights, resident block-major weights; paged KV with page 16, or
contiguous KV caches under ``--attn-backend fused``) through ServingEngine
with every slot decoding. ``--weight-dtype int8`` runs every projection
through the W8A8 GEMM (weights quantized at pack time) and ``--kv-dtype
int8`` stores the KV pages int8 (paged only). ``--arch mamba2-1.3b`` or
``zamba2-2.7b`` (contiguous caches, ``--attn-backend fused``) runs the
model's serving forward on every slot at once, as the engine's generate()
does (its submit() takes one slot for these families): first the prefill
of ``--prompt-len`` tokens per slot into fresh caches (their zeroing
included), then decode steps. ``--encoder ARCH`` instead runs full-width
``encoder_forward`` of bert-base (B 8 x S 128 tokens) or vit-base (B 8 x
197 stub patch embeddings), bf16, default policies. Then, for each:

* times ``--steps`` decode-only ``step()`` calls (or forwards; 5
  prefills) on the host clock, each ending in a device sync;
* profiles 5 more with torch.profiler and sums device time by kernel: the
  MatrixFlow GEMM by route (``matrixflow_gemm_wgmma`` and
  ``matrixflow_gemm_mma`` on the tensor cores for bf16,
  ``matrixflow_gemm`` on the CUDA cores) and its W8A8 variant by route
  (``matrixflow_gemm_dequant_wgmma``, ``_mma``), the paged attention
  kernel by route (``paged_attention_split`` and ``_rows`` on the tensor
  cores for bf16 pools, ``paged_attention`` on the CUDA cores for fp32)
  and over int8 pages (``paged_attention_int8_split``, ``_rows``; on the
  CUDA cores ``paged_attention_int8``), the flash attention kernel by route
  (``flash_attention_split``, ``_rows``; ``flash_attention`` for fp32),
  the SSD scan by kernel (``ssd_scan_walk``, ``ssd_scan_chunks_state`` and
  ``_pass`` on the tensor cores; ``ssd_scan`` for fp32), and everything
  else (PyTorch's elementwise, copy, reduction and index kernels). Device busy time over wall time gives the
  device's idle share.

Writes chiprun_out/torch_decode_profile_<what>.json and prints one line
per number, with the card's name and power limit first. Fails without a
GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# (substring of a device kernel's name, what it is counted as): K1-K6 by
# route (bf16 and K2's int8 on the tensor cores, fp32 and K1's int8 on the
# CUDA cores; K6's chunks route by kernel: segment states, the pass, and
# the walk it shares with the walk route); every other kernel is "other".
KERNEL_KINDS = (
    ("mf_gemm_kernel", "matrixflow_gemm"),
    ("mf_gemm_wgmma_kernel", "matrixflow_gemm_wgmma"),
    ("mf_gemm_mma_kernel", "matrixflow_gemm_mma"),
    ("mf_gemm_dequant_wgmma_kernel", "matrixflow_gemm_dequant_wgmma"),
    ("mf_gemm_dequant_mma_kernel", "matrixflow_gemm_dequant_mma"),
    ("paged_attn_rows_kernel", "paged_attention_rows"),
    ("paged_attn_split_kernel", "paged_attention_split"),
    ("paged_attn_kernel", "paged_attention"),
    ("paged_attn_int8_rows_kernel", "paged_attention_int8_rows"),
    ("paged_attn_int8_split_kernel", "paged_attention_int8_split"),
    ("paged_attn_int8_kernel", "paged_attention_int8"),
    ("flash_attn_rows_kernel", "flash_attention_rows"),
    ("flash_attn_split_kernel", "flash_attention_split"),
    ("flash_attn_kernel", "flash_attention"),
    ("ssd_walk_kernel", "ssd_scan_walk"),
    ("ssd_segment_state_kernel", "ssd_scan_chunks_state"),
    ("ssd_segment_pass_kernel", "ssd_scan_chunks_pass"),
    ("ssd_scan_kernel", "ssd_scan"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--attn-backend", default=None,
                    choices=["paged", "fused"],
                    help="default: paged for smollm-135m, fused for the "
                         "SSM archs")
    ap.add_argument("--weight-dtype", default=None, choices=["int8"])
    ap.add_argument("--kv-dtype", default=None, choices=["int8"])
    ap.add_argument("--arch", default="smollm-135m",
                    choices=["smollm-135m", "mamba2-1.3b", "zamba2-2.7b"])
    ap.add_argument("--encoder", default=None,
                    choices=["bert-base", "vit-base"],
                    help="profile encoder_forward instead of decode")
    args = ap.parse_args(argv)
    ssm = args.arch != "smollm-135m"
    args.attn_backend = args.attn_backend or ("fused" if ssm else "paged")
    if args.kv_dtype and args.attn_backend != "paged":
        ap.error("--kv-dtype needs --attn-backend paged")
    if ssm and (args.attn_backend != "fused" or args.kv_dtype):
        ap.error(f"{args.arch} serves from contiguous caches: "
                 f"--attn-backend fused, no --kv-dtype")
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core import api
    from repro_torch.core.api import pack_model_weights
    from repro_torch.core.plan import FUSED, AttentionPolicy, GemmPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    rng = np.random.default_rng(0)
    runs = {}
    if args.encoder:
        cfg = get_config(args.encoder)
        params = pack_model_weights(T.init_model(cfg, seed=0, device="cuda"))
        B, S = 8, (128 if cfg.family == "bert" else 197)
        batch = ({"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S))).cuda()}
            if cfg.family == "bert" else
            {"embeds": torch.from_numpy(rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)).to(
                    "cuda", cfg.param_dtype)})
        what = f"{cfg.name} encoder_forward, B {B} x S {S}, {cfg.dtype}"

        def step():
            with torch.no_grad():
                T.encoder_forward(params, cfg, batch)
            torch.cuda.synchronize()
        runs[what] = (step, args.steps)
    elif ssm:
        cfg = get_config(args.arch)
        params = pack_model_weights(
            T.init_model(cfg, seed=0, device="cuda"),
            GemmPolicy(weight_dtype=args.weight_dtype))
        B, S = args.slots, args.prompt_len
        max_len = S + args.steps + 16
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).cuda()
        run = {}

        def forward(tokens, positions, last_cols=None):
            with torch.no_grad(), api.use_attention_policy(FUSED):
                logits, _ = T.forward(params, cfg, {
                    "tokens": tokens, "positions": positions},
                    caches=run["caches"], last_cols=last_cols)
            run["tok"] = torch.argmax(logits[:, -1], dim=-1)
            torch.cuda.synchronize()

        def prefill():
            run["caches"] = T.init_caches(cfg, B, max_len, cfg.dtype, "cuda")
            run["pos"] = S
            forward(prompts, torch.arange(S, device="cuda").expand(B, S),
                    torch.full((B,), S - 1, device="cuda"))

        def decode():
            forward(run["tok"][:, None],
                    torch.full((B, 1), run["pos"], device="cuda"))
            run["pos"] += 1

        tag = (f"{B} slots, fused attention, weights "
               f"{args.weight_dtype or cfg.dtype}")
        runs[f"{cfg.name} prefill, {S} tokens per slot, {tag}"] = (prefill, 5)
        runs[f"{cfg.name} decode step after {S} tokens, {tag}"] = (
            decode, args.steps)
    else:
        cfg = get_config("smollm-135m")
        eng = ServingEngine(cfg, T.init_model(cfg, seed=0, device="cuda"),
                            ServeConfig(
                                batch_slots=args.slots, max_len=256,
                                cache_dtype=cfg.dtype, pack_weights=True,
                                attention=AttentionPolicy(args.attn_backend,
                                                          16),
                                weight_dtype=args.weight_dtype,
                                kv_dtype=args.kv_dtype, device="cuda"))
        for _ in range(args.slots):
            eng.submit(rng.integers(0, cfg.vocab, args.prompt_len).tolist())
        what = (f"smollm-135m decode step, {args.slots} slots, "
                f"{args.attn_backend} attention, weights "
                f"{args.weight_dtype or cfg.dtype}, KV {args.kv_dtype or cfg.dtype}")
        step = eng.step
        runs[what] = (step, args.steps)

    results = [measure(step, n) for step, n in runs.values()]
    res = {"card": card, "torch": torch.__version__}
    if len(runs) == 1:
        res.update(what=next(iter(runs)), **results[0])
        if not args.encoder:
            res.update(context=f"{args.prompt_len}+ tokens per slot",
                       decode_tokens_per_s=args.slots / res["step_ms"] * 1e3)
    else:
        res["runs"] = dict(zip(runs, results))
    for k, v in res.items():
        print(f"{k}: {v}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "torch_decode_profile" + (
        f"_{args.encoder}" if args.encoder else
        (f"_{args.arch}" if ssm else "") + f"_{args.attn_backend}"
        + (f"_w{args.weight_dtype}" if args.weight_dtype else "")
        + (f"_kv{args.kv_dtype}" if args.kv_dtype else ""))
    (out / f"{name}.json").write_text(json.dumps(res, indent=1))
    return 0 if all(r["device_busy_ms_per_step"] > 0 for r in results) else 1


def measure(step, n_steps: int) -> dict:
    """Host wall time per call over ``n_steps`` calls (after 3 warm-up
    calls), then device time by kernel over 5 profiled calls."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3

    n_prof = 5
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
    by_kind = defaultdict(float)
    n_kernels = defaultdict(int)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for sub, k in KERNEL_KINDS if sub in e.name),
                    "other")
        by_kind[kind] += e.time_range.elapsed_us() / 1e3 / n_prof
        n_kernels[kind] += 1
    busy_ms = sum(by_kind.values())
    return dict(step_ms=step_ms, device_ms_per_step=dict(by_kind),
                device_ops_per_step={k: v / n_prof
                                     for k, v in n_kernels.items()},
                device_busy_ms_per_step=busy_ms,
                device_idle_share=(1 - busy_ms / step_ms) if busy_ms else None)


if __name__ == "__main__":
    raise SystemExit(main())
