#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time, on one GPU.

    PYTHONPATH=src python3 scripts/torch_decode_profile.py [--steps 20]

Serves full-width smollm-135m (bf16, seeded random weights, resident
block-major weights, paged KV with page 16) through ServingEngine with
every slot decoding, then:

* times ``--steps`` decode-only ``step()`` calls on the host clock, each
  ending in the sampled ids' copy to the host (a device sync);
* profiles 5 more steps with torch.profiler and sums device time by kernel:
  the MatrixFlow GEMM, the paged attention kernel, and everything else
  (PyTorch's elementwise, copy and index kernels). Device busy time over
  wall time gives the device's idle share.

Writes chiprun_out/torch_decode_profile.json and prints one line per
number, with the card's name and power limit first. Fails without a GPU.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = get_config("smollm-135m")
    eng = ServingEngine(cfg, T.init_model(cfg, seed=0, device="cuda"),
                        ServeConfig(batch_slots=args.slots, max_len=256,
                                    cache_dtype=cfg.dtype, pack_weights=True,
                                    attention=AttentionPolicy("paged", 16),
                                    device="cuda"))
    rng = np.random.default_rng(0)
    for _ in range(args.slots):
        eng.submit(rng.integers(0, cfg.vocab, args.prompt_len).tolist())
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    n_prof = 5
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
    by_kind = defaultdict(float)
    n_kernels = defaultdict(int)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("matrixflow_gemm" if "mf_gemm_kernel" in e.name else
                "paged_attention" if "paged_attn_kernel" in e.name else
                "other")
        by_kind[kind] += e.time_range.elapsed_us() / 1e3 / n_prof
        n_kernels[kind] += 1
    busy_ms = sum(by_kind.values())
    res = {"card": card, "torch": torch.__version__, "slots": args.slots,
           "context": f"{args.prompt_len}+ tokens per slot",
           "step_ms": step_ms,
           "decode_tokens_per_s": args.slots / step_ms * 1e3,
           "device_ms_per_step": dict(by_kind),
           "device_ops_per_step": {k: v / n_prof for k, v in n_kernels.items()},
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": (1 - busy_ms / step_ms) if busy_ms else None}
    for k, v in res.items():
        print(f"{k}: {v}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_decode_profile.json").write_text(json.dumps(res, indent=1))
    return 0 if busy_ms > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
