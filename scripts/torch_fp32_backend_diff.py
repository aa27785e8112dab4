#!/usr/bin/env python3
"""Where the fp32 logits of the SSM models on the card part from the CPU's.

    PYTHONPATH=src python3 scripts/torch_fp32_backend_diff.py

Runs the prefill of zamba2-2.7b (cut to 6 layers, one attention group)
and mamba2-1.3b (cut to 4 layers) at full width in fp32, from the same
seeded weights and prompts as ``chip_smoke.py``'s SSM parity phase, under
five GEMM x attention combinations:

    A  card: the MatrixFlow kernel (K1), flash attention (K3), SSD scan (K6)
    D  card: torch.matmul in place of K1
    E  card: K1, the plain masked softmax in place of K3
    B  CPU:  the plain block-major GEMM, K3's and K6's plain versions
    C  CPU:  torch.matmul in place of the plain GEMM

and prints the largest |difference| of the last-position logits for every
pair, so a gap between card and CPU can be put on one kernel. TF32 is off.
Fails without a GPU.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fp32_backend_diff: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.core import api
    from repro_torch.core.plan import FUSED, UNFUSED, GemmPolicy
    from repro_torch.models import transformer as T

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    runs = (("A card K1+K3", "cuda", "matrixflow", FUSED),
            ("D card matmul+K3", "cuda", "torch", FUSED),
            ("E card K1+unfused", "cuda", "matrixflow", UNFUSED),
            ("B cpu plain", "cpu", "blockflow", FUSED),
            ("C cpu matmul", "cpu", "torch", FUSED))
    for arch, n_layers, S in (("zamba2-2.7b", 6, 64), ("mamba2-1.3b", 4, 200)):
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  n_layers=n_layers)
        prompts = torch.from_numpy(
            np.random.default_rng(22).integers(0, cfg.vocab, (2, S)))
        out = {}
        for name, dev, gemm, attn in runs:
            params = T.init_model(cfg, seed=23, device=dev)
            with torch.no_grad(), api.use_policy(GemmPolicy(backend=gemm)), \
                    api.use_attention_policy(attn):
                caches = T.init_caches(cfg, 2, S + 2, cfg.dtype, dev)
                logits, _, _ = T.forward(
                    params, cfg, {"tokens": prompts.to(dev),
                                  "positions": torch.arange(S).expand(2, S)
                                  .to(dev)},
                    caches=caches,
                    last_cols=torch.full((2,), S - 1, device=dev))
            out[name] = logits[:, -1].double().cpu()
            del params, caches
        names = list(out)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                print(f"{arch} {a} vs {b}: max|d| "
                      f"{float((out[a] - out[b]).abs().max()):.3e}")
        print(f"{arch} max|logit| {float(out[names[0]].abs().max()):.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
