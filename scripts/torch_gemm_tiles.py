#!/usr/bin/env python3
"""Every CTA tile and K split of K1's tensor-core routes, timed at each bf16
GEMM of the served and encoded models, on one GPU.

    PYTHONPATH=src python3 scripts/torch_gemm_tiles.py

For each bf16 cell of chip_smoke.py's GEMM phase (every projection of
full-width smollm-135m, mamba2-1.3b, zamba2-2.7b, bert-base and vit-base,
at the block geometry the engine packs), launches the wgmma kernel (bm 64)
at each tile of ``kernels/matrixflow_gemm.py::WGMMA_TILES``, or the mma
kernel (bm 16, 32) at 1-8 K splits, checks the result against the plain
version, and times it as chip_smoke.py does (device time after an L2
flush, mean of 20). Prints one line per cell with the tile the chooser
(``tc_tile``) picks, the fastest one and ``torch.matmul``'s time, then the
per-path sums of the chooser's and the fastest tiles, with the card's name
and power limit first. Writes chiprun_out/torch_gemm_tiles.json. Fails
without a GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemm_tiles: needs a GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.configs.registry import get_config
    from repro_torch.core import layout as L
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, pack_weight
    from repro_torch.kernels import matrixflow_gemm as MF

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    lib = MF._lib()
    stream = torch.cuda.current_stream().cuda_stream
    timer = CS.Timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, sums = [], defaultdict(lambda: [0.0, 0.0, 0.0])
    for name, M, K, N, path, uses in CS.gemm_cells(
            get_config(CS.ARCH), get_config("bert-base"),
            get_config("vit-base"), (get_config(CS.MAMBA), get_config(CS.ZAMBA))):
        a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device="cuda")
             / K ** 0.5).to(torch.bfloat16)
        pw = pack_weight(w, GemmPolicy())
        blk = layout_for_packed(M, pw)
        a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
        nbm, nbk, bm, bk = a_bm.shape
        nbn, bn = pw.data.shape[0], pw.data.shape[3]
        c = torch.empty((nbm, nbn, bm, bn), dtype=torch.bfloat16, device="cuda")
        want = MF.plain(a_bm, pw.data, out_dtype=torch.bfloat16).float()
        if MF.route_for(a.dtype, bm) == "wgmma":
            tiles = [(gm, tn, 1) for gm, tn, _ in MF.WGMMA_TILES if tn % bn == 0]
        else:
            tiles = [(1, bn, s) for s in range(1, MF.MAX_SPLITS + 1)]
        times = {}
        for gm, tn, splits in tiles:
            def launch():
                err = lib.mf_gemm_tc(1, bm, bn, gm, tn, splits, a_bm.data_ptr(),
                                     pw.data.data_ptr(), c.data_ptr(), nbm, nbn,
                                     nbk, bk, stream)
                if err:
                    raise RuntimeError(lib.mf_error_string(err).decode())
            launch()
            torch.cuda.synchronize()
            CS.check_close(f"{name} {gm}x{tn}/{splits}", c, want,
                           *CS.GEMM_TOLS["bfloat16"])
            times[f"{gm}x{tn}/{splits}"] = timer.ms(launch)
        pick = MF.tc_tile(bm, bn, nbm, nbn, nbk, bk)
        picked = times["%dx%d/%d" % pick]
        best = min(times, key=times.get)
        matmul_ms = timer.ms(lambda: torch.matmul(a, w))
        s = sums[path]
        s[0] += uses * picked
        s[1] += uses * times[best]
        s[2] += uses * matmul_ms
        rows.append(dict(cell=name, M=M, K=K, N=N, block=[bm, bn, bk],
                         path=path, uses=uses, ms=times, chosen=list(pick),
                         fastest=best, matmul_ms=matmul_ms))
        print(f"{name} M={M} K={K} N={N} blocks {bm}x{bn}x{bk}: chosen "
              f"{pick} {picked:.4f} ms, fastest {best} {times[best]:.4f} ms, "
              f"matmul {matmul_ms:.4f} ms | "
              + " ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    for path, (chosen, fastest, mm) in sums.items():
        print(f"per {path}: chosen {chosen:.4f} ms, fastest {fastest:.4f} ms, "
              f"matmul {mm:.4f} ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_gemm_tiles.json").write_text(json.dumps(
        {"card": card, "cells": rows,
         "per_path": {p: dict(zip(("chosen_ms", "fastest_ms", "matmul_ms"), v))
                      for p, v in sums.items()}}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
