#!/usr/bin/env python3
"""What holds K6's tensor-core walk back, on one GPU.

    PYTHONPATH=src python3 scripts/torch_k6_ablation.py

Builds patched copies of ``src/repro_torch/csrc/ssd_scan.cu`` under
``build/k6_ablation/`` (with the ``csrc`` headers on the include path) and
runs them on the same bf16 inputs at mamba2-1.3b's and zamba2-2.7b's
prefill shapes:

* ``base``: the source as it is;
* ``single_y``: y's two products, C hᵀ and (L ∘ C Bᵀ) dtx, without their
  lo parts (each fp32 operand rounded once to bf16; the state keeps its
  hi + lo), which shows what the split costs and whether y then holds
  ``SSD_TOLS["bfloat16"]`` against the plain version;
* ``trace``: the base kernel with ``clock64()`` stamps at the phase
  boundaries of each 64-step tile, taken by lane 0 of warps 0 (row block
  0) and 3 (row block 3) of CTA (head 0, segment 0, row 0).

The base kernel also runs each cell on both bf16 routes, the chooser's
and the other one (``SEG_TILES`` set so that the row is one segment, or
segments of 2 tiles), to show where each route is the faster.

Each variant is timed as ``chip_smoke.py`` times a kernel (L2 flushed,
the card held busy until the call is queued, median of 20), in turns
(base, single_y, single_y, base), the lower of its two medians printed,
and held against the plain version.
Prints the card's name and power limit first, and writes
``chiprun_out/torch_k6_ablation.json``. Fails without a GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k6_ablation"
CELLS = ((8, 384, 64, 64, 128), (1, 4096, 64, 64, 128), (8, 64, 80, 64, 64),
         (1, 200, 64, 64, 128))
PHASES = ("cum", "staged", "C h^T + C B^T", "L o C B^T", "(L o C B^T) dtx",
          "y stored", "state, next h")
TRACE_DECL = "__device__ long long g_trace[128];\n"
TRACE_READ = ('\nextern "C" int ssd_trace(long long* host, int reset) {\n'
              '  static long long zero[128];\n'
              '  return reset ? cudaMemcpyToSymbol(g_trace, zero, sizeof zero)\n'
              '               : cudaMemcpyFromSymbol(host, g_trace, sizeof zero);\n'
              '}\n')


def _walk_part(src: str, fn) -> str:
    i = src.index("template <int NP, bool kY>")
    return src[:i] + fn(src[i:])


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"patch anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def single_y(src: str) -> str:
    def patch(w):
        w = _replace(w, "for (int part = 0; part < 2; ++part)\n#pragma unroll\n"
                     "            for (int jp = 0; jp < 2; ++jp) {\n"
                     "              uint32_t bh[4];",
                     "for (int part = 0; part < 1; ++part)\n#pragma unroll\n"
                     "            for (int jp = 0; jp < 2; ++jp) {\n"
                     "              uint32_t bh[4];")
        return _replace(w, "for (int part = 0; part < 3; ++part)",
                        "for (int part = 0; part < 1; ++part)")
    return _walk_part(src, patch)


def traced(src: str) -> str:
    def stamp(k):
        return ("if (kY && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0"
                " && (threadIdx.x == 0 || threadIdx.x == 96) && t - t0 < 8) "
                f"g_trace[(threadIdx.x ? 64 : 0) + (t - t0) * 8 + {k}] = clock64();")
    anchors = (("for (int t = t0; t < t1; ++t) {", 0, True),
               ("// dtx = dt * x and W = exp(cum_T - cum) o dtx", 1, False),
               ("const float gT = *gsm;", 2, True),
               ("const float e0 = ein[r0], e1 = ein[r1];", 3, False),
               ("// (L o C B^T) dtx: the masked products", 4, False),
               ("// y, rounded once to bf16", 5, False),
               ("if (need_state) {", 6, False),
               ("store_h<NP>(hreg, smem, rb, hf, g4, t4);  // for the next", 7,
                True))

    def patch(w):
        out = []
        for line in w.split("\n"):
            hit = [(k, after) for a, k, after in anchors if a in line]
            if hit and not hit[0][1]:
                out.append(stamp(hit[0][0]))
            out.append(line)
            if hit and hit[0][1]:
                out.append(stamp(hit[0][0]))
        return "\n".join(out)
    src = _replace(src, '#include "attn_mma.cuh"\n',
                   '#include "attn_mma.cuh"\n' + TRACE_DECL)
    return _walk_part(src, patch) + TRACE_READ


def build(variants):
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    procs = {}
    for name, fn in variants.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(fn(src))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def use(lib):
    """Point the K6 wrapper at ``lib``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as K6

    _build._libs["ssd_scan"] = lib
    lib.ssd_scan.argtypes = None
    K6._lib()


def inputs(B, S, H, P, N, gen):
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device="cuda"))
    Bc, Cc = ((0.5 * torch.randn((B, S, N), generator=gen, device="cuda"))
              .bfloat16() for _ in range(2))
    return x, dt, A, Bc, Cc


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k6_ablation: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SSD_TOLS, Timer
    from repro_torch.kernels import ssd_scan as K6

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build({"base": lambda s: s, "single_y": single_y,
                  "trace": traced})
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    atol, rtol = SSD_TOLS["bfloat16"]
    res = {"card": card, "cells": {}, "trace": {}}
    for cell in CELLS:
        B, S, H, P, N = cell
        args = inputs(B, S, H, P, N, gen)
        want_y, want_h = K6.ssd_scan_plain(*args)
        row = {}
        for name in ("base", "single_y", "single_y", "base"):
            use(libs[name])
            y, h = K6.ssd_scan(*args)
            torch.cuda.synchronize()
            ok = bool(torch.allclose(y.float(), want_y.float(), atol=atol,
                                     rtol=rtol)
                      and torch.allclose(h, want_h, atol=1e-4, rtol=1e-4))
            t = timer.ms(lambda: K6.ssd_scan(*args))
            r = row.setdefault(name, dict(ms=[], holds_tolerances=ok))
            r["ms"].append(t)
        tag = f"B{B}xS{S} H{H} N{N} ({K6.route_for(torch.bfloat16, S, P, N)})"
        use(libs["base"])
        chosen = K6.SEG_TILES
        for seg in (chosen, 10 ** 6, 2):        # the chooser's, walk, chunks
            K6.SEG_TILES = seg
            route = K6.route_for(torch.bfloat16, S, P, N)
            if f"route {route}" not in row:
                row[f"route {route}"] = dict(
                    ms=[timer.ms(lambda: K6.ssd_scan(*args))],
                    holds_tolerances=None, segments=K6.tile_plan(
                        S, P, N)["segments"])
        K6.SEG_TILES = chosen
        res["cells"][tag] = row
        print(f"{tag}: " + "; ".join(
            f"{n} {min(r['ms']):.4f} ms" + (
                "" if r["holds_tolerances"] is None else
                f", tolerances {'held' if r['holds_tolerances'] else 'MISSED'}")
            + (f" ({r['segments']} segments)" if "segments" in r else "")
            for n, r in row.items()), flush=True)
        use(libs["trace"])
        host = (ctypes.c_longlong * 128)()
        for _ in range(3):
            libs["trace"].ssd_trace(host, 1)
            K6.ssd_scan(*args)
            torch.cuda.synchronize()
        libs["trace"].ssd_trace(host, 0)
        tiles = {}
        for warp, base in (("warp 0 (row block 0)", 0),
                           ("warp 3 (row block 3)", 64)):
            for t in range(8):
                st = [host[base + t * 8 + k] for k in range(8)]
                if st[0]:
                    tiles.setdefault(warp, []).append(
                        dict(zip(PHASES, (v - st[0] for v in st[1:]))))
        res["trace"][tag] = tiles
        for warp, ts in tiles.items():
            for t, d in enumerate(ts[:3]):
                print(f"  {warp}, tile {t}: cycles from the tile's start to "
                      + ", ".join(f"{k} {v}" for k, v in d.items()))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_k6_ablation.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
