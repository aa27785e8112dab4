#!/usr/bin/env python3
"""Where the W8A8 GEMM's wgmma route (K2 at bm 64) spends its time, on one
GPU.

    PYTHONPATH=src python3 scripts/torch_k2_ablation.py

Builds variants of ``csrc/matrixflow_gemm.cu`` from patched copies under
``build/k2_ablation/``, each with one part of
``mf_gemm_dequant_wgmma_kernel`` removed or changed (their results are
wrong; only their times mean something), and times each beside the
unpatched kernel, bf16 K1 and ``torch._int_mm`` at bert-base's GEMMs, the
64-column prefill's q/o and a mamba2-sized one, with the block geometry the
engine packs (``choose_layout(..., mode="dc")``):

  ``base``          the kernel as it is
  ``no_transpose``  B's raw slice is not transposed into the K-major tile
  ``no_fence``      no proxy fence before the second barrier of a slice
  ``no_sync2``      neither that fence nor that barrier
  ``no_wgmma``      no tensor-core product
  ``no_loads_b``    B's bytes are not loaded
  ``stages6/8``     a ring of 6 or 8 slices (K1's too, in that build)

Device time of one call after an L2 flush, median of 20, CUDA events.
Prints the card's name and power limit first. Fails without a GPU.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import matrixflow_gemm as MF  # noqa: E402

TRANSPOSE = ("    transpose(s % kWgStages, s & 1);\n    fence_proxy_async();\n"
             "    __syncthreads();          // B tile")
STAGES = "constexpr int kWgStages = 5;"
VARIANTS = {
    "base": [],
    "no_transpose": [(TRANSPOSE, "    fence_proxy_async();\n"
                                 "    __syncthreads();          // B tile")],
    "no_fence": [(TRANSPOSE, "    transpose(s % kWgStages, s & 1);\n"
                             "    __syncthreads();          // B tile")],
    "no_sync2": [(TRANSPOSE, "    transpose(s % kWgStages, s & 1);\n"
                             "    // B tile")],
    "no_wgmma": [("    wgmma_s8_tile<TN>(acc, wg_desc32(a_s), wg_desc32(b_s));\n",
                  "")],
    "no_loads_b": [("      cp_async16(sb_s + raw_b_off(kr, (jj << lg_cpr) + c16), "
                    "src, ok);\n", "")],
    "stages6": [(STAGES, "constexpr int kWgStages = 6;")],
    "stages8": [(STAGES, "constexpr int kWgStages = 8;")],
}
SHAPES = ((1024, 768, 768), (1024, 3072, 768), (1024, 768, 3072),
          (512, 576, 576), (3072, 2048, 4096))


def build_variants(out: Path) -> dict:
    """Every variant's library, all nvcc processes at once."""
    src = (_build.CSRC / "matrixflow_gemm.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        (out / f"mf_{name}.cu").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out / f"libmf_{name}.so"), str(out / f"mf_{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"libmf_{name}.so"))
        lib.mf_gemm_dequant.argtypes = [i, i, i, i, i, i, vp, vp, vp, i, vp, i,
                                        vp, i, i, i, i, vp]
        lib.mf_gemm_dequant.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build_variants(ROOT / "build" / "k2_ablation")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for M, K, N in SHAPES:
        blk = L.choose_layout(M, N, K, torch.int8, mode="dc")
        a = torch.randn((M, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda")
        aq, sa = Q.quantize_activations(a)
        wq, sw = Q.quantize_weight(w)
        a_bm = L.to_block_major_a(aq, blk.bm, blk.bk)
        b_bm = L.to_block_major_b(wq, blk.bk, blk.bn)
        nbm, nbk, nbn = a_bm.shape[0], a_bm.shape[1], b_bm.shape[0]
        gm, tn, splits = MF.tc_tile(blk.bm, blk.bn, nbm, nbn, nbk, blk.bk)
        c = torch.empty((nbm, nbn, blk.bm, blk.bn), dtype=torch.bfloat16,
                        device="cuda")
        row = [f"M={M} K={K} N={N} blocks {blk.bm}x{blk.bn}x{blk.bk} "
               f"tile {(gm, tn)}"]
        for name, lib in libs.items():
            def run(lib=lib):
                err = lib.mf_gemm_dequant(
                    1, blk.bm, blk.bn, gm, tn, splits, a_bm.data_ptr(),
                    b_bm.data_ptr(), sa.data_ptr(), M, sw.data_ptr(), N,
                    c.data_ptr(), nbm, nbn, nbk, blk.bk, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            row.append(f"{name} {ms(run) * 1e3:.1f} us")
        ab = L.to_block_major_a(a.bfloat16(), blk.bm, blk.bk)
        bb = L.to_block_major_b(w.bfloat16(), blk.bk, blk.bn)
        row.append(f"bf16-K1 {ms(lambda: MF.matrixflow_gemm_block_major(ab, bb, out_dtype=torch.bfloat16)) * 1e3:.1f} us")
        row.append(f"_int_mm {ms(lambda: torch._int_mm(aq, wq)) * 1e3:.1f} us")
        print(" | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
