#!/usr/bin/env python3
"""Device time of the attention kernels' tensor-core routes (K3, K4) by
kernel alone, at the served and encoded models' shapes, on one GPU.

    PYTHONPATH=src python3 scripts/torch_attn_sweep.py

Each number is the kernel's own device time (torch.profiler, the
wrapper's small index kernels excluded), the mean of 50 calls, bf16;
"warm" calls run back to back (their operands stay in L2), "cold" ones
each follow a 128 MB write that flushes the 50 MB L2, as a decode step's
attention finds its cache after 270 MB of weights went through L2:

* the rows route (K3) at bert-base's heads (B 8, 128 query positions,
  H 12, D 64, non-causal) against 0, 64, 128, 256 and 512 valid keys: a
  call's fixed cost and the cost of each 64-key stage;
* the split route at smollm-135m's decode (B 8, H 9, Hkv 3, D 64, 256
  keys in memory, ragged lengths), K3 over a contiguous cache and K4 over
  shuffled 16-token pages, at every split count 1..8 (forced through the
  chooser), the same with 2,048 keys in memory (1,024-2,047 valid) at 1,
  2, 4 and 8, and K3 at zamba2's decode (B 8, H = Hkv = 32, D 80, 512
  keys in memory, 64-80 valid) at 1, 2 and 4, warm and cold: the count
  the chooser picks against the fastest.

Writes chiprun_out/torch_attn_sweep.json and prints one line per number,
the card's name and power limit first. Fails without a GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CALLS = 50


def kernel_us(fn, name: str, flush=None, attempts: int = 3) -> float:
    """Mean device time of the kernels whose name holds ``name`` over
    CALLS calls of ``fn``, each after ``flush.zero_()`` when given. The
    profiler at times drops the records of a window's last launches (it
    once kept none of 50, once 49): the mean is taken over those it kept,
    and a window that kept fewer than 90% of them is run again, up to
    ``attempts`` windows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name]
        if CALLS * 9 // 10 <= len(times) <= CALLS:
            return sum(times) / len(times)
    raise RuntimeError(f"{len(times)} launches of {name} in the last of "
                       f"{attempts} profiler windows, expected {CALLS}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    out = {"card": smi, "torch": torch.__version__, "rows": [], "split": []}
    # rows route: bert-base's heads against n valid keys
    B, S, H, D, Sk = 8, 128, 12, 64, 512
    q, k, v = randn(B, S, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for n in (0, 64, 128, 256, 512):
        kvl = torch.full((B,), n, dtype=torch.int32, device=dev)
        fn = lambda: FA.flash_attention(q, k, v, qpos, kvl,  # noqa: E731
                                        causal=False)
        warm = kernel_us(fn, "flash_attn_rows_kernel")
        cold = kernel_us(fn, "flash_attn_rows_kernel", flush)
        out["rows"].append(dict(kernel="K3", B=B, Sq=S, H=H, D=D,
                                valid_keys=n, warm_us=warm, cold_us=cold))
        print(f"K3 rows B={B} Sq={S} H={H} D={D} valid keys {n}: warm "
              f"{warm:.2f} us cold {cold:.2f} us", flush=True)

    # split route at forced split counts
    def decode(kind, B, H, Hkv, D, n_keys, lens, counts):
        q = randn(B, 1, H, D)
        kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
        qpos = (kvl - 1)[:, None]
        if kind == "K3":
            k, v = randn(B, n_keys, Hkv, D), randn(B, n_keys, Hkv, D)
            mod, name = FA, "flash_attn_split_kernel"
            fn = lambda: FA.flash_attention(q, k, v, qpos, kvl)  # noqa: E731
        else:
            ps, nb = 16, n_keys // 16
            P = B * nb + 5
            kp, vp = randn(P, ps, Hkv, D), randn(P, ps, Hkv, D)
            bt = torch.randperm(P, generator=gen, device=dev)[:B * nb] \
                .reshape(B, nb).to(torch.int32)
            mod, name = PA, "paged_attn_split_kernel"
            fn = lambda: PA.paged_attention(q, kp, vp, bt, qpos, kvl)  # noqa: E731
        chosen = mod.split_count(B, Hkv, n_keys)
        chooser = mod.split_count
        try:
            for n in counts:
                mod.split_count = lambda *a, n=n: n
                warm, cold = kernel_us(fn, name), kernel_us(fn, name, flush)
                out["split"].append(dict(kernel=kind, B=B, H=H, Hkv=Hkv,
                                         D=D, keys=n_keys, splits=n,
                                         chosen=chosen, warm_us=warm,
                                         cold_us=cold))
                print(f"{kind} split B={B} H={H} Hkv={Hkv} D={D} keys "
                      f"{n_keys}: {n} splits{' (chosen)' * (n == chosen)} "
                      f"warm {warm:.2f} us cold {cold:.2f} us", flush=True)
        finally:
            mod.split_count = chooser

    lens = torch.randint(17, 256, (8,), generator=gen, device=dev).tolist()
    for kind in ("K3", "K4"):
        decode(kind, 8, 9, 3, 64, 256, lens, range(1, 9))
    long_lens = torch.randint(1024, 2048, (8,), generator=gen,
                              device=dev).tolist()
    for kind in ("K3", "K4"):
        decode(kind, 8, 9, 3, 64, 2048, long_lens, (1, 2, 4, 8))
    lens = (64 + torch.randint(0, 16, (8,), generator=gen,
                               device=dev)).tolist()
    decode("K3", 8, 32, 32, 80, 512, lens, (1, 2, 4))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "torch_attn_sweep.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
