"""Which collectives gloo runs on CUDA tensors, and how fast, between two
ranks on one card (the port's multi-device runs: ``distributed/tp.py``).

    python3 scripts/torch_gloo_probe.py

Starts two ranks on ``cuda:0`` over gloo (a FileStore in a temporary
directory, no network), tries ``all_gather_into_tensor``, ``all_gather``,
``reduce_scatter_tensor``, ``reduce_scatter``, an all-reduce max and a
bf16 all-gather on small CUDA tensors, prints each result or its error,
then times a 64 MiB fp32 all-reduce, all-gather (64 MiB a rank) and
reduce-scatter (64 MiB in) twice each on the host clock. Rank 0 prints
one JSON object. Exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BIG = 64 << 20                      # bytes of the timed fp32 tensors


def _try(res, name, fn):
    try:
        res[name] = fn()
    except Exception as e:          # the probe reports what gloo refuses
        res[name] = f"error: {type(e).__name__}: {e}"[:200]


def _timed(res, name, fn):
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        res[f"{name}_s_{i}"] = time.perf_counter() - t0


def body(rank, world, store):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {"torch": torch.__version__, "cuda": torch.version.cuda}
    x = (torch.arange(4.0) + rank).cuda()

    def gather_into():
        out = torch.empty(4 * world, device="cuda")
        dist.all_gather_into_tensor(out, x)
        return out.tolist()

    def gather_list():
        outs = [torch.empty(4, device="cuda") for _ in range(world)]
        dist.all_gather(outs, x)
        return [o.tolist() for o in outs]

    def scatter_tensor():
        out = torch.empty(4 // world, device="cuda")
        dist.reduce_scatter_tensor(out, x)
        return out.tolist()

    def scatter_list():
        out = torch.empty(4 // world, device="cuda")
        dist.reduce_scatter(out, list(x.chunk(world)))
        return out.tolist()

    def reduce_max():
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y.tolist()

    def gather_bf16():
        y = x.to(torch.bfloat16)
        out = torch.empty(4 * world, device="cuda", dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, y)
        return out.float().tolist()

    for name, fn in (("all_gather_into_tensor", gather_into),
                     ("all_gather", gather_list),
                     ("reduce_scatter_tensor", scatter_tensor),
                     ("reduce_scatter", scatter_list),
                     ("all_reduce_max", reduce_max),
                     ("all_gather_into_tensor_bf16", gather_bf16)):
        _try(res, name, fn)
    big = torch.ones(BIG // 4, device="cuda")
    gathered = torch.empty(world * big.numel(), device="cuda")
    part = torch.empty(big.numel() // world, device="cuda")
    _timed(res, "all_reduce_64MiB", lambda: dist.all_reduce(big))
    _timed(res, "all_gather_64MiB",
           lambda: dist.all_gather_into_tensor(gathered, big))
    _timed(res, "reduce_scatter_64MiB",
           lambda: dist.reduce_scatter_tensor(part, big))
    if rank == 0:
        print(json.dumps(res, indent=1), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(body, args=(2, os.path.join(d, "store")), nprocs=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
