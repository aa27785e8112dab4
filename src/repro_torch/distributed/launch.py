"""Start a group of ranks on this host: one process each, over gloo.

``spawn(target, world, args, workdir=...)`` starts ``world`` processes
with the ``spawn`` start method (never ``fork``: a parent may already run
threads, JAX's among them, that a forked child would inherit half-way),
joins them into one ``torch.distributed`` group through a ``FileStore``
in ``workdir`` (a file, so groups started at once never collide on a TCP
port), calls ``target(rank, world, *args)`` in each and hands back every
rank's return value, in rank order.

One backend on the CPU and on the card: gloo. The card is one H100, and
NCCL refuses two ranks on one device, so a mesh on the card runs its ranks
on ``cuda:0`` over gloo too; gloo takes CUDA tensors for ``all_reduce``
and ``broadcast``, the only collectives the port issues
(``distributed/tp.py``).

Every wait is bounded: the group's own timeout (``collective_timeout_s``,
passed to ``init_process_group``) fails a hung collective inside the rank,
and the join gives up after ``timeout_s`` and kills what is left. A rank
that raises fails the whole call with that rank's traceback.
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import io
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_rank(rank: int, world: int, store_path: str, *,
              collective_timeout_s: float = 60.0) -> None:
    """Join this process to the gloo group of ``world`` ranks that meets
    at the FileStore ``store_path``."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=collective_timeout_s))


def _entry(rank: int, world: int, store_path: str, out_dir: str,
           collective_timeout_s: float, threads: Optional[int],
           target: Callable, args: Sequence[Any]) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_rank(rank, world, store_path,
              collective_timeout_s=collective_timeout_s)
    try:
        result = target(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(target: Callable, world: int, args: Sequence[Any] = (), *,
          workdir: str, timeout_s: float = 600.0,
          collective_timeout_s: float = 60.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``target(rank, world, *args)`` on ``world`` new ranks; returns
    their results in rank order. ``target`` and ``args`` must pickle (a
    module-level function; arrays or tensors: a CUDA tensor reaches the
    ranks through CUDA IPC, so it stays alive and unwritten here until
    this returns). ``threads`` sets each rank's ``torch.set_num_threads``."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    for old in work.glob("rank*.pkl"):
        old.unlink()
    ctx = mp.start_processes(
        _entry, args=(world, str(store), str(work), collective_timeout_s,
                      threads, target, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks of {getattr(target, '__name__', target)}"
                    f" did not finish within {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r in range(world):
        with open(work / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _cli_rank(rank: int, world: int, module: str, argv: Sequence[str]
              ) -> int:
    main = importlib.import_module(module).main
    if rank == 0:
        return main(list(argv))
    with contextlib.redirect_stdout(io.StringIO()):     # only rank 0 prints
        return main(list(argv))


def run_cli(module: str, argv: Sequence[str], world: int, *,
            timeout_s: float = 3600.0) -> int:
    """Run ``<module>.main(argv)`` on ``world`` new ranks of one group (a
    launcher's ``--tp N`` / ``--dp N``); only rank 0 prints. Returns rank
    0's exit code."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as work:
        codes = spawn(_cli_rank, world, (module, tuple(argv)),
                      workdir=work, timeout_s=timeout_s)
    return int(codes[0] or 0)
