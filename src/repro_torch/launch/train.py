"""Training launcher of the port (``repro/launch/train.py``), on the GPU by
default: the optimizer step of ``launch/steps.py`` with auto-resume from
the latest checkpoint and the straggler watchdog, data parallel over
``make_host_mesh()``: every rank of the world on the mesh's ``data`` axis,
as in the reference's CLI. ``--dp N`` starts N local ranks itself (one
group over gloo; on the card every rank runs on ``cuda:0``); only rank 0
prints and writes checkpoints. ``--production-mesh`` is not ported: its
16-wide model axis needs tensor-parallel training (ROADMAP.md queue 1
item 9b).

Attention trains through the ``unfused`` policy (the forward-only kernels
refuse a gradient). As in the reference, ``--warmup`` does not reach the
step: ``make_train_step_fn`` warms up over 100 steps (a reference caveat,
ROADMAP.md).

Usage:
  python -m repro_torch.launch.train --arch smollm-135m --steps 20 \
      --global-batch 8 --seq-len 128            # on the card, through K1
  python -m repro_torch.launch.train --arch smollm-135m --smoke --steps 3 \
      --global-batch 2 --seq-len 32 --log-every 1 --device cpu
  python -m repro_torch.launch.train --arch smollm-135m --smoke --steps 3 \
      --global-batch 4 --seq-len 32 --device cpu --dp 2   # two ranks
"""
from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import api
from repro_torch.core.plan import UNFUSED, GemmPolicy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.launch import run_cli
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.obs import Timer
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import check_trainable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (not ported: needs tensor-parallel "
                         "training)")
    ap.add_argument("--dp", type=int, default=1,
                    help="start this many local ranks, data parallel over "
                         "the global batch (gloo)")
    ap.add_argument("--gemm-backend", default="auto",
                    help="GEMM backend (auto|matrixflow|blockflow|torch)")
    ap.add_argument("--gemm-mode", default="auto",
                    choices=["auto", "dc", "dm"],
                    help="paper access mode; auto = per-shape sysmodel pick")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: its 16-wide model axis needs tensor-parallel "
            "training, which is not ported (ROADMAP.md queue 1 item 9b); "
            "data-parallel training runs over make_host_mesh() (--dp N)")
    if args.dp > 1 and not dist.is_initialized():
        return run_cli("repro_torch.launch.train",
                       sys.argv[1:] if argv is None else argv, args.dp)
    device = resolve_device(args.device)
    mesh = make_host_mesh()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_trainable(cfg, device)
    policy = GemmPolicy(backend=args.gemm_backend, mode=args.gemm_mode)
    lead = mesh.rank == 0
    print(f"[train] arch={cfg.name} device={device} mesh={mesh.shape} "
          f"steps={args.steps} gemm={policy.resolved_backend(device)}/"
          f"{policy.mode}")

    opt_cfg = AdamWConfig(lr=args.lr, compress_grads=args.compress_grads)
    data = TokenPipeline(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch, vocab=cfg.vocab,
        seed=args.seed, n_codebooks=cfg.n_codebooks))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    save = ckpt is not None and lead

    with api.use_policy(policy), api.use_attention_policy(UNFUSED):
        params = T.init_model(cfg, seed=args.seed, device=device)
        opt_state = adamw_init(params)
        start = 0
        if ckpt and ckpt.latest_step() is not None:
            state = ckpt.restore({"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            meta = ckpt.meta()
            start = meta["step"]
            data.load_state_dict(meta["extra"]["data"])
            print(f"[train] resumed from step {start}")

        step_fn = ST.make_train_step_fn(cfg, opt_cfg, total_steps=args.steps,
                                        mesh=mesh)
        ema = None
        for step in range(start, args.steps):
            with Timer() as tm:
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in data.next_batch().items()}
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])     # waits for the step
            dt = tm.dt
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > 3.0 * ema:
                print(f"[watchdog] step {step} straggled "
                      f"({dt:.2f}s vs EMA {ema:.2f}s)")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss {loss:.4f}"
                      f" grad_norm {float(metrics['grad_norm']):.3f}"
                      f" ({dt * 1e3:.0f} ms)")
            if save and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"data": data.state_dict()})
        if save:
            ckpt.save(args.steps, {"params": params, "opt": opt_state},
                      extra={"data": data.state_dict()})
            ckpt.wait()
    print("[train] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
