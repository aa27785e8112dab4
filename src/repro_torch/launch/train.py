"""Training launcher of the port (``repro/launch/train.py``), on the GPU by
default: the optimizer step of ``launch/steps.py`` with auto-resume from
the latest checkpoint and the straggler watchdog, over
``make_host_mesh(pod=--pod, model=--tp)``: the world's ranks on a (data,
model) mesh, or (pod, data, model) with ``--pod``, data parallel over pod
x data with the params and AdamW's moments cut over ``data`` (FSDP, as the
reference's rules place them) and replicated over ``pod``, tensor and
expert parallel over ``model`` (each rank holds its slices of the params
and its experts' slice of the MoE banks, ``steps.rank_params``).
``--pod P --dp N --tp M`` starts P x N x M local ranks itself (one group
over gloo; on the card every rank runs on ``cuda:0``); only rank 0
prints. ``--compress-grads`` quantizes the gradients to int8 with each
whole tensor's scale on any mesh. ``--ckpt-dir`` checkpoints hold whole
arrays, as the reference's: every rank takes part in gathering them,
rank 0 writes them, and a resume cuts each rank's share again, on any
mesh.
``--production-mesh`` takes the reference's 16 x 16 (data, model) mesh,
which needs a world of 256 ranks and raises in any other.

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
  python -m repro_torch.launch.train --arch qwen3-8b --smoke --steps 3 \
      --global-batch 4 --seq-len 32 --device cpu --dp 2 --tp 2  # four
  python -m repro_torch.launch.train --arch dbrx-132b --smoke --steps 3 \
      --global-batch 4 --seq-len 32 --device cpu --pod 2 --tp 2 \
      --compress-grads                  # (pod 2, data 1, model 2)
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
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
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
                    help="the 16x16 (data, model) mesh: needs a world of "
                         "256 ranks, and raises in any other")
    ap.add_argument("--pod", type=int, default=1,
                    help="the pod axis: local ranks data parallel over "
                         "the batch with the params replicated; pod x dp "
                         "x tp ranks are started")
    ap.add_argument("--dp", type=int, default=1,
                    help="local ranks data parallel over the global batch "
                         "(gloo); with --tp, dp x tp ranks are started")
    ap.add_argument("--tp", type=int, default=1,
                    help="the model axis: local ranks tensor parallel over "
                         "the model's heads, d_ff and vocab, and expert "
                         "parallel over the MoE experts")
    ap.add_argument("--gemm-backend", default="auto",
                    help="GEMM backend (auto|matrixflow|blockflow|torch)")
    ap.add_argument("--gemm-mode", default="auto",
                    choices=["auto", "dc", "dm"],
                    help="paper access mode; auto = per-shape sysmodel pick")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    world = args.pod * args.dp * args.tp
    if world > 1 and not args.production_mesh and not dist.is_initialized():
        return run_cli("repro_torch.launch.train",
                       sys.argv[1:] if argv is None else argv, world)
    device = resolve_device(args.device)
    mesh = make_production_mesh() if args.production_mesh else \
        make_host_mesh(pod=args.pod, model=args.tp)
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

    def save(step):
        state = ST.full_state(cfg, {"params": params, "opt": opt_state},
                              mesh)
        if lead:
            ckpt.save(step, state, extra={"data": data.state_dict()})

    with api.use_policy(policy), api.use_attention_policy(UNFUSED):
        params = ST.rank_params(
            cfg, T.init_model(cfg, seed=args.seed, device=device), mesh)
        opt_state = adamw_init(params)
        start = 0
        if ckpt and ckpt.latest_step() is not None:
            state = ST.rank_state(cfg, ckpt.restore(
                {"params": params, "opt": opt_state}), mesh)
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
            if ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
        if ckpt:
            save(args.steps)
            ckpt.wait()
    print("[train] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
