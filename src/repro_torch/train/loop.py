"""Training loop with fault tolerance (``repro/train/loop.py``): auto-resume
from the latest checkpoint, checkpoint-and-exit on SIGTERM, a straggler
watchdog.

Training runs the paper's split: every GEMM through the active GEMM policy
(``TrainConfig.gemm``, else the device's default: the MatrixFlow kernel K1
on the card, whose backward is K1 again; its plain version on the CPU),
and attention through the ``unfused`` policy, the one attention with a
backward (its score and value products are K1's batched launches on the
card). The SSD families train on the CPU only: the scan kernel K6 has no
backward, here or in the reference, and the plain scan does not stand in
for a kernel on the card.

On a mesh (``Trainer(mesh=)``, ``launch/mesh.py``) every rank draws the
same global batch and runs ``launch/steps.py``'s step on its rows and its
cut of the params and moments (FSDP over ``data``, the rank's slices over
``model``). A checkpoint holds whole arrays: every rank takes part in
gathering them, rank 0 alone writes them (and logs), and a resume cuts
each rank's share again, whatever mesh wrote it.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import api
from repro_torch.core.plan import UNFUSED, GemmPolicy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Timer
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_map
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    seed: int = 0
    base_lr: float = 3e-4
    warmup: int = 20
    straggler_factor: float = 3.0   # step slower than 3× EMA → flagged
    aux_weight: float = 0.01
    compress_grads: bool = False
    gemm: Optional[GemmPolicy] = None   # None → the device's default policy
    device: str = "cuda"


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig,
                    mesh=None):
    """(params, opt_state, batch) → (params, opt_state, metrics): the step
    of ``launch/steps.py`` (``make_train_step_fn``) with the Trainer's
    schedule (``tc.base_lr``, ``tc.warmup`` over ``tc.steps``) and aux
    weight, under the GEMM policy ``tc.gemm`` (default: the device's) and
    unfused attention; on a ``mesh``, ``batch`` is the global batch and
    the params and state are the rank's cuts (``steps.rank_params``)."""
    gemm = tc.gemm or GemmPolicy()
    step = ST.make_train_step_fn(cfg, opt_cfg, total_steps=tc.steps,
                                 mesh=mesh, base_lr=tc.base_lr,
                                 warmup=tc.warmup, aux_weight=tc.aux_weight)

    def train_step(params, opt_state, batch):
        with api.use_policy(gemm), api.use_attention_policy(UNFUSED):
            return step(params, opt_state, batch)

    return train_step


def check_trainable(cfg: ModelConfig, device: torch.device) -> None:
    """Raise NotImplementedError for an SSD family on a CUDA device."""
    if device.type == "cuda" and cfg.family in T.SSD_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family!r} family on a CUDA "
            f"device needs a backward of the SSD scan kernel K6, which "
            f"neither package has (ROADMAP.md queue 3); it trains on the "
            f"CPU through the plain scan")


class Trainer:
    """Trainer on one device, or data parallel over a ``mesh``. Weights
    come from ``T.init_model(cfg, seed=tc.seed)`` or are handed in
    (``params``, e.g. the JAX init through ``convert.from_jax_params``); a
    checkpoint in ``tc.ckpt_dir`` resumes over either. Each step's host
    wall time (the loss read back, so the device has finished it) feeds
    the watchdog and ``step_times``."""

    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tc: TrainConfig, opt_cfg: Optional[AdamWConfig] = None, *,
                 params=None, mesh=None):
        self.device = resolve_device(tc.device)
        check_trainable(cfg, self.device)
        self.cfg, self.tc = cfg, tc
        self.opt_cfg = opt_cfg or AdamWConfig(
            lr=tc.base_lr, compress_grads=tc.compress_grads)
        self.data = TokenPipeline(data_cfg)
        self.ckpt = (CheckpointManager(tc.ckpt_dir)
                     if tc.ckpt_dir else None)
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0     # writes and logs
        if params is None:
            params = T.init_model(cfg, seed=tc.seed, device=self.device)
        self.params = ST.rank_params(
            cfg, tree_map(lambda t: t.detach().to(self.device), params),
            mesh)
        self.opt_state = adamw_init(self.params)
        self.start_step = 0
        self.step_times = []        # host wall seconds of each step run
        self._preempted = False
        if self.ckpt and self.ckpt.latest_step() is not None:
            self._resume()
        self._step_fn = make_train_step(cfg, self.opt_cfg, tc, mesh)

    # -- fault tolerance ------------------------------------------------
    def _resume(self):
        state = ST.rank_state(self.cfg, self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state}), self.mesh)
        self.params, self.opt_state = state["params"], state["opt"]
        meta = self.ckpt.meta()
        self.start_step = meta["step"]
        self.data.load_state_dict(meta["extra"]["data"])
        print(f"[trainer] resumed from step {self.start_step}")

    def _save(self, step: int):
        if not self.ckpt:
            return
        state = ST.full_state(self.cfg, {"params": self.params,
                                         "opt": self.opt_state}, self.mesh)
        if self.lead:
            self.ckpt.save(step, state,
                           extra={"data": self.data.state_dict()})

    def _on_sigterm(self, *_):
        self._preempted = True

    # -- loop -------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        old = signal.signal(signal.SIGTERM, self._on_sigterm)
        ema = None
        history = []
        try:
            for step in range(self.start_step, self.tc.steps):
                with Timer() as tm:
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in self.data.next_batch().items()}
                    self.params, self.opt_state, metrics = self._step_fn(
                        self.params, self.opt_state, batch)
                    loss = float(metrics["loss"])   # waits for the step
                dt = tm.dt
                self.step_times.append(dt)
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                if dt > self.tc.straggler_factor * ema and self.lead:
                    print(f"[watchdog] step {step} straggled: "
                          f"{dt:.3f}s vs EMA {ema:.3f}s")
                if step % self.tc.log_every == 0 or step == self.tc.steps - 1:
                    history.append((step, loss))
                    if self.lead:
                        print(f"[trainer] step {step} loss {loss:.4f} "
                              f"({dt*1e3:.0f} ms)")
                if self.tc.ckpt_every and (step + 1) % self.tc.ckpt_every == 0:
                    self._save(step + 1)
                if self._preempted:
                    print("[trainer] SIGTERM — checkpointing and exiting")
                    self._save(step + 1)
                    break
            final_step = step + 1
            self._save(final_step)
            if self.ckpt:
                self.ckpt.wait()
        finally:
            signal.signal(signal.SIGTERM, old)
        return {"history": history, "final_loss": history[-1][1],
                "params": self.params}
