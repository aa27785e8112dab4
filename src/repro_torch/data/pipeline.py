"""Sharded token data pipeline with checkpointable iterator state: a copy
of ``repro/data/pipeline.py`` (numpy only), so batches are bitwise the
reference's.

Sources:
  * "synthetic" — deterministic PRNG token stream (reproducible; used by the
    examples, smoke tests, and the dry-run-adjacent training demos).
  * "memmap"    — flat uint16/uint32 token file (numpy memmap), the standard
    pre-tokenized-corpus format; sharded by host.

The iterator state is a single integer cursor (plus the PRNG seed), so
checkpoint/restore and elastic restarts (different data-parallel size) are
exact: each host recomputes its shard slice from the global cursor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    source: str = "synthetic"          # "synthetic" | "memmap"
    path: Optional[str] = None
    seed: int = 0
    n_codebooks: int = 0               # musicgen-style multi-stream tokens
    n_image_tokens: int = 0            # vlm stub: embeds prepended


class TokenPipeline:
    """Deterministic, restartable token batch iterator."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.cursor = 0  # global step cursor — THE checkpointable state
        if cfg.source == "memmap":
            assert cfg.path, "memmap source needs a path"
            self._data = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        else:
            self._data = None

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict:
        return {"cursor": self.cursor, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.cursor = int(state["cursor"])

    # -- batch synthesis -----------------------------------------------------
    def _host_batch_range(self):
        per_host = self.cfg.global_batch // self.n_hosts
        lo = self.host_id * per_host
        return lo, lo + per_host

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        lo, hi = self._host_batch_range()
        rows = []
        for b in range(lo, hi):
            rows.append(self._row(self.cursor, b))
        self.cursor += 1
        tokens = np.stack(rows)
        batch = {"tokens": tokens}
        if cfg.n_image_tokens:
            rng = np.random.default_rng(cfg.seed + self.cursor)
            batch["embeds"] = rng.standard_normal(
                (hi - lo, cfg.n_image_tokens, 1)).astype(np.float32)
        return batch

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        shape = ((cfg.seq_len, cfg.n_codebooks) if cfg.n_codebooks
                 else (cfg.seq_len,))
        if self._data is not None:
            n = self._data.shape[0] - cfg.seq_len - 1
            off = (step * cfg.global_batch + row) * cfg.seq_len % max(n, 1)
            return np.asarray(self._data[off:off + cfg.seq_len],
                              dtype=np.int32)
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + row)
        # structured synthetic stream: next-token == current-token with
        # p=0.9 (a copy task) — steep, model-agnostic learning signal for
        # the examples and loss-decreases tests; CE floor ≈ 0.6 nats.
        base = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
        out = base.copy()
        copy_mask = rng.random(shape) < 0.9
        for t in range(1, shape[0]):
            out[t] = np.where(copy_mask[t], out[t - 1], base[t])
        return out.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
