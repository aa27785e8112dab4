"""Serving engine on one device (``repro/serving/engine.py``); every
projection and the LM head run the MatrixFlow GEMM.

**Paged mode** (``AttentionPolicy(backend="paged")``, the default): K/V
live in a page pool (``serving/kv_pool.py``) read through per-request
block tables by the paged attention kernel. Admission is **page-bound**: a
request is admitted while free pages cover its prompt, decode steps
allocate pages on demand, retirement returns them, and when the pool runs
dry the scheduler's victim is preempted — parked host-side and later
resumed by re-prefilling ``prompt + out``, with a token stream identical
to an uninterrupted run. ``submit``/``step`` key results by request id.

**Contiguous mode** (any other backend: ``fused``, the flash kernel, or
``unfused``): each slot owns a ``(max_len,)`` row of contiguous K/V
caches. Admission is **slot-bound** (``submit`` returns None when no slot
is free), nothing is preempted, and ``submit``/``step``/``cancel`` key
requests by slot id, as the reference's non-paged engine does.

Prefill is *masked*: every other batch row, and the padding columns of the
power-of-two **bucketed prefill**, carry position −1 — they write no K/V
and do not advance the valid length — so one slot's prefill cannot corrupt
another's cache.

**Mamba-2 / Zamba-2** (families ``ssm``, ``hybrid``) serve in contiguous
mode only (their default policy is ``auto``, which resolves to ``fused``
on the card and ``unfused`` on the CPU; an explicit ``paged`` policy
raises): SSD and conv state carries no positions, so it cannot be paged,
masked per slot or continued by a later prefill chunk. As in the
reference, ``submit`` admits them only with ``batch_slots=1`` and their
prefill is unpadded; a recycled slot's SSD state is zeroed. A chunked
prefill (``Scheduler(prefill_chunk=N)``) would drop the earlier chunks'
state, so the engine refuses it for these families.

**int8**: ``weight_dtype="int8"`` quantizes every projection weight at
pack time and runs the W8A8 GEMM route (the dequant-fused MatrixFlow
kernel on the card); ``kv_dtype="int8"`` (paged mode only) stores the page
pools int8 with one fp32 scale per (page, kv head), frozen at the page's
first row, and the paged kernel dequantizes each page as it reads it.

Not ported yet, each rejected with NotImplementedError: the prefix
cache, speculative decoding, observability and tensor parallelism
(ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import api
from repro_torch.core.plan import AttentionPolicy, GemmPolicy
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.serving.kv_pool import BlockTable, PagePool
from repro_torch.serving.scheduler import RequestView, Scheduler


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 1024
    temperature: float = 0.0     # 0 → greedy
    cache_dtype: str = "bfloat16"
    gemm: Optional[GemmPolicy] = None   # None → the ambient/default policy
    pack_weights: bool = False          # resident block-major weights
    attention: Optional[AttentionPolicy] = None  # None → AttentionPolicy("paged"),
    # or "auto" (contiguous) for the SSD families
    # ("paged" pages the KV cache; "fused" — the flash kernel — and
    # "unfused" serve from contiguous (batch_slots, max_len) caches)
    cache_pages: Optional[int] = None
    # paged only: total pages in the KV pool. None → the contiguous-equivalent budget
    # batch_slots * ceil(max_len / page_size); smaller values make
    # admission page-bound (preemption engages).
    scheduler: Optional[Scheduler] = None   # None → Scheduler() (FIFO)
    device: str = "cuda"
    weight_dtype: Optional[str] = None  # "int8" → W8A8 GEMMs, int8 weights
    # quantized at pack time (implies resident packed weights)
    kv_dtype: Optional[str] = None  # paged only: "int8" → int8 KV pages with
    # per-page-per-head fp32 scales, dequantized inside the paged kernel
    # Features of the reference engine not ported yet: setting any of these
    # raises NotImplementedError (ROADMAP.md lists them).
    mesh: Optional[object] = None
    prefix_cache: bool = False
    spec: Optional[object] = None
    obs: Optional[object] = None

    def policy(self) -> Optional[GemmPolicy]:
        """The effective GemmPolicy: ``gemm`` with ``weight_dtype`` folded
        in (None → the ambient policy)."""
        if self.weight_dtype is None:
            return self.gemm
        return dataclasses.replace(self.gemm or GemmPolicy(),
                                   weight_dtype=self.weight_dtype)

    def attn_policy(self, pageable: bool = True) -> AttentionPolicy:
        """The effective AttentionPolicy: ``attention`` (default paged; for
        a model whose state cannot be paged, ``pageable=False``, default
        ``auto``) with ``kv_dtype`` folded in."""
        attn = self.attention or AttentionPolicy(
            backend="paged" if pageable else "auto")
        if self.kv_dtype is None:
            return attn
        return dataclasses.replace(attn, kv_dtype=self.kv_dtype)


@dataclasses.dataclass
class _Waiting:
    """A preempted request parked off-device: everything needed to rebuild
    its cache by re-prefilling ``prompt + out`` and continue the stream.
    ``next_tok`` is None only for a request preempted mid-chunked-prefill;
    ``generator`` then draws its first sample on resume."""
    rid: int
    prompt: List[int]
    out: List[int]
    next_tok: Optional[int]
    generator: Optional[torch.Generator] = None
    priority: int = 0
    deadline: Optional[float] = None
    arrival: int = 0


class ServingEngine:
    """Greedy/temperature sampling with page-bound continuous batching."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig):
        for name in ("mesh", "spec", "obs"):
            if getattr(sc, name) is not None:
                raise NotImplementedError(
                    f"ServeConfig.{name} is not ported yet (ROADMAP.md)")
        if sc.prefix_cache:
            raise NotImplementedError(
                "ServeConfig.prefix_cache is not ported yet (ROADMAP.md)")
        T.check_supported(cfg)
        if torch_dtype(sc.cache_dtype) != cfg.param_dtype:
            raise NotImplementedError(
                f"cache_dtype={sc.cache_dtype!r} differs from the model's "
                f"{cfg.dtype!r}: the attention kernels read q and the cache "
                f"in one dtype; mixed dtypes are not ported (ROADMAP.md)")
        self.device = resolve_device(sc.device)
        pageable = cfg.family not in T.SSD_FAMILIES
        attn = sc.attn_policy(pageable)   # validates kv_dtype
        self.gemm = sc.policy()           # validates weight_dtype
        attn = dataclasses.replace(attn, backend=attn.resolved_backend(
            self.device, pageable=pageable))
        self.paged = attn.backend == "paged"
        if attn.kv_dtype is not None and not self.paged:
            raise ValueError(
                "ServeConfig.kv_dtype requires a paged attention policy "
                "(backend 'paged'): only the page pool stores quantized K/V")
        params = _to_device(params, self.device)
        # Quantizing per call would redo the O(K·N) weight quantization on
        # every step; weights are static, so weight_dtype quantizes at pack.
        if sc.pack_weights or sc.weight_dtype is not None:
            params = api.pack_model_weights(params, self.gemm)
        self.cfg, self.params, self.sc, self.attn = cfg, params, sc, attn
        self.scheduler = sc.scheduler if sc.scheduler is not None \
            else Scheduler()
        self.ssd = cfg.family in T.SSD_FAMILIES
        if self.ssd and self.scheduler.prefill_chunk:
            raise NotImplementedError(
                f"chunked prefill (prefill_chunk="
                f"{self.scheduler.prefill_chunk}) of an SSM family: a prefill "
                f"with a cache starts the SSD state from zero, so every chunk "
                f"after the first would drop the earlier chunks' state; "
                f"prefill SSM prompts whole (ROADMAP.md)")
        B = sc.batch_slots
        self.slot_rid = np.full(B, -1, np.int64)
        self.wait: List[_Waiting] = []
        # rid → the request's output stream (paged mode); entries persist
        # past retirement so the caller can read a finished stream.
        self.request_out: Dict[int, List[int]] = {}
        self._next_rid = 0
        self.block_tables = None
        if self.paged:
            ps = attn.page_size
            self.n_blocks = -(-sc.max_len // ps)
            n_pages = (sc.cache_pages if sc.cache_pages is not None
                       else B * self.n_blocks)
            if n_pages < self.n_blocks:
                raise ValueError(
                    f"cache_pages={n_pages} cannot back even one full-length "
                    f"request (ceil(max_len/page_size) = {self.n_blocks} "
                    f"pages); a preempted request could never resume")
            self.pool = PagePool(n_pages, ps)
            self.caches = T.init_paged_caches(cfg, B, n_pages, ps,
                                              sc.cache_dtype, self.device,
                                              kv_dtype=attn.kv_dtype)
            self.block_tables = np.zeros((B, self.n_blocks), np.int32)
            self.slot_tables: List[Optional[BlockTable]] = [None] * B
        else:
            self.caches = T.init_caches(cfg, B, sc.max_len, sc.cache_dtype,
                                        self.device)
        self.slot_pos = np.zeros(B, np.int32)
        self.slot_live = np.zeros(B, bool)
        self.slot_out: List[List[int]] = [[] for _ in range(B)]
        self.slot_prompt: List[List[int]] = [[] for _ in range(B)]
        # Next sampled token per slot, decoded but not yet reported.
        self.slot_next = np.zeros(B, np.int32)
        # A draining slot's cache is full: step() reports its last pending
        # token, then retires it.
        self.slot_drain = np.zeros(B, bool)
        # Chunked prefill: a prefilling slot holds its pages and slot but is
        # not decodable until step() has run its last chunk.
        self.slot_prefilling = np.zeros(B, bool)
        self.slot_pf_tokens: List[Optional[List[int]]] = [None] * B
        self.slot_pf_restore: List[Optional[_Waiting]] = [None] * B
        self.slot_pf_gen: List[Optional[torch.Generator]] = [None] * B
        self.slot_priority = np.zeros(B, np.int64)
        self.slot_deadline: List[Optional[float]] = [None] * B
        self.slot_arrival = np.zeros(B, np.int64)
        self.tick = 0
        self.n_preemptions = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0

    # -- device calls ---------------------------------------------------------
    def _scope(self):
        stack = contextlib.ExitStack()
        if self.gemm is not None:
            stack.enter_context(api.use_policy(self.gemm))
        stack.enter_context(api.use_attention_policy(self.attn))
        return stack

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.no_grad()
    def _forward(self, tokens: np.ndarray, positions: np.ndarray,
                 last_cols: Optional[np.ndarray] = None) -> torch.Tensor:
        """One masked forward over the KV caches: (B, vocab) logits of
        each row's column ``last_cols[b]`` (default: the last column)."""
        batch = {"tokens": self._dev(tokens), "positions": self._dev(positions)}
        if self.paged:
            batch["block_tables"] = self._dev(self.block_tables)
        if last_cols is None:
            last_cols = np.full(tokens.shape[0], tokens.shape[1] - 1, np.int64)
        with self._scope():
            logits, _ = T.forward(self.params, self.cfg, batch,
                                  caches=self.caches,
                                  last_cols=self._dev(last_cols))
        return logits[:, 0]

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy argmax at temperature 0 (or without a generator), else a
        softmax sample at ServeConfig.temperature drawn on the CPU from
        ``generator`` (self-consistent under a seed; it cannot reproduce
        the JAX engine's ``jax.random`` draws)."""
        if self.sc.temperature > 0 and generator is not None:
            probs = torch.softmax(logits.float().cpu() / self.sc.temperature,
                                  dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0].numpy()
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _reset_slot_caches(self, slots) -> None:
        """Restart ``slots`` (an index or a slice) from position 0: zero
        their KV caches' valid lengths and, in SSD layers, their conv and
        SSD states, which carry no lengths."""
        for c in self.caches:
            if "state" in c:
                c["state"][slots] = 0
                for t in c["conv"].values():
                    t[slots] = 0
            else:
                c["len"][slots] = 0

    def _handle(self, slot: int) -> int:
        """What submit()/step() key results by: request id in paged mode
        (requests migrate across slots under preemption), slot id else."""
        return int(self.slot_rid[slot]) if self.paged else slot

    def _view(self, slot: int) -> RequestView:
        return RequestView(
            rid=self._handle(slot), priority=int(self.slot_priority[slot]),
            deadline=self.slot_deadline[slot],
            arrival=int(self.slot_arrival[slot]),
            n_tokens=int(self.slot_pos[slot]),
            prefilling=bool(self.slot_prefilling[slot]))

    def _slot_of_rid(self, rid: int) -> int:
        for s in range(self.sc.batch_slots):
            if self.slot_live[s] and self._handle(s) == rid:
                return s
        live = sorted(self._handle(s) for s in range(self.sc.batch_slots)
                      if self.slot_live[s])
        raise RuntimeError(
            f"scheduler victim() returned rid {rid}, which is not a live "
            f"request (live rids: {live}); victim() must return the rid of "
            f"one of the RequestViews it was passed")

    # -- batched generation -----------------------------------------------------
    def generate(self, prompts: np.ndarray, n_tokens: int,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts: (B, S) int — B must equal batch_slots. Returns
        (B, n_tokens) generated ids. In-flight submit() requests are
        dropped and every slot restarts from position 0; in paged mode
        every row gets pages for its whole S + n_tokens horizon up
        front."""
        B, S = prompts.shape
        if B != self.sc.batch_slots:
            raise ValueError(
                f"generate() got prompts shaped {tuple(prompts.shape)} "
                f"(batch {B}), but this engine was built with "
                f"ServeConfig.batch_slots={self.sc.batch_slots}")
        if S + n_tokens > self.sc.max_len:
            raise ValueError(f"generate() horizon S+n_tokens = "
                             f"{S + n_tokens} exceeds max_len={self.sc.max_len}")
        self._reset_state()
        if self.paged:
            need = self.pool.pages_needed(S + n_tokens)
            if not self.pool.can_alloc(need * B):
                raise ValueError(
                    f"batched generate needs {need * B} pages ({need}/row), "
                    f"pool holds {self.pool.n_pages}; raise cache_pages or "
                    f"use submit()/step() admission")
            for s in range(B):
                tbl = BlockTable(self.pool)
                tbl.ensure(S + n_tokens)
                self.slot_tables[s] = tbl
                tbl.as_row(self.n_blocks, out=self.block_tables[s])
        positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        tok = self._sample(self._forward(prompts.astype(np.int64), positions),
                           generator)
        out = []
        for i in range(n_tokens):
            out.append(tok)
            pos = np.full((B, 1), S + i, np.int32)
            tok = self._sample(self._forward(tok[:, None].astype(np.int64),
                                             pos), generator)
        self._reset_state()
        return np.stack(out, axis=1)

    def _reset_state(self):
        """Drop every in-flight request, zero every slot's cache length
        and, in paged mode, return all pages to the pool."""
        for s in range(self.sc.batch_slots):
            if self.paged and self.slot_tables[s] is not None:
                self.slot_tables[s].free()
                self.slot_tables[s] = None
            if self.slot_live[s]:
                self.request_out.pop(int(self.slot_rid[s]), None)
        for w in self.wait:
            self.request_out.pop(w.rid, None)
        self._reset_slot_caches(slice(None))
        if self.paged:
            self.block_tables[:] = 0
        self.slot_rid[:] = -1
        self.slot_live[:] = False
        self.slot_drain[:] = False
        self.slot_pos[:] = 0
        self.slot_prefilling[:] = False
        self.slot_pf_tokens = [None] * self.sc.batch_slots
        self.slot_pf_restore = [None] * self.sc.batch_slots
        self.slot_pf_gen = [None] * self.sc.batch_slots
        self.wait.clear()

    # -- continuous batching ------------------------------------------------------
    def submit(self, prompt: List[int],
               generator: Optional[torch.Generator] = None, *,
               priority: int = 0,
               deadline: Optional[float] = None) -> Optional[int]:
        """Admit a request; returns its handle (paged: request id,
        contiguous: slot id), or None when it cannot be admitted now:
        contiguous mode needs a free slot; paged mode a free slot with
        enough free pages, or a preemptible victim.

        The prompt runs as a masked, bucketed prefill (whole, or its first
        chunk under ``Scheduler(prefill_chunk=N)``); its last-position
        logits seed the pending first token, which step() reports first.
        ``priority`` (0 = most urgent) and ``deadline`` feed the scheduler:
        in paged mode an incoming request may preempt a strictly less
        urgent live one.
        """
        if self.ssd and self.sc.batch_slots > 1:
            raise NotImplementedError(
                "slot-based submit() requires position-masked cache updates; "
                "SSD/conv recurrent states carry no positions, so a masked "
                "single-slot prefill cannot leave other slots' SSM state "
                "untouched. Use generate(), or batch_slots=1 where no other "
                "slot exists.")
        if not 0 < len(prompt) < self.sc.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} out of range for "
                f"max_len={self.sc.max_len} (need 1 <= len < max_len)")
        prompt = [int(t) for t in prompt]
        self.tick += 1
        arrival = self.tick
        if not self.paged:
            free = np.where(~self.slot_live)[0]
            if free.size == 0:
                return None
            slot = int(free[0])
            self._stage(slot, -1, prompt, prompt, generator=generator,
                        priority=priority, deadline=deadline,
                        arrival=arrival)
            return slot
        incoming = RequestView(rid=self._next_rid, priority=priority,
                               deadline=deadline, arrival=arrival,
                               n_tokens=len(prompt))
        while True:
            free = np.where(~self.slot_live)[0]
            if free.size and self._paged_admit(
                    int(free[0]), self._next_rid, prompt, prompt,
                    generator=generator, priority=priority,
                    deadline=deadline, arrival=arrival):
                rid = self._next_rid
                self._next_rid += 1
                return rid
            live = [s for s in range(self.sc.batch_slots)
                    if self.slot_live[s]]
            if not live:
                return None
            vrid = self.scheduler.victim([self._view(s) for s in live])
            vslot = self._slot_of_rid(vrid)
            if not self.scheduler.should_preempt(incoming, self._view(vslot)):
                return None
            self._preempt(vslot)

    def _paged_admit(self, slot: int, rid: int, prompt: List[int],
                     tokens: List[int], *,
                     restore: Optional[_Waiting] = None,
                     generator: Optional[torch.Generator] = None,
                     priority: int = 0, deadline: Optional[float] = None,
                     arrival: int = 0) -> bool:
        """Admit ``tokens`` into ``slot``: page budget, block-table
        assembly, then the first masked prefill chunk. Returns False, with
        no side effects, when free pages cannot cover it."""
        if not self.pool.can_alloc(self.pool.pages_needed(len(tokens))):
            return False
        tbl = BlockTable(self.pool)
        tbl.ensure(len(tokens))
        self.slot_tables[slot] = tbl
        tbl.as_row(self.n_blocks, out=self.block_tables[slot])
        self._stage(slot, rid, prompt, tokens, restore=restore,
                    generator=generator, priority=priority,
                    deadline=deadline, arrival=arrival)
        return True

    def _stage(self, slot: int, rid: int, prompt: List[int],
               tokens: List[int], *, restore: Optional[_Waiting] = None,
               generator: Optional[torch.Generator] = None,
               priority: int = 0, deadline: Optional[float] = None,
               arrival: int = 0) -> None:
        """Stage ``tokens`` into ``slot`` and run the first masked prefill
        chunk; a recycled slot restarts from position 0."""
        self.slot_rid[slot] = rid
        self.slot_prompt[slot] = prompt
        self.slot_priority[slot] = priority
        self.slot_deadline[slot] = deadline
        self.slot_arrival[slot] = arrival
        if self.slot_pos[slot]:          # recycled slot: restart from pos 0
            self._reset_slot_caches(slot)
            self.slot_pos[slot] = 0
        self.slot_live[slot] = True
        self.slot_drain[slot] = False
        self.slot_prefilling[slot] = True
        self.slot_pf_tokens[slot] = tokens
        self.slot_pf_restore[slot] = restore
        self.slot_pf_gen[slot] = generator
        self.slot_out[slot] = restore.out if restore is not None else []
        if restore is None and self.paged:
            self.request_out[rid] = self.slot_out[slot]
        self._prefill_slot_chunk(slot)

    def _prefill_slot_chunk(self, slot: int) -> bool:
        """Run one masked, bucketed prefill chunk for ``slot``; True when
        the prompt is fully prefilled and the slot became decodable."""
        tokens = self.slot_pf_tokens[slot]
        L = len(tokens)
        p0 = int(self.slot_pos[slot])
        n = min(self.scheduler.prefill_chunk or (L - p0), L - p0)
        B = self.sc.batch_slots
        # bucket padding columns carry position -1, a mask SSD/conv state
        # knows nothing of: those families prefill unpadded
        Sb = n if self.ssd else min(_next_pow2(n), max(self.sc.max_len, n))
        tok = np.zeros((B, Sb), np.int64)
        tok[slot, :n] = tokens[p0:p0 + n]
        pos = np.full((B, Sb), -1, np.int32)
        pos[slot, :n] = np.arange(p0, p0 + n)
        logits = self._forward(tok, pos, np.full(B, n - 1, np.int64))
        self.prefill_tokens += n
        self.slot_pos[slot] = p0 + n
        if p0 + n < L:
            return False
        self.slot_prefilling[slot] = False
        self.slot_drain[slot] = L >= self.sc.max_len
        restore = self.slot_pf_restore[slot]
        if restore is not None and restore.next_tok is not None:
            self.slot_next[slot] = restore.next_tok
        else:
            self.slot_next[slot] = int(self._sample(
                logits[slot][None], self.slot_pf_gen[slot])[0])
        self.slot_pf_tokens[slot] = None
        self.slot_pf_restore[slot] = None
        self.slot_pf_gen[slot] = None
        return True

    def _preempt(self, slot: int):
        """Spill ``slot``'s request to the wait queue: free its pages, park
        prompt/stream/pending token host-side."""
        if self.slot_prefilling[slot]:
            restore = self.slot_pf_restore[slot]
            next_tok = None if restore is None else restore.next_tok
            generator = self.slot_pf_gen[slot]
        else:
            next_tok = int(self.slot_next[slot])
            generator = None
        self.wait.append(_Waiting(
            rid=int(self.slot_rid[slot]), prompt=self.slot_prompt[slot],
            out=self.slot_out[slot], next_tok=next_tok, generator=generator,
            priority=int(self.slot_priority[slot]),
            deadline=self.slot_deadline[slot],
            arrival=int(self.slot_arrival[slot])))
        self.n_preemptions += 1
        self._release_slot(slot)
        # slot_pos stays nonzero → the next admission resets this slot's caches

    def _release_slot(self, slot: int):
        if self.paged:
            self.slot_tables[slot].free()
            self.slot_tables[slot] = None
            self.block_tables[slot] = 0
        self.slot_rid[slot] = -1
        self.slot_live[slot] = False
        self.slot_drain[slot] = False
        self.slot_prefilling[slot] = False
        self.slot_pf_tokens[slot] = None
        self.slot_pf_restore[slot] = None
        self.slot_pf_gen[slot] = None

    def _try_resume(self):
        """Re-admit waiting requests into free slots in the scheduler's
        order; a waiter that does not fit is skipped, not a barrier."""
        if not self.wait:
            return
        views = [RequestView(rid=w.rid, priority=w.priority,
                             deadline=w.deadline, arrival=w.arrival,
                             n_tokens=len(w.prompt) + len(w.out))
                 for w in self.wait]
        admitted = []
        for i in self.scheduler.resume_order(views):
            free = np.where(~self.slot_live)[0]
            if free.size == 0:
                break
            w = self.wait[i]
            if self._paged_admit(int(free[0]), w.rid, w.prompt,
                                 w.prompt + w.out, restore=w,
                                 generator=w.generator, priority=w.priority,
                                 deadline=w.deadline, arrival=w.arrival):
                admitted.append(i)
        for i in sorted(admitted, reverse=True):
            self.wait.pop(i)

    def _grow_pages_for_decode(self):
        """Back every decodable slot's next position with a page, oldest
        request first; when the pool is dry, preempt the scheduler's
        victim (possibly the requester itself) until it is not."""
        order = sorted(
            (s for s in range(self.sc.batch_slots)
             if self.slot_live[s] and not self.slot_drain[s]
             and not self.slot_prefilling[s]),
            key=lambda s: self.slot_rid[s])
        for s in order:
            if not self.slot_live[s]:
                continue               # preempted by an older slot's growth
            pos = int(self.slot_pos[s])
            if pos >= self.slot_tables[s].capacity():
                while not self.pool.can_alloc(1):
                    vrid = self.scheduler.victim(
                        [self._view(t) for t in range(self.sc.batch_slots)
                         if self.slot_live[t]])
                    victim = self._slot_of_rid(vrid)
                    self._preempt(victim)
                    if victim == s:
                        break
                if not self.slot_live[s]:
                    continue
                self.slot_tables[s].ensure(pos + 1)
            self.slot_tables[s].as_row(self.n_blocks,
                                       out=self.block_tables[s])

    def cancel(self, rid: int) -> bool:
        """Abort a request by the handle submit() returned (request id in
        paged mode, slot id else), releasing its slot — and, when paged,
        its pages (or its wait-queue entry). Returns True if found."""
        if not self.paged:
            if 0 <= rid < self.sc.batch_slots and self.slot_live[rid]:
                self._release_slot(rid)
                return True
            return False
        for s in range(self.sc.batch_slots):
            if self.slot_live[s] and self.slot_rid[s] == rid:
                self._release_slot(s)
                self.request_out.pop(rid, None)
                return True
        for i, w in enumerate(self.wait):
            if w.rid == rid:
                self.wait.pop(i)
                self.request_out.pop(rid, None)
                return True
        return False

    def step(self, generator: Optional[torch.Generator] = None
             ) -> Dict[int, int]:
        """One decode iteration across all live slots; returns
        {request id: token}.

        Resumes waiting requests first, advances at most one chunked
        prefill, backs each decodable slot's next position with a page
        (preempting when the pool is dry), then decodes: each slot reports
        its pending token and the decode of the one after is pipelined —
        the order generate() uses, so streams match the batched path token
        for token. A slot whose cache fills drains: its last pending token
        is reported, then it retires.
        """
        self.tick += 1
        if self.paged:
            self._try_resume()
        if not self.slot_live.any():
            return {}
        pf = [s for s in range(self.sc.batch_slots)
              if self.slot_prefilling[s]]
        if pf:
            s = min(pf, key=lambda t: (self.slot_priority[t],
                                       self.slot_arrival[t], t))
            self._prefill_slot_chunk(s)
        if self.paged:
            self._grow_pages_for_decode()
        decodable = (self.slot_live & ~self.slot_drain
                     & ~self.slot_prefilling)
        nxt = None
        if decodable.any():
            tok = self.slot_next.astype(np.int64)[:, None]
            pos = np.where(decodable, self.slot_pos, -1).astype(np.int32)
            nxt = self._sample(self._forward(tok, pos[:, None]), generator)
            self.decode_tokens += int(decodable.sum())
        out = {}
        for s in range(self.sc.batch_slots):
            if not self.slot_live[s] or self.slot_prefilling[s]:
                continue
            t = int(self.slot_next[s])
            self.slot_out[s].append(t)
            out[self._handle(s)] = t
            if self.slot_drain[s]:
                self._release_slot(s)
                continue
            self.slot_next[s] = int(nxt[s])
            self.slot_pos[s] += 1
            if self.slot_pos[s] >= self.sc.max_len:
                self.slot_drain[s] = True
        return out

    def kv_page_bytes(self) -> int:
        """Device bytes of one pool page, summed over layers and K/V — the
        int8 pools' fp32 scale rows included."""
        return sum(c[name][0].numel() * c[name].element_size()
                   for c in self.caches
                   for name in ("kp", "vp", "k_scale", "v_scale")
                   if name in c)

    def stats(self) -> Dict[str, object]:
        """Scheduling churn, prefill/decode token split and, in paged mode,
        pool pressure and the pool's bytes."""
        d = {
            "tick": self.tick,
            "live_requests": int(self.slot_live.sum()),
            "waiting_requests": len(self.wait),
            "n_preemptions": self.n_preemptions,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
        }
        if self.paged:
            page_bytes = self.kv_page_bytes()
            d.update(pool_pages=self.pool.n_pages,
                     pool_free_pages=self.pool.free_pages,
                     pool_pages_in_use=self.pool.pages_in_use,
                     pool_high_water=self.pool.high_water,
                     kv_dtype=self.attn.kv_dtype or str(self.sc.cache_dtype),
                     kv_page_bytes=page_bytes,
                     kv_pool_bytes=page_bytes * self.pool.n_pages,
                     kv_bytes_in_use=page_bytes * self.pool.pages_in_use)
        return d


def _to_device(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return node.to(device)
