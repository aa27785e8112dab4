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

**MLA** (deepseek-v2) serves in contiguous mode only: its latent cache is
not paged, in the reference either. Its default policy is ``auto``, which
resolves to ``fused`` on the card and ``unfused`` on the CPU; an explicit
``paged`` policy raises. **Multi-codebook models** (musicgen) are refused
at construction: the reference's engine cannot serve their (B, S,
n_codebooks) tokens either, and they run through ``transformer.forward``.

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

**Prefix cache** (``prefix_cache=True``, paged mode only): full prompt
pages are shared across requests through a copy-on-write radix cache
(``serving/prefix_cache.py``). Admission looks the prompt up, borrows
every cached full page (pool ref counts), forks the first divergent page
(``_copy_page``: one indexed device copy per layer's pools, int8 scale
rows included) and prefills only the uncached tail; a finished prefill
indexes its prompt pages, and cold entries evict by LRU on demand or
down to ``prefix_watermark`` free pages at the start of each step.

**Speculative decoding** (``spec=<Drafter>``, ``serving/spec_decode.py``;
greedy only, not for the SSD families): each step drafts up to ``spec.k``
tokens per request, verifies them in one masked forward (Sq = 1 + k at
each slot's offset, the argmax of every column), keeps the longest
agreeing prefix plus the bonus token and rolls the rest back (valid
lengths reset; paged: ``BlockTable.truncate``). ``step()`` then returns
``{handle: [tokens]}`` bursts; greedy streams equal ``spec=None``'s.

**Observability** (``obs=Observability()``, ``repro_torch/obs``): the
instruments are registered once in ``__init__``; every hook is host-side
behind ``if obs.enabled:`` and adds no device synchronization (``step()``
already brings the sampled tokens to the host). ``request_trace(handle)``
is the per-request lifecycle record; ``stats()`` is plain JSON.

**Tensor parallelism** (``ServeConfig.mesh``, a mesh of
``launch/mesh.py`` over a ``torch.distributed`` group): every rank runs
this engine on the same requests, under a ``distributed/tp.py`` context —
column-parallel QKV/up projections, row-parallel out/down projections
with an fp32 all-reduce, attention on the rank's heads over per-rank KV
pools, the LM head's vocab slices gathered before sampling. Each rank
holds only its slice of the weights and its KV heads of the pools; host
scheduling and page accounting are the same on every rank by
construction, and so is every sampled token (the gathered logits are
bitwise the same on every rank; temperature sampling needs every rank's
generator in the same state). Resident packed weights are refused under
a mesh, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import api
from repro_torch.core.plan import AttentionPolicy, GemmPolicy, \
    ShardingPolicy
from repro_torch.distributed import tp as TP
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_axes
from repro_torch.obs import NULL_OBS, Observability, RequestTrace
from repro_torch.obs.metrics import TIME_BUCKETS_S, json_scalars
from repro_torch.serving.kv_pool import BlockTable, PagePool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import RequestView, Scheduler


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _policy_scope(policy: Optional[GemmPolicy],
                  attn: Optional[AttentionPolicy],
                  tpctx: Optional[TP.TPContext]) -> contextlib.ExitStack:
    stack = contextlib.ExitStack()
    if policy is not None:
        stack.enter_context(api.use_policy(policy))
    if attn is not None:
        stack.enter_context(api.use_attention_policy(attn))
    stack.enter_context(TP.use_tp(tpctx))
    return stack


def make_forward_step(cfg: ModelConfig, policy: Optional[GemmPolicy] = None,
                      attn: Optional[AttentionPolicy] = None,
                      tpctx: Optional[TP.TPContext] = None):
    """(params, batch, caches, last_cols) → (logits, caches): the masked
    forward over the caches that every serving step runs, under these
    policies and TP context (None pins no TP), the caches written in
    place. ``last_cols`` (B,) puts only each row's column ``last_cols[b]``
    through the final norm and the head, (B, 1, vocab); None, every
    column, (B, S, vocab) (the speculative verify)."""
    def forward_step(params, batch, caches, last_cols=None):
        with _policy_scope(policy, attn, tpctx):
            logits, caches, _ = T.forward(params, cfg, batch, caches=caches,
                                          last_cols=last_cols)
        return logits, caches
    return forward_step


def make_prefill_step(cfg: ModelConfig, policy: Optional[GemmPolicy] = None,
                      attn: Optional[AttentionPolicy] = None,
                      tpctx: Optional[TP.TPContext] = None):
    """(params, batch, caches) → (last_logits (B, vocab), caches): the
    prompt under causal self-attention, the caches written in place. As
    the engine does, only each row's last real column — ``batch
    ["last_cols"]`` (B,), default the last column — goes through the
    final norm and the head. ``batch`` may carry ``block_tables`` for
    paged caches; ``tpctx`` runs it tensor-parallel."""
    forward = make_forward_step(cfg, policy, attn, tpctx)

    def prefill_step(params, batch, caches):
        positions = batch["positions"]
        last = batch.get("last_cols")
        if last is None:
            last = torch.full((positions.shape[0],), positions.shape[1] - 1,
                              dtype=torch.int64, device=positions.device)
        logits, caches = forward(
            params, {k: v for k, v in batch.items() if k != "last_cols"},
            caches, last)
        return logits[:, 0], caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, policy: Optional[GemmPolicy] = None,
                     attn: Optional[AttentionPolicy] = None,
                     tpctx: Optional[TP.TPContext] = None):
    """(params, tokens (B, 1), positions (B, 1), caches[, block_tables]) →
    (logits (B, vocab), caches): one decode step, as the engine runs it;
    ``block_tables`` is None for contiguous caches."""
    forward = make_forward_step(cfg, policy, attn, tpctx)

    def decode_step(params, tokens, positions, caches, block_tables=None):
        batch = {"tokens": tokens, "positions": positions}
        if block_tables is not None:
            batch["block_tables"] = block_tables
        last = torch.zeros((tokens.shape[0],), dtype=torch.int64,
                           device=tokens.device)
        logits, caches = forward(params, batch, caches, last)
        return logits[:, 0], caches
    return decode_step


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 1024
    temperature: float = 0.0     # 0 → greedy
    cache_dtype: str = "bfloat16"
    gemm: Optional[GemmPolicy] = None   # None → the ambient/default policy
    pack_weights: bool = False          # resident block-major weights
    attention: Optional[AttentionPolicy] = None  # None → AttentionPolicy("paged"),
    # or "auto" (contiguous) for the SSD families and MLA
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
    prefix_cache: bool = False
    # paged only: share full prompt-prefix KV pages across requests through
    # a copy-on-write radix cache (serving/prefix_cache.py)
    prefix_watermark: int = 0
    # with prefix_cache: evict cold cached entries at step() start until at
    # least this many pool pages are free; 0 → evict only on demand
    spec: Optional[object] = None
    # speculative decoding: a Drafter (serving/spec_decode.py) proposing up
    # to spec.k tokens per request per step, verified in one masked forward
    # (Sq = 1 + k); step() then returns {handle: [tokens]}. Greedy only.
    obs: Observability = NULL_OBS
    # observability (repro_torch/obs): Observability() collects metrics,
    # trace spans and per-request records; NULL_OBS records nothing
    mesh: Optional[object] = None       # launch/mesh.py Mesh → TP serving:
    # prefill/decode run under a distributed/tp.py context — QKV/up
    # column-parallel, out/down row-parallel with an all-reduce, attention
    # on the rank's heads over the rank's KV pools (kv_shards())
    sharding: Optional[ShardingPolicy] = None  # axis names + rule overrides
    # for the mesh; None → ShardingPolicy() (("data", "model") axes)

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
    """Greedy/temperature sampling with page-bound continuous batching,
    the prefix cache, speculative decoding and observability."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig):
        T.check_supported(cfg)
        if cfg.n_codebooks:
            raise ValueError(
                f"{cfg.name}: n_codebooks={cfg.n_codebooks} token streams "
                f"(B, S, n_codebooks) are not served: the engine samples one "
                f"token a step, and the reference's engine serves no "
                f"multi-codebook model either; run transformer.forward over "
                f"init_caches or init_paged_caches")
        self.ssd = cfg.family in T.SSD_FAMILIES
        self.spec = sc.spec
        if self.spec is not None:
            if sc.temperature > 0:
                raise ValueError(
                    "ServeConfig.spec requires greedy sampling "
                    "(temperature == 0): acceptance compares drafts "
                    "against the target's argmax, and the rollback path "
                    "implements no distribution-preserving rejection "
                    "sampling")
            if self.ssd:
                raise ValueError(
                    "ServeConfig.spec requires position-masked multi-"
                    "token cache writes; SSD/conv recurrent state has no "
                    "positions to mask or roll back")
            if int(getattr(self.spec, "k", 0)) < 1:
                raise ValueError(
                    f"ServeConfig.spec drafter needs k >= 1 "
                    f"(got {getattr(self.spec, 'k', None)!r}); see "
                    f"serving/spec_decode.py")
        self.device = resolve_device(sc.device)
        # SSD state and the MLA latent cache cannot be paged
        pageable = not self.ssd and not cfg.is_mla
        attn = sc.attn_policy(pageable)   # validates kv_dtype
        self.gemm = sc.policy()           # validates weight_dtype
        attn = dataclasses.replace(attn, backend=attn.resolved_backend(
            self.device, pageable=pageable))
        self.paged = attn.backend == "paged"
        if attn.kv_dtype is not None and not self.paged:
            raise ValueError(
                "ServeConfig.kv_dtype requires a paged attention policy "
                "(backend 'paged'): only the page pool stores quantized K/V")
        if sc.prefix_cache and not self.paged:
            raise ValueError(
                "ServeConfig.prefix_cache requires a paged attention "
                "policy (backend 'paged'): prefix sharing aliases pool "
                "pages through block tables, which the contiguous per-slot "
                "KV caches have none of")
        self.tp = None
        if sc.mesh is not None:
            if not isinstance(sc.mesh, Mesh):
                raise NotImplementedError(
                    f"ServeConfig.mesh: a {type(sc.mesh).__name__} is not a "
                    f"mesh the port serves on; pass a "
                    f"repro_torch.launch.mesh.Mesh (make_host_mesh) over a "
                    f"torch.distributed process group")
            if sc.pack_weights or sc.weight_dtype is not None:
                raise NotImplementedError(
                    "TP serving (ServeConfig.mesh) does not cover resident "
                    "packed weights: a block-major PackedWeight has no "
                    "rank slice (pack_weights / weight_dtype), as in the "
                    "reference; drop pack_weights/weight_dtype or the mesh")
            self.tp = TP.make_context(sc.mesh, sc.sharding,
                                      overrides=cfg.overrides_dict())
            # each rank keeps its own slice of every model-sharded weight
            # (params may come whole, or as the rank's slices already)
            params = TP.shard_params(
                params, param_axes(cfg), self.tp, units=TP.head_units(cfg),
                shapes=T.init_model(cfg, device="meta"))
        params = _to_device(params, self.device)
        # Quantizing per call would redo the O(K·N) weight quantization on
        # every step; weights are static, so weight_dtype quantizes at pack.
        if sc.pack_weights or sc.weight_dtype is not None:
            params = api.pack_model_weights(params, self.gemm)
        self.cfg, self.params, self.sc, self.attn = cfg, params, sc, attn
        self._step = make_forward_step(cfg, self.gemm, attn, self.tp)
        self.scheduler = sc.scheduler if sc.scheduler is not None \
            else Scheduler()
        if self.ssd and self.scheduler.prefill_chunk:
            raise NotImplementedError(
                f"chunked prefill (prefill_chunk="
                f"{self.scheduler.prefill_chunk}) of an SSM family: a prefill "
                f"with a cache starts the SSD state from zero, so every chunk "
                f"after the first would drop the earlier chunks' state; "
                f"prefill SSM prompts whole (ROADMAP.md)")
        # Observability: instruments are registered once here and held as
        # direct references; the per-token paths only do `if obs.enabled:`
        # plus an int add. With NULL_OBS nothing is recorded.
        self.obs = sc.obs if sc.obs is not None else NULL_OBS
        obs = self.obs
        if obs.enabled:
            m = obs.metrics
            self._m_prefill_tokens = m.counter("engine_tokens_total",
                                               stage="prefill")
            self._m_decode_tokens = m.counter("engine_tokens_total",
                                              stage="decode")
            self._m_admissions = m.counter("engine_admissions_total",
                                           kind="fresh")
            self._m_resumes = m.counter("engine_admissions_total",
                                        kind="resume")
            self._m_preemptions = m.counter("engine_preemptions_total")
            self._m_retired = m.counter("engine_retired_total")
            self._m_cancelled = m.counter("engine_cancelled_total")
            self._m_live = m.gauge("engine_live_requests")
            self._m_waiting = m.gauge("engine_waiting_requests")
            self._h_prefill = m.histogram("engine_prefill_chunk_s",
                                          TIME_BUCKETS_S)
            self._h_decode = m.histogram("engine_decode_step_s",
                                         TIME_BUCKETS_S)
            self._h_ttft = m.histogram("request_ttft_s", TIME_BUCKETS_S)
            self._h_itl = m.histogram("request_itl_s", TIME_BUCKETS_S)
            if self.spec is not None:
                self._m_spec_accepted = m.counter("spec_tokens_total",
                                                  verdict="accepted")
                self._m_spec_rejected = m.counter("spec_tokens_total",
                                                  verdict="rejected")
                self._m_spec_rollback = m.counter(
                    "spec_rollback_pages_total")
                self._h_spec_accept = m.histogram(
                    "spec_acceptance_rate",
                    buckets=(0.125, 0.25, 0.375, 0.5,
                             0.625, 0.75, 0.875, 1.0))
            self.scheduler.bind_metrics(m)
        # handle → lifecycle record (RequestTrace), only when obs is
        # enabled; records persist past retirement (request_trace()).
        self.request_traces: Dict[int, RequestTrace] = {}
        B = sc.batch_slots
        self.slot_rid = np.full(B, -1, np.int64)
        self.wait: List[_Waiting] = []
        # rid → the request's output stream (paged mode); entries persist
        # past retirement so the caller can read a finished stream.
        self.request_out: Dict[int, List[int]] = {}
        self._next_rid = 0
        self.block_tables = None
        self.prefix: Optional[PrefixCache] = None
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
            if obs.enabled:
                self.pool.bind_metrics(obs.metrics)
            if sc.prefix_cache:
                self.prefix = PrefixCache(
                    self.pool, metrics=obs.metrics if obs.enabled else None)
            self.caches = T.init_paged_caches(cfg, B, n_pages, ps,
                                              sc.cache_dtype, self.device,
                                              kv_dtype=attn.kv_dtype,
                                              tpctx=self.tp)
            self.block_tables = np.zeros((B, self.n_blocks), np.int32)
            self.slot_tables: List[Optional[BlockTable]] = [None] * B
        else:
            self.caches = T.init_caches(cfg, B, sc.max_len, sc.cache_dtype,
                                        self.device, tpctx=self.tp)
        self.slot_pos = np.zeros(B, np.int32)
        self.slot_live = np.zeros(B, bool)
        self.slot_out: List[List[int]] = [[] for _ in range(B)]
        # The original prompt per slot: the prefix cache indexes it and the
        # drafter reads it as the start of the request's context.
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
        # Speculative decoding: drafted tokens the target confirmed and
        # rejected, and pool pages the rollback returned.
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_rollback_pages = 0

    # -- device calls ---------------------------------------------------------
    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.no_grad()
    def _forward(self, tokens: np.ndarray, positions: np.ndarray,
                 last_cols: Optional[np.ndarray] = None) -> torch.Tensor:
        """One masked forward over the KV caches: (B, vocab) logits of
        each row's column ``last_cols[b]`` (default: the last column)."""
        if last_cols is None:
            last_cols = np.full(tokens.shape[0], tokens.shape[1] - 1, np.int64)
        return self._run(tokens, positions, last_cols)[:, 0]

    @torch.no_grad()
    def _verify(self, tokens: np.ndarray, positions: np.ndarray
                ) -> np.ndarray:
        """The speculative verify forward: (B, Sq) tokens at (B, Sq)
        positions (−1 masked) → the greedy argmax at EVERY column, on the
        host. Column i is the target's choice after the row's tokens
        [0..i], which is what acceptance compares the drafts against."""
        return torch.argmax(self._run(tokens, positions), dim=-1).cpu().numpy()

    def _run(self, tokens: np.ndarray, positions: np.ndarray,
             last_cols: Optional[np.ndarray] = None) -> torch.Tensor:
        batch = {"tokens": self._dev(tokens), "positions": self._dev(positions)}
        if self.paged:
            batch["block_tables"] = self._dev(self.block_tables)
        return self._step(
            self.params, batch, self.caches,
            None if last_cols is None else self._dev(last_cols))[0]

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

    def _set_slot_lens(self, updates: Dict[int, int]) -> None:
        """Set several slots' valid lengths at once: one batched
        ``index_put_`` per layer's device ``len``, no host sync. Prefix
        admission preloads the reused count (the cache-length update is
        additive), and the speculative rollback shrinks each slot with
        rejected drafts back to its accepted count."""
        if not updates:
            return
        idx = self._dev(np.fromiter(updates.keys(), np.int64,
                                    count=len(updates)))
        val = self._dev(np.fromiter(updates.values(), np.int32,
                                    count=len(updates)))
        for c in self.caches:
            if "len" in c:
                c["len"].index_put_((idx,), val)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write device copy: page ``src``'s K/V rows into private
        page ``dst`` in every layer's pools, one indexed copy each; an int8
        pool's ``k_scale``/``v_scale`` rows travel with the payload they
        quantized, so the fork is bitwise equal to its donor."""
        for c in self.caches:
            for name in ("kp", "vp", "k_scale", "v_scale"):
                if name in c:
                    c[name][dst] = c[name][src]

    def _handle(self, slot: int) -> int:
        """What submit()/step() key results by: request id in paged mode
        (requests migrate across slots under preemption), slot id else."""
        return int(self.slot_rid[slot]) if self.paged else slot

    def _view(self, slot: int) -> RequestView:
        """The scheduler's view of a live slot. ``lookahead``: under
        speculative decoding a decodable request may claim pages for
        ``spec.k`` more positions next step."""
        spec_ahead = (int(self.spec.k)
                      if self.spec is not None
                      and not self.slot_prefilling[slot]
                      and not self.slot_drain[slot] else 0)
        return RequestView(
            rid=self._handle(slot), priority=int(self.slot_priority[slot]),
            deadline=self.slot_deadline[slot],
            arrival=int(self.slot_arrival[slot]),
            n_tokens=int(self.slot_pos[slot]),
            prefilling=bool(self.slot_prefilling[slot]),
            lookahead=spec_ahead)

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
        dropped, the prefix cache is cleared and every slot restarts from
        position 0; in paged mode every row gets pages for its whole
        S + n_tokens horizon up front."""
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
        """Drop every in-flight request, zero every slot's cache length,
        clear the prefix cache (its pages would pin capacity a full-batch
        generate() is entitled to) and, in paged mode, return all pages
        to the pool."""
        if self.prefix is not None:
            self.prefix.clear()
        for s in range(self.sc.batch_slots):
            if self.paged and self.slot_tables[s] is not None:
                self.slot_tables[s].free()
                self.slot_tables[s] = None
            if self.slot_live[s]:
                self.request_out.pop(int(self.slot_rid[s]), None)
        for w in self.wait:
            self.request_out.pop(w.rid, None)
        self._reset_slot_caches(slice(None))
        # in-flight lifecycle records die with their requests (their open
        # async spans are closed at export time)
        self.request_traces.clear()
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
        enough free pages (after evicting cold prefix-cache entries), or a
        preemptible victim.

        The prompt runs as a masked, bucketed prefill (whole, or its first
        chunk under ``Scheduler(prefill_chunk=N)``); with the prefix cache
        only its uncached tail runs. Its last-position logits seed the
        pending first token, which step() reports first. ``priority``
        (0 = most urgent) and ``deadline`` feed the scheduler: in paged
        mode an incoming request may preempt a strictly less urgent live
        one.
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
        obs = self.obs
        t0 = time.perf_counter() if obs.enabled else 0.0
        if not self.paged:
            free = np.where(~self.slot_live)[0]
            if free.size == 0:
                return None
            slot = int(free[0])
            self._begin_admit(slot, -1, prompt, prompt, generator=generator,
                              priority=priority, deadline=deadline,
                              arrival=arrival)
            if obs.enabled:
                obs.trace.complete("admit", f"admit {slot}", t0,
                                   args={"handle": slot,
                                         "prompt_len": len(prompt)})
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
                if obs.enabled:
                    obs.trace.complete("admit", f"admit rid={rid}", t0,
                                       args={"rid": rid,
                                             "prompt_len": len(prompt)})
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

    def _ensure_free(self, n: int) -> bool:
        """True once the pool can cover ``n`` fresh pages, evicting cold
        prefix-cache entries on demand to get there."""
        if self.pool.can_alloc(n):
            return True
        if self.prefix is not None:
            obs = self.obs
            t0 = time.perf_counter() if obs.enabled else 0.0
            short = n - self.pool.free_pages
            freed = self.prefix.evict(short)
            if obs.enabled:
                obs.trace.complete("evict", f"evict {freed}p on-demand",
                                   t0, args={"requested": short,
                                             "freed": freed})
        return self.pool.can_alloc(n)

    def _paged_admit(self, slot: int, rid: int, prompt: List[int],
                     tokens: List[int], *,
                     restore: Optional[_Waiting] = None,
                     generator: Optional[torch.Generator] = None,
                     priority: int = 0, deadline: Optional[float] = None,
                     arrival: int = 0) -> bool:
        """Admit ``tokens`` into ``slot``: prefix lookup, page budget
        (evicting cold cache entries when short), COW fork of the first
        divergent page, block-table assembly, then the masked prefill of
        the uncached tail. Returns False, with no side effects beyond the
        lookup's released holds, when pages cannot cover it."""
        hit = self.prefix.lookup(tokens) if self.prefix is not None else None
        n_covered = len(hit.pages) if hit is not None else 0
        need = self.pool.pages_needed(len(tokens)) - n_covered
        if not self._ensure_free(need):
            if hit is not None:
                hit.release(self.pool)
            return False
        assert self.slot_tables[slot] is None, \
            f"free slot {slot} still owns a block table (page leak)"
        start, pages = 0, []
        if hit is not None:
            self.prefix.record(hit, len(tokens))
            pages = hit.pages          # lookup's holds become the table's
            hit.pages = []
            start = hit.n_tokens
            if hit.cow_page is not None:
                # fork: a private copy of the partially matching page; its
                # leading cow_tokens rows are valid, the rest is overwritten
                # by the prefill (or masked by the valid length)
                dst = self.pool.fork(hit.cow_page)
                self._copy_page(hit.cow_page, dst)
                self.pool.release([hit.cow_page])   # drop lookup's hold
                hit.cow_page = None
                pages.append(dst)
                start += hit.cow_tokens
                self.prefix.note_cow_fork()
        tbl = BlockTable(self.pool, pages=pages)
        tbl.ensure(len(tokens))
        self.slot_tables[slot] = tbl
        tbl.as_row(self.n_blocks, out=self.block_tables[slot])
        self._begin_admit(slot, rid, prompt, tokens, start=start,
                          restore=restore, generator=generator,
                          priority=priority, deadline=deadline,
                          arrival=arrival)
        return True

    def _begin_admit(self, slot: int, rid: int, prompt: List[int],
                     tokens: List[int], *, start: int = 0,
                     restore: Optional[_Waiting] = None,
                     generator: Optional[torch.Generator] = None,
                     priority: int = 0, deadline: Optional[float] = None,
                     arrival: int = 0) -> None:
        """Stage ``tokens`` into ``slot`` and run the first masked prefill
        chunk; a recycled slot restarts from position 0. ``start`` > 0
        marks a prefix-cache hit: positions [0, start) are already in
        shared or forked pages, so the valid length is preloaded and the
        prefill begins mid-prompt. With ``restore`` (resume after
        preemption) the pending token and the output stream carry over."""
        self.slot_rid[slot] = rid
        self.slot_prompt[slot] = prompt
        self.slot_priority[slot] = priority
        self.slot_deadline[slot] = deadline
        self.slot_arrival[slot] = arrival
        if self.slot_pos[slot]:          # recycled slot: restart from pos 0
            self._reset_slot_caches(slot)
            self.slot_pos[slot] = 0
        if start:
            self._set_slot_lens({slot: start})
            self.slot_pos[slot] = start
        self.slot_live[slot] = True
        self.slot_drain[slot] = False
        self.slot_prefilling[slot] = True
        self.slot_pf_tokens[slot] = tokens
        self.slot_pf_restore[slot] = restore
        self.slot_pf_gen[slot] = generator
        self.slot_out[slot] = restore.out if restore is not None else []
        if restore is None and self.paged:
            self.request_out[rid] = self.slot_out[slot]
        obs = self.obs
        if obs.enabled:
            h = self._handle(slot)
            now = time.perf_counter()
            if restore is None:
                rt = RequestTrace(
                    rid=h, prompt_len=len(tokens), priority=int(priority),
                    deadline=deadline, submit_s=now, prefix_hit_tokens=start)
                self.request_traces[h] = rt
                self._m_admissions.inc()
                obs.trace.async_begin(h, {"prompt_len": len(tokens),
                                          "priority": rt.priority})
                if start:
                    obs.trace.async_instant(h, "prefix-hit",
                                            {"tokens": start})
            else:
                self._m_resumes.inc()
                obs.trace.async_instant(h, "resume",
                                        {"restart_tokens": len(tokens)})
                rt = self.request_traces.get(h)
                if rt is not None and rt.preempted_at_s is not None:
                    rt.wait_s += now - rt.preempted_at_s
                    rt.preempted_at_s = None
            self._m_live.set(int(self.slot_live.sum()))
        self._prefill_slot_chunk(slot)

    def _prefill_slot_chunk(self, slot: int) -> bool:
        """Run one masked, bucketed prefill chunk for ``slot``; True when
        the prompt is fully prefilled and the slot became decodable
        (pending token seeded, prompt pages indexed in the prefix
        cache)."""
        tokens = self.slot_pf_tokens[slot]
        L = len(tokens)
        p0 = int(self.slot_pos[slot])
        obs = self.obs
        t0 = time.perf_counter() if obs.enabled else 0.0
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
        if obs.enabled:
            # host assembly + dispatch: the device work runs on, and no
            # synchronization is added for the span
            t1 = time.perf_counter()
            h = self._handle(slot)
            self._m_prefill_tokens.inc(n)
            self._h_prefill.observe(t1 - t0)
            obs.trace.complete("prefill-chunk",
                               f"prefill rid={h} [{p0}:{p0 + n})", t0, t1,
                               args={"rid": h, "start": p0, "tokens": n})
            rt = self.request_traces.get(h)
            if rt is not None:
                rt.prefill_chunks.append(
                    {"start_pos": p0, "tokens": n,
                     "dt_s": round(t1 - t0, 6)})
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
        if self.prefix is not None:
            # index the original prompt's full pages, never the generated
            # tail: decode writes positions >= len(prompt), so these pages
            # are write-free from here on and safe to share
            prompt = self.slot_prompt[slot]
            n_full = len(prompt) // self.pool.page_size
            if n_full:
                self.prefix.insert(prompt,
                                   self.slot_tables[slot].pages[:n_full])
        self.slot_pf_tokens[slot] = None
        self.slot_pf_restore[slot] = None
        self.slot_pf_gen[slot] = None
        return True

    def _preempt(self, slot: int):
        """Spill ``slot``'s request to the wait queue: free its pages, park
        prompt/stream/pending token host-side. Resume re-prefills
        ``prompt + out``, through the prefix cache when it is on."""
        obs = self.obs
        if obs.enabled:
            t0 = time.perf_counter()
            h = self._handle(slot)   # before slot_rid resets below
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
        if obs.enabled:
            self._m_preemptions.inc()
            self._m_live.set(int(self.slot_live.sum()))
            self._m_waiting.set(len(self.wait))
            obs.trace.complete("preempt", f"preempt rid={h}", t0,
                               args={"rid": h})
            obs.trace.async_instant(h, "preempt")
            rt = self.request_traces.get(h)
            if rt is not None:
                rt.n_preemptions += 1
                rt.preempted_at_s = time.perf_counter()

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

    def _retire(self, slot: int, *, cancelled: bool = False):
        """Release ``slot`` at the end of its request. ``cancelled`` marks
        a caller's abort: the trace's async span closes with
        ``{"cancelled": true}`` and the cancelled counter moves instead of
        the retired one."""
        obs = self.obs
        if obs.enabled:
            h = self._handle(slot)   # before slot_rid resets below
            end = {"n_tokens": len(self.slot_out[slot])}
            if cancelled:
                self._m_cancelled.inc()
                end = {"cancelled": True, **end}
            else:
                self._m_retired.inc()
            obs.trace.async_end(h, end)
            rt = self.request_traces.get(h)
            if rt is not None and rt.retire_s is None:
                rt.retire_s = time.perf_counter()
        self._release_slot(slot)
        if obs.enabled:
            self._m_live.set(int(self.slot_live.sum()))

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
        obs = self.obs
        for i in self.scheduler.resume_order(views):
            free = np.where(~self.slot_live)[0]
            if free.size == 0:
                break
            w = self.wait[i]
            t0 = time.perf_counter() if obs.enabled else 0.0
            if self._paged_admit(int(free[0]), w.rid, w.prompt,
                                 w.prompt + w.out, restore=w,
                                 generator=w.generator, priority=w.priority,
                                 deadline=w.deadline, arrival=w.arrival):
                admitted.append(i)
                if obs.enabled:
                    obs.trace.complete("resume", f"resume rid={w.rid}", t0,
                                       args={"rid": w.rid})
        for i in sorted(admitted, reverse=True):
            self.wait.pop(i)
        if obs.enabled and admitted:
            self._m_waiting.set(len(self.wait))

    def _grow_pages_for_decode(self, drafts: Optional[Dict[int, List[int]]]
                               = None):
        """Back every decodable slot's next position with a page, oldest
        request first; when the pool is dry (after cold prefix entries are
        evicted), preempt the scheduler's victim (possibly the requester
        itself) until it is not.

        ``drafts`` (speculative decoding) adds each slot's drafted
        positions to its page budget, since the verify pass writes 1 + k
        tokens. Speculated growth never preempts: a slot's draft list is
        trimmed in place to the positions the pool can back."""
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
                while not self._ensure_free(1):
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
            tbl = self.slot_tables[s]
            if drafts and drafts.get(s):
                m = len(drafts[s])
                need = self.pool.pages_needed(pos + 1 + m) - tbl.n_pages
                if need > 0:
                    if not self._ensure_free(need):
                        # trim to what the pool backs now; capacity()
                        # already covers pos + 1, so fit >= 0
                        fit = (tbl.capacity() + self.pool.free_pages
                               * self.pool.page_size) - (pos + 1)
                        drafts[s] = drafts[s][:max(fit, 0)]
                        need = (self.pool.pages_needed(
                            pos + 1 + len(drafts[s])) - tbl.n_pages)
                    if need > 0:
                        tbl.ensure(pos + 1 + len(drafts[s]))
            tbl.as_row(self.n_blocks, out=self.block_tables[s])

    def cancel(self, rid: int) -> bool:
        """Abort a request by the handle submit() returned (request id in
        paged mode, slot id else), releasing its slot — and, when paged,
        its pages (or its wait-queue entry). Returns True if found."""
        if not self.paged:
            if 0 <= rid < self.sc.batch_slots and self.slot_live[rid]:
                self._retire(rid, cancelled=True)
                return True
            return False
        for s in range(self.sc.batch_slots):
            if self.slot_live[s] and self.slot_rid[s] == rid:
                self._retire(s, cancelled=True)
                self.request_out.pop(rid, None)
                return True
        for i, w in enumerate(self.wait):
            if w.rid == rid:
                self.wait.pop(i)
                self.request_out.pop(rid, None)
                if self.obs.enabled:
                    self._m_cancelled.inc()
                    self._m_waiting.set(len(self.wait))
                    self.obs.trace.async_end(rid, {"cancelled": True})
                    rt = self.request_traces.get(rid)
                    if rt is not None and rt.retire_s is None:
                        rt.retire_s = time.perf_counter()
                return True
        return False

    def step(self, generator: Optional[torch.Generator] = None) -> Dict:
        """One decode iteration across all live slots; returns
        {handle: token}, or {handle: [tokens]} under speculative decoding.

        Paged mode first evicts cold prefix-cache entries down to
        ``prefix_watermark`` free pages and resumes waiting requests; then
        at most one chunked prefill advances, each decodable slot's next
        position gets a page (preempting when the pool is dry), and the
        decode runs: each slot reports its pending token and the decode of
        the one after is pipelined — the order generate() uses, so streams
        match the batched path token for token. A slot whose cache fills
        drains: its last pending token is reported, then it retires.
        """
        self.tick += 1
        obs = self.obs
        if self.paged:
            if self.prefix is not None and self.sc.prefix_watermark > 0:
                short = self.sc.prefix_watermark - self.pool.free_pages
                if short > 0:
                    t0 = time.perf_counter() if obs.enabled else 0.0
                    freed = self.prefix.evict(short)
                    if obs.enabled:
                        obs.trace.complete(
                            "evict", f"evict {freed}p watermark", t0,
                            args={"requested": short, "freed": freed})
            self._try_resume()
        if not self.slot_live.any():
            return {}
        pf = [s for s in range(self.sc.batch_slots)
              if self.slot_prefilling[s]]
        if pf:
            s = min(pf, key=lambda t: (self.slot_priority[t],
                                       self.slot_arrival[t], t))
            self._prefill_slot_chunk(s)
        if self.spec is not None:
            return self._spec_step()
        if self.paged:
            self._grow_pages_for_decode()
        decodable = (self.slot_live & ~self.slot_drain
                     & ~self.slot_prefilling)
        nxt = None
        if decodable.any():
            t0 = time.perf_counter() if obs.enabled else 0.0
            tok = self.slot_next.astype(np.int64)[:, None]
            pos = np.where(decodable, self.slot_pos, -1).astype(np.int32)
            nxt = self._sample(self._forward(tok, pos[:, None]), generator)
            n_dec = int(decodable.sum())
            self.decode_tokens += n_dec
            if obs.enabled:
                # _sample brought the sampled ids to the host, so this
                # span is the whole batched decode's wall time
                t1 = time.perf_counter()
                self._m_decode_tokens.inc(n_dec)
                self._h_decode.observe(t1 - t0)
                obs.trace.complete("decode-step", f"decode x{n_dec}",
                                   t0, t1,
                                   args={"slots": n_dec, "tick": self.tick})
        out = {}
        for s in range(self.sc.batch_slots):
            if not self.slot_live[s] or self.slot_prefilling[s]:
                continue
            t = int(self.slot_next[s])
            self.slot_out[s].append(t)
            h = self._handle(s)
            out[h] = t
            if obs.enabled:
                self._obs_token(s, h, t)
            if self.slot_drain[s]:
                self._retire(s)
                continue
            self.slot_next[s] = int(nxt[s])
            self.slot_pos[s] += 1
            if self.slot_pos[s] >= self.sc.max_len:
                self.slot_drain[s] = True
        return out

    def _spec_step(self) -> Dict[int, List[int]]:
        """One speculative iteration: draft → verify → accept → rollback.

        Each decodable slot drafts up to ``spec.k`` tokens (capped to the
        max_len horizon, then, paged, to the pages the pool can back
        without preempting). ONE verify forward runs every slot's row
        ``[pending] + drafts`` at positions ``pos..pos+m`` (Sq = 1 + k,
        position −1 padded); column ``i`` of its argmax is the target's
        greedy choice after the row's tokens ``[0..i]``. The longest prefix
        of drafts it agrees with is kept, the column after the last
        accepted draft becomes the pending token (the bonus), and the
        rejected suffix rolls back: valid lengths reset to the accepted
        count and wholly rejected tail pages return to the pool
        (``BlockTable.truncate``). Draining slots flush their last pending
        token as a one-token burst and retire."""
        obs = self.obs
        k = int(self.spec.k)
        decodable = (self.slot_live & ~self.slot_drain
                     & ~self.slot_prefilling)
        drafts: Dict[int, List[int]] = {}
        if decodable.any():
            t0 = time.perf_counter() if obs.enabled else 0.0
            for s in np.nonzero(decodable)[0]:
                s = int(s)
                pos = int(self.slot_pos[s])
                # verify writes positions pos..pos+m; the last writable
                # cache index is max_len - 1, so m <= max_len - 1 - pos
                cap = min(k, self.sc.max_len - 1 - pos)
                d: List[int] = []
                if cap >= 1:
                    ctx = (self.slot_prompt[s] + self.slot_out[s]
                           + [int(self.slot_next[s])])
                    d = [int(t) for t in self.spec.draft(ctx, cap)][:cap]
                drafts[s] = d
            if obs.enabled:
                obs.trace.complete(
                    "draft", f"draft x{len(drafts)}", t0,
                    args={"slots": len(drafts),
                          "tokens": sum(len(d) for d in drafts.values()),
                          "tick": self.tick})
        if self.paged:
            # may preempt for the base pos+1 page, and trims drafts in
            # place when speculation alone would exhaust the pool
            self._grow_pages_for_decode(drafts)
            decodable = (self.slot_live & ~self.slot_drain
                         & ~self.slot_prefilling)
        nxt = None
        if decodable.any():
            t0 = time.perf_counter() if obs.enabled else 0.0
            B = self.sc.batch_slots
            tok = np.zeros((B, 1 + k), np.int64)
            pos2 = np.full((B, 1 + k), -1, np.int32)
            for s in np.nonzero(decodable)[0]:
                s = int(s)
                d = drafts.get(s, [])
                m = len(d)
                p = int(self.slot_pos[s])
                tok[s, 0] = int(self.slot_next[s])
                tok[s, 1:1 + m] = d
                pos2[s, :1 + m] = np.arange(p, p + 1 + m)
            nxt = self._verify(tok, pos2)
            if obs.enabled:
                t1 = time.perf_counter()
                self._h_decode.observe(t1 - t0)
                obs.trace.complete(
                    "verify", f"verify x{int(decodable.sum())}", t0, t1,
                    args={"slots": int(decodable.sum()),
                          "tick": self.tick})
        out: Dict[int, List[int]] = {}
        len_resets: Dict[int, int] = {}
        for s in range(self.sc.batch_slots):
            if not self.slot_live[s] or self.slot_prefilling[s]:
                continue
            h = self._handle(s)
            if self.slot_drain[s]:      # flush the final pending token
                t = int(self.slot_next[s])
                self.slot_out[s].append(t)
                out[h] = [t]
                if obs.enabled:
                    self._obs_token(s, h, t)
                self._retire(s)
                continue
            p = int(self.slot_pos[s])
            d = drafts.get(s, [])
            m = len(d)
            g = nxt[s]
            j = 0
            while j < m and d[j] == int(g[j]):
                j += 1
            burst = [int(self.slot_next[s])] + d[:j]
            for t in burst:
                self.slot_out[s].append(t)
                if obs.enabled:
                    self._obs_token(s, h, t)
            out[h] = burst
            self.spec_accepted += j
            self.spec_rejected += m - j
            self.decode_tokens += 1 + j
            new_pos = p + 1 + j
            if j < m:
                # rejected suffix: the verify pass wrote (and len-counted)
                # positions new_pos..p+m; shrink the valid length back and
                # return wholly rejected tail pages to the pool
                len_resets[s] = new_pos
                if self.paged:
                    dropped = self.slot_tables[s].truncate(new_pos)
                    if dropped:
                        self.spec_rollback_pages += len(dropped)
                        if obs.enabled:
                            self._m_spec_rollback.inc(len(dropped))
                        self.slot_tables[s].as_row(
                            self.n_blocks, out=self.block_tables[s])
            if obs.enabled:
                self._m_decode_tokens.inc(1 + j)
                self._m_spec_accepted.inc(j)
                self._m_spec_rejected.inc(m - j)
                if m:
                    self._h_spec_accept.observe(j / m)
            self.slot_next[s] = int(g[j])
            self.slot_pos[s] = new_pos
            if new_pos >= self.sc.max_len:
                self.slot_drain[s] = True
        self._set_slot_lens(len_resets)
        return out

    # -- observability -------------------------------------------------------
    def _obs_token(self, slot: int, h: int, tok: int):
        """Per reported token, only when observability is enabled: TTFT,
        inter-token gaps, the token itself and the pages-held timeline."""
        now = time.perf_counter()
        rt = self.request_traces.get(h)
        if rt is not None:
            if rt.first_token_s is None:
                rt.first_token_s = now
                self._h_ttft.observe(now - rt.submit_s)
                self.obs.trace.async_instant(h, "first-token")
            else:
                gap = now - rt.token_s[-1]
                rt.itl.observe(gap)
                self._h_itl.observe(gap)
            rt.tokens.append(tok)
            rt.token_s.append(now)
            if self.paged:
                tbl = self.slot_tables[slot]
                pages = len(tbl.pages) if tbl is not None else 0
                tl = rt.pages_timeline
                if not tl or tl[-1][1] != pages:
                    tl.append((self.tick, pages))

    def request_trace(self, handle: int, pop: bool = False
                      ) -> Optional[RequestTrace]:
        """The lifecycle record of ``handle`` (``repro_torch.obs
        .RequestTrace``): waits, prefill chunks, TTFT, the reported tokens
        with their timestamps, the inter-token histogram and the pages
        held over time. None when observability is off or the handle is
        unknown; ``pop=True`` removes the record after returning it."""
        if pop:
            return self.request_traces.pop(handle, None)
        return self.request_traces.get(handle)

    def kv_shards(self) -> int:
        """How many ways the KV caches split over the mesh's model axis: 1
        without a mesh, for MLA's whole latent cache and when attention
        stays replicated (``tp.head_sharding``)."""
        if self.tp is None or self.cfg.is_mla:
            return 1
        _, shard_kv = TP.head_sharding(self.tp, self.cfg.n_heads,
                                       self.cfg.n_kv_heads)
        return self.tp.model_size if shard_kv else 1

    def kv_page_bytes(self) -> int:
        """Device bytes of one pool page, summed over layers and K/V — the
        int8 pools' fp32 scale rows included; under TP, this rank's share
        (multiply by :meth:`kv_shards` for the whole page)."""
        return sum(c[name][0].numel() * c[name].element_size()
                   for c in self.caches
                   for name in ("kp", "vp", "k_scale", "v_scale")
                   if name in c)

    def stats(self) -> Dict[str, object]:
        """Scheduling churn, prefill/decode token split, the speculative
        counters and, in paged mode, pool pressure, the pool's bytes and
        the prefix cache's counters; every value a plain JSON type."""
        d = {
            "tick": self.tick,
            "live_requests": int(self.slot_live.sum()),
            "waiting_requests": len(self.wait),
            "n_preemptions": self.n_preemptions,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
        }
        if self.spec is not None:
            seen = self.spec_accepted + self.spec_rejected
            d.update(spec_accepted_tokens=self.spec_accepted,
                     spec_rejected_tokens=self.spec_rejected,
                     spec_rollback_pages=self.spec_rollback_pages,
                     spec_acceptance_rate=(self.spec_accepted / seen
                                           if seen else 0.0))
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
            if self.prefix is not None:
                d.update(self.prefix.stats())
        return json_scalars(d)


def _to_device(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return node.to(device)
