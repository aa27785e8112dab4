"""Pluggable serving schedulers: admission, resume, preemption, chunking.

A pure-Python copy of ``repro/serving/scheduler.py`` (the port imports
nothing of the JAX package); the engine consults it at the same points.

The policy lives outside ``ServingEngine``. The engine owns *mechanism* (slots,
pages, masked prefill, the wait queue); a :class:`Scheduler` owns
*policy*, consulted at four points:

==================  ====================================================
``resume_order``    which waiters to try re-admitting, in what order; the
                    engine *skips* (not bails on) entries that don't fit,
                    so a small later request no longer starves behind a
                    large earlier one
``victim``          which live request to preempt when the pool runs dry
``should_preempt``  whether an incoming request may evict a live one at
                    admission (priority ladder; default: only a strictly
                    more urgent request may)
``prefill_chunk``   tokens of prefill allowed per engine step (None →
                    whole prompt in one call); chunked
                    prefill interleaves with decode, bounding jitter
==================  ====================================================

The default :class:`Scheduler` is **FIFO within priority** (priority 0 is
most urgent; ties resolve by arrival order). With every request at the
default priority it reproduces the reference engine's choreography exactly
— oldest resumes first, youngest preempts first — which is what keeps the
stream-equivalence gates against the JAX engine green. :class:`SLOScheduler` layers deadlines on
top: earliest-deadline-first resume, farthest-deadline-first victims.

Deadlines are caller-defined floats on a clock the caller also defines
(the engine only ever *compares* them — steps, seconds, anything
monotonic works).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

__all__ = ["RequestView", "Scheduler", "SLOScheduler"]


@dataclasses.dataclass(frozen=True)
class RequestView:
    """A read-only snapshot of one request, as the engine shows it to the
    scheduler: identity, class, progress. ``prefilling`` marks a request
    whose chunked prefill hasn't finished (preempting one mid-prefill is
    legal but wasteful — default policies avoid it while any decoded
    request is available)."""

    rid: int
    priority: int = 0                 # 0 = most urgent; larger = later
    deadline: Optional[float] = None  # caller's clock; None = unconstrained
    arrival: int = 0                  # engine tick at submit
    n_tokens: int = 0                 # prompt + generated so far
    prefilling: bool = False
    # speculative decoding: tokens this request may *additionally* write
    # next step (the drafter's budget). Policies costing page pressure
    # should treat the request as n_tokens + lookahead deep — speculated
    # positions need page backing before the verify pass runs.
    lookahead: int = 0


class Scheduler:
    """FIFO-within-priority default policy (see module docstring)."""

    def __init__(self, prefill_chunk: Optional[int] = None):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # observability (bind_metrics): decision counters, None → unbound
        self._m_victims = None
        self._m_preempt_granted = None
        self._m_preempt_denied = None

    def bind_metrics(self, metrics) -> None:
        """Count this policy's decisions on ``metrics`` (a repro_torch.obs
        Metrics registry, duck-typed): victim picks when the pool runs
        dry, and admission-preemption verdicts either way. The engine
        binds this automatically when built with observability enabled."""
        self._m_victims = metrics.counter("scheduler_victim_picks_total")
        self._m_preempt_granted = metrics.counter(
            "scheduler_admission_preempts_total", verdict="granted")
        self._m_preempt_denied = metrics.counter(
            "scheduler_admission_preempts_total", verdict="denied")

    # -- resume / admission --------------------------------------------------
    def resume_order(self, waiting: Sequence[RequestView]) -> List[int]:
        """Indices into ``waiting`` in re-admission order. The engine
        tries each and *skips* those that don't fit, so order here is
        preference, not a barrier."""
        return sorted(range(len(waiting)),
                      key=lambda i: self._urgency(waiting[i]))

    def should_preempt(self, incoming: RequestView,
                       victim: RequestView) -> bool:
        """May ``incoming`` evict ``victim`` at admission time? Default:
        only strictly more urgent classes jump the pool — equal-priority
        traffic never churns pages preempting itself."""
        verdict = incoming.priority < victim.priority
        if self._m_victims is not None:
            (self._m_preempt_granted if verdict
             else self._m_preempt_denied).inc()
        return verdict

    # -- preemption ----------------------------------------------------------
    def victim(self, live: Sequence[RequestView]) -> int:
        """rid of the request to spill when the pool runs dry. Default:
        among the least-urgent priority class, the youngest (max rid) —
        arrival order is seniority; within a class, requests
        mid-chunked-prefill are spared while a decoded candidate exists
        (their prefill work would be pure loss)."""
        if self._m_victims is not None:
            self._m_victims.inc()
        return max(live, key=lambda r: (r.priority, not r.prefilling,
                                        self._victim_tiebreak(r), r.rid)).rid

    # -- knobs subclasses override -------------------------------------------
    def _urgency(self, r: RequestView):
        """Sort key for resume order: smaller = sooner."""
        return (r.priority, r.arrival, r.rid)

    def _victim_tiebreak(self, r: RequestView):
        """Secondary victim key within a priority class: larger = spilled
        first. The base policy defers entirely to youth (rid)."""
        return 0


class SLOScheduler(Scheduler):
    """Deadline-aware variant: within a priority class, resume runs
    earliest-deadline-first and preemption spills the request with the
    most slack (farthest deadline; no deadline = infinite slack). A
    request that would clearly miss anyway still follows the same order —
    the engine has no cost model to know, and determinism beats cleverness
    for stream-equivalence testing."""

    def _urgency(self, r: RequestView):
        d = math.inf if r.deadline is None else r.deadline
        return (r.priority, d, r.arrival, r.rid)

    def _victim_tiebreak(self, r: RequestView):
        return math.inf if r.deadline is None else r.deadline
