"""Async streaming frontend over the serving engine's submit/step loop
(``repro/serving/frontend.py``, ported).

``ServingEngine`` exposes a *pull* interface: ``submit()`` returns a
handle, ``step()`` returns ``{handle: token}`` for whoever advanced this
iteration. A server wants the transpose — per-request *push* streams
("give me request X's tokens as they arrive"). :class:`AsyncServingEngine`
is that transpose, built on stdlib asyncio (no server framework):

* :meth:`stream` is an async generator yielding one request's tokens as
  the engine produces them;
* :meth:`complete` awaits a whole stream and returns it as a list;
* one shared **pump** coroutine drives admission + ``step()`` while any
  request is in flight, fanning each step's tokens out to per-request
  queues. It starts lazily with the first request and exits when the
  last one finishes.

Admission order is (priority, submission order); a request the engine
refuses (no slot/pages yet) stays queued and is retried every pump
iteration *without blocking later submissions* — the same skip-not-bail
rule the engine's own resume path uses, so a small request is never
head-of-line blocked behind a large one. Priorities/deadlines pass
through to the engine's scheduler (serving/scheduler.py); preemption and
resume stay invisible here — a preempted request's stream simply pauses
until the engine resumes it.

The pump calls the engine synchronously (a step blocks the event loop
until its sampled tokens reach the host). That is the intended single-host shape:
the event loop interleaves *waiting* (network handlers, many concurrent
``stream`` consumers), while the device does one batched step at a time
— exactly the continuous-batching contract. docs/serving.md#streaming
has a worked example.
"""
from __future__ import annotations

import asyncio
import itertools
import time
from typing import AsyncIterator, Dict, List, Optional

from repro_torch.obs.metrics import quantile
from repro_torch.serving.engine import ServingEngine

__all__ = ["AsyncServingEngine"]


class _Flight:
    """One in-flight request: its submission parameters until admitted,
    its token queue and progress after. ``t_submit``/``t_admit``/``t_last``
    are ``time.perf_counter`` marks feeding the SLO accounting
    (:meth:`AsyncServingEngine.slo_report`)."""

    __slots__ = ("prompt", "n_tokens", "generator", "priority", "deadline",
                 "seq", "queue", "handle", "got", "t_submit", "t_admit",
                 "t_last")

    def __init__(self, prompt, n_tokens, generator, priority, deadline, seq):
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.generator = generator
        self.priority = priority
        self.deadline = deadline
        self.seq = seq
        self.queue: asyncio.Queue = asyncio.Queue()
        self.handle: Optional[int] = None
        self.got = 0
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_last: Optional[float] = None


class AsyncServingEngine:
    """Per-request async token streams over one :class:`ServingEngine`.

    ::

        aeng = AsyncServingEngine(engine)

        async def handler(prompt):
            async for tok in aeng.stream(prompt, n_tokens=64):
                ...  # forward to the client as it arrives

    Any number of ``stream``/``complete`` consumers may run concurrently;
    the single pump batches them through the engine. The wrapped engine
    must not be driven manually (generate()/submit()/step()) while any
    stream is active — the pump owns it.
    """

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._waiting: List[_Flight] = []     # submitted here, not admitted
        self._active: Dict[int, _Flight] = {}  # engine handle → flight
        self._pump_task: Optional[asyncio.Task] = None
        self._seq = itertools.count()
        # SLO accounting (slo_report): raw samples on the perf_counter
        # clock — stream()-call → admission, → first token, and
        # token-to-token gaps. Deadlines are interpreted on the same
        # clock: an absolute perf_counter time the first token must beat
        # (the engine itself only ever *compares* deadlines; the meaning
        # lives here, docs/observability.md#slo-definitions).
        self._queue_waits: List[float] = []
        self._ttfts: List[float] = []
        self._itls: List[float] = []
        self._deadline_misses = 0
        self._completed = 0
        obs = engine.obs
        self._m_misses = (obs.metrics.counter("frontend_deadline_misses_total")
                          if obs.enabled else None)

    # -- public API ---------------------------------------------------------
    async def stream(self, prompt: List[int], n_tokens: int,
                     generator=None, *, priority: int = 0,
                     deadline: Optional[float] = None
                     ) -> AsyncIterator[int]:
        """Yield up to ``n_tokens`` generated tokens for ``prompt`` as the
        engine produces them. ``priority``/``deadline`` feed the engine's
        scheduler; ``generator`` (a ``torch.Generator``) enables temperature
        sampling (engine._sample).

        The stream ends early if the request retires at the engine's
        ``max_len`` horizon. Breaking out of the iteration cancels the
        request (its slot and pages are released)."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        flight = _Flight(list(prompt), n_tokens, generator, priority, deadline,
                         next(self._seq))
        self._waiting.append(flight)
        self._ensure_pump()
        try:
            while flight.got < n_tokens:
                tok = await flight.queue.get()
                if tok is None:        # retired at the engine's horizon
                    return
                yield tok
        finally:
            self._abort(flight)

    async def complete(self, prompt: List[int], n_tokens: int,
                       generator=None, *, priority: int = 0,
                       deadline: Optional[float] = None) -> List[int]:
        """Await the whole stream; returns the generated tokens."""
        return [t async for t in self.stream(prompt, n_tokens, generator,
                                             priority=priority,
                                             deadline=deadline)]

    @property
    def in_flight(self) -> int:
        return len(self._waiting) + len(self._active)

    def slo_report(self) -> Dict[str, object]:
        """Aggregated SLO accounting over everything this frontend has
        streamed: exact p50/p95/p99 of queue wait, TTFT (stream() call →
        first token, engine queue wait included) and ITL, plus the
        deadline-miss count (first token after the request's absolute
        ``deadline`` on the perf_counter clock). Plain-JSON dict; all
        times in seconds. Cumulative — a long-running server may snapshot
        it repeatedly."""
        def pcts(xs: List[float]) -> Dict[str, Optional[float]]:
            if not xs:
                return {"p50": None, "p95": None, "p99": None}
            return {"p50": round(quantile(xs, 0.50), 6),
                    "p95": round(quantile(xs, 0.95), 6),
                    "p99": round(quantile(xs, 0.99), 6)}
        return {
            "n_completed": self._completed,
            "n_first_tokens": len(self._ttfts),
            "queue_wait_s": pcts(self._queue_waits),
            "ttft_s": pcts(self._ttfts),
            "itl_s": pcts(self._itls),
            "deadline_misses": self._deadline_misses,
        }

    # -- pump ---------------------------------------------------------------
    def _ensure_pump(self):
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())

    def _admit(self):
        """Try to admit queued flights, most urgent first; refusals are
        skipped, not barriers (see module docstring)."""
        for flight in sorted(self._waiting,
                             key=lambda f: (f.priority, f.seq)):
            handle = self.engine.submit(flight.prompt, flight.generator,
                                        priority=flight.priority,
                                        deadline=flight.deadline)
            if handle is None:
                continue
            flight.handle = handle
            self._waiting.remove(flight)
            self._active[handle] = flight
            flight.t_admit = time.perf_counter()
            wait = flight.t_admit - flight.t_submit
            self._queue_waits.append(wait)
            rt = self.engine.request_traces.get(handle)
            if rt is not None:
                rt.queue_wait_s = wait

    async def _pump(self):
        eng = self.engine
        while self._waiting or self._active:
            self._admit()
            if not self._active:
                if not self._waiting:
                    break
                # queued work that cannot admit while nothing is live:
                # stepping would never free capacity — the prompts simply
                # exceed the pool/slots. Fail them rather than spin.
                for flight in list(self._waiting):
                    self._waiting.remove(flight)
                    flight.queue.put_nowait(None)
                break
            produced = eng.step()
            now = time.perf_counter()
            for handle, tok in produced.items():
                flight = self._active.get(handle)
                if flight is None:
                    continue           # cancelled while its step ran
                # speculative engines (ServeConfig.spec) emit a *burst* of
                # accepted tokens per request per step; plain engines one
                burst = tok if isinstance(tok, list) else (tok,)
                for t in burst:
                    if flight.got >= flight.n_tokens:
                        break          # burst overshot the request: drop
                    flight.got += 1
                    flight.queue.put_nowait(t)
                    if flight.got == 1:
                        self._ttfts.append(now - flight.t_submit)
                        if (flight.deadline is not None
                                and now > flight.deadline):
                            self._deadline_misses += 1
                            if self._m_misses is not None:
                                self._m_misses.inc()
                            rt = eng.request_traces.get(handle)
                            if rt is not None:
                                rt.deadline_missed = True
                        elif flight.deadline is not None:
                            rt = eng.request_traces.get(handle)
                            if rt is not None:
                                rt.deadline_missed = False
                    else:
                        self._itls.append(now - flight.t_last)
                    flight.t_last = now
                if flight.got >= flight.n_tokens:
                    self._completed += 1
                    self._finish(flight)
            # a request that retired at max_len stops producing: close its
            # stream so consumers don't wait forever. Live means: in a slot,
            # or (paged) parked in the wait queue between preempt and resume.
            for handle, flight in list(self._active.items()):
                if handle in produced:
                    continue
                if eng.paged:
                    live = any(eng.slot_live[s]
                               and int(eng.slot_rid[s]) == handle
                               for s in range(eng.sc.batch_slots)) \
                        or any(w.rid == handle for w in eng.wait)
                else:
                    live = bool(eng.slot_live[handle])
                if not live:
                    self._finish(flight, close=True)
            await asyncio.sleep(0)     # let consumers drain their queues
        self._pump_task = None

    def _finish(self, flight: _Flight, close: bool = False):
        """Release a completed flight's engine-side resources."""
        self._active.pop(flight.handle, None)
        self.engine.cancel(flight.handle)
        if close:
            flight.queue.put_nowait(None)

    def _abort(self, flight: _Flight):
        """Consumer stopped iterating (done, or broke out early)."""
        if flight in self._waiting:
            self._waiting.remove(flight)
        elif flight.handle in self._active:
            self._finish(flight)
