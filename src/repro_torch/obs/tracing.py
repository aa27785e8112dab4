"""Span/event recorder with a ring buffer and a Perfetto trace exporter.

A copy of ``repro/obs/tracing.py`` (the port imports nothing of the JAX
package).

The recorder collects host-side timing events from the serving engine —
**never** from device work, and without a device synchronization of its
own — into a bounded
ring buffer (``collections.deque(maxlen=...)``: a long-running server
keeps the most recent window, oldest events drop first, ``dropped``
counts them).

Two families of events (docs/observability.md#span-taxonomy):

* **Phase tracks** — one named track per engine phase (``admit``,
  ``prefill-chunk``, ``decode-step``, ``preempt``, ``resume``,
  ``evict``): complete spans (Chrome ``ph: "X"``) recorded by the engine
  around each phase's host+device work.
* **Request tracks** — one async track per request id (Chrome
  ``ph: "b"/"n"/"e"`` with ``cat: "request"``), spanning submit →
  first-token → retire with instants for prefix hits, preemptions and
  resumes. Perfetto groups them by id under the engine process.

:meth:`TraceRecorder.export` renders the ring into the Chrome trace
JSON object format (``{"traceEvents": [...]}``) that Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` load directly.
Timestamps are microseconds from the recorder's construction. Async
spans still open at export time are closed with a synthetic ``"e"``
carrying ``args.truncated: true`` — the exported file is always
balanced (``validate_trace`` checks it, along with X-span nesting).

:class:`RequestTrace` is the per-request lifecycle record the engine
builds alongside the trace events and serves via
``ServingEngine.request_trace(handle)``: queue wait, prefill chunks,
TTFT, per-token inter-arrival histogram + raw timestamps, preemption
count, prefix-cache hit span, and pages held over time.
:func:`aggregate_request_traces` folds many of them into the SLO
percentile summary (p50/p95/p99 TTFT and ITL).

Everything is stdlib-only; the disabled path is :data:`NULL_RECORDER`,
whose methods are no-ops and which never allocates per call.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Histogram, TIME_BUCKETS_S, quantile

__all__ = [
    "TraceRecorder", "NullRecorder", "NULL_RECORDER", "PHASE_TRACKS",
    "RequestTrace", "aggregate_request_traces", "validate_trace",
]

# The engine's phase tracks, in display order (exporter assigns tids and
# thread_sort_index in this order; unknown tracks append after).
PHASE_TRACKS: Tuple[str, ...] = (
    "admit", "prefill-chunk", "decode-step", "preempt", "resume", "evict",
    "draft", "verify",   # speculative decoding (serving/spec_decode.py)
)

_ENGINE_PID = 1


class TraceRecorder:
    """Bounded host-side event recorder (see module docstring).

    Events live as tuples ``(ph, track, name, ts_us, dur_us, rid, args)``
    in a deque ring — appending is O(1) and allocation-light; rendering
    to Chrome JSON happens only at :meth:`export`.
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.epoch = time.perf_counter()
        self._events: Deque[Tuple] = collections.deque(maxlen=self.capacity)
        self.dropped = 0

    # -- recording ----------------------------------------------------------
    def _push(self, ev: Tuple) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def complete(self, track: str, name: str, t0: float,
                 t1: Optional[float] = None,
                 args: Optional[Dict] = None) -> None:
        """One complete span on a phase track: began at perf_counter time
        ``t0``, ended at ``t1`` (now when omitted)."""
        if t1 is None:
            t1 = time.perf_counter()
        self._push(("X", track, name, self._us(t0),
                    max(self._us(t1) - self._us(t0), 0.0), None, args))

    def instant(self, track: str, name: str,
                args: Optional[Dict] = None) -> None:
        self._push(("i", track, name, self._us(time.perf_counter()),
                    0.0, None, args))

    def async_begin(self, rid: int, args: Optional[Dict] = None) -> None:
        """Open request ``rid``'s async span (at submit/admission)."""
        self._push(("b", None, f"req {rid}",
                    self._us(time.perf_counter()), 0.0, rid, args))

    def async_instant(self, rid: int, name: str,
                      args: Optional[Dict] = None) -> None:
        """A point event on request ``rid``'s async track (first-token,
        preempt, resume, prefix-hit)."""
        self._push(("n", None, name, self._us(time.perf_counter()),
                    0.0, rid, args))

    def async_end(self, rid: int, args: Optional[Dict] = None) -> None:
        """Close request ``rid``'s async span (retire/cancel)."""
        self._push(("e", None, f"req {rid}",
                    self._us(time.perf_counter()), 0.0, rid, args))

    # -- introspection / export --------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def export(self) -> Dict[str, object]:
        """Render the ring into a Perfetto-loadable Chrome trace dict."""
        tids: Dict[str, int] = {t: i + 1 for i, t in enumerate(PHASE_TRACKS)}
        events: List[Dict[str, object]] = [{
            "ph": "M", "pid": _ENGINE_PID, "tid": 0, "ts": 0,
            "name": "process_name",
            "args": {"name": "serving-engine"},
        }]
        body: List[Dict[str, object]] = []
        open_async: Dict[Tuple[str, str], List[float]] = {}
        last_ts = 0.0
        for ph, track, name, ts, dur, rid, args in self._events:
            last_ts = max(last_ts, ts + dur)
            ev: Dict[str, object] = {
                "ph": ph, "pid": _ENGINE_PID, "name": name, "ts": ts,
            }
            if args:
                ev["args"] = args
            if ph in ("X", "i"):
                tid = tids.setdefault(track, len(tids) + 1)
                ev["tid"] = tid
                ev["cat"] = "engine"
                if ph == "X":
                    ev["dur"] = dur
                else:
                    ev["s"] = "t"          # instant scope: thread
            else:                          # async b/n/e
                ev["tid"] = 0
                ev["cat"] = "request"
                ev["id"] = str(rid)
                key = (str(rid), f"req {rid}")
                if ph == "b":
                    open_async.setdefault(key, []).append(ts)
                elif ph == "e":
                    stack = open_async.get(key)
                    if stack:
                        stack.pop()
            body.append(ev)
        # synthesize ends for spans still open (engine stopped mid-flight
        # or the caller exported a live trace): the file stays balanced
        for (rid, name), stack in sorted(open_async.items()):
            for _ in stack:
                body.append({
                    "ph": "e", "pid": _ENGINE_PID, "tid": 0, "name": name,
                    "cat": "request", "id": rid, "ts": last_ts,
                    "args": {"truncated": True},
                })
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({
                "ph": "M", "pid": _ENGINE_PID, "tid": tid, "ts": 0,
                "name": "thread_name", "args": {"name": track},
            })
            events.append({
                "ph": "M", "pid": _ENGINE_PID, "tid": tid, "ts": 0,
                "name": "thread_sort_index", "args": {"sort_index": tid},
            })
        events.extend(body)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "repro_torch.obs.tracing",
                "dropped_events": self.dropped,
            },
        }

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns the number of
        trace events written."""
        trace = self.export()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


class NullRecorder:
    """The disabled recorder: every method is a no-op, nothing is ever
    stored, nothing per call is allocated. Shared as NULL_RECORDER."""

    enabled = False
    dropped = 0
    capacity = 0

    def complete(self, track, name, t0, t1=None, args=None) -> None:
        pass

    def instant(self, track, name, args=None) -> None:
        pass

    def async_begin(self, rid, args=None) -> None:
        pass

    def async_instant(self, rid, name, args=None) -> None:
        pass

    def async_end(self, rid, args=None) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        pass

    def export(self) -> Dict[str, object]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_RECORDER = NullRecorder()


@dataclasses.dataclass
class RequestTrace:
    """Per-request lifecycle record (engine-side wall clock, seconds on
    ``time.perf_counter``). Built only when observability is enabled;
    ``ServingEngine.request_trace(handle)`` serves it, persisting past
    retirement so a finished stream's record stays readable.

    Token-exactness contract (tests/test_obs.py): ``tokens`` is exactly
    the stream the engine reported for this request — a preempted/resumed
    request's trace differs from an uninterrupted run's only in
    ``n_preemptions``/``wait_s``/``prefill_chunks`` (the preemption
    span), never in the tokens themselves.
    """

    rid: int
    prompt_len: int
    priority: int = 0
    deadline: Optional[float] = None
    submit_s: float = 0.0                # perf_counter at submit
    first_token_s: Optional[float] = None
    retire_s: Optional[float] = None
    queue_wait_s: float = 0.0            # pre-admission (frontend) wait
    wait_s: float = 0.0                  # parked preempted, total
    n_preemptions: int = 0
    prefix_hit_tokens: int = 0           # tokens served from the prefix
    #                                      cache at first admission
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_s: List[float] = dataclasses.field(default_factory=list)
    prefill_chunks: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)            # {start_pos, tokens, dt_s}
    pages_timeline: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)            # (engine tick, pages held)
    itl: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("request_itl_s", TIME_BUCKETS_S))
    deadline_missed: Optional[bool] = None
    # transient: set while parked in the wait queue (preempt → resume)
    preempted_at_s: Optional[float] = None

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def ttft_s(self) -> Optional[float]:
        """Submit → first token, queue wait included (None pre-token)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    def itl_list(self) -> List[float]:
        """Raw inter-token gaps (exact; ``itl`` holds the same data
        bucketed for cheap merging)."""
        return [b - a for a, b in zip(self.token_s, self.token_s[1:])]

    def to_json(self) -> Dict[str, object]:
        """Plain-JSON rendering (json.dumps-safe)."""
        ttft = self.ttft_s()
        return {
            "rid": self.rid,
            "prompt_len": self.prompt_len,
            "priority": self.priority,
            "deadline": self.deadline,
            "submit_s": self.submit_s,
            "first_token_s": self.first_token_s,
            "retire_s": self.retire_s,
            "ttft_s": ttft,
            "queue_wait_s": self.queue_wait_s,
            "wait_s": self.wait_s,
            "n_preemptions": self.n_preemptions,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "n_tokens": self.n_tokens,
            "tokens": list(self.tokens),
            "prefill_chunks": list(self.prefill_chunks),
            "pages_timeline": [[int(t), int(p)]
                               for t, p in self.pages_timeline],
            "itl": self.itl.snapshot(),
            "deadline_missed": self.deadline_missed,
        }


def aggregate_request_traces(traces: Sequence[RequestTrace]
                             ) -> Dict[str, object]:
    """SLO summary over finished (or at least first-tokened) traces:
    exact p50/p95/p99 TTFT and ITL from the raw per-trace samples, plus
    preemption/deadline accounting. All values plain JSON."""
    ttfts = [t.ttft_s() for t in traces if t.first_token_s is not None]
    itls = [g for t in traces for g in t.itl_list()]

    def pcts(xs: List[float]) -> Dict[str, Optional[float]]:
        if not xs:
            return {"p50": None, "p95": None, "p99": None}
        return {"p50": round(quantile(xs, 0.50), 6),
                "p95": round(quantile(xs, 0.95), 6),
                "p99": round(quantile(xs, 0.99), 6)}

    return {
        "n_requests": len(traces),
        "n_first_tokens": len(ttfts),
        "total_tokens": sum(t.n_tokens for t in traces),
        "ttft_s": pcts(ttfts),
        "itl_s": pcts(itls),
        "preemptions": sum(t.n_preemptions for t in traces),
        "deadline_misses": sum(1 for t in traces if t.deadline_missed),
    }


def validate_trace(trace: object) -> List[str]:
    """Schema + structure check for an exported Chrome trace dict:
    required keys per phase type, b/e balance per async (cat, id), and
    proper nesting of X spans within each (pid, tid). Returns a list of
    problems; empty means Perfetto-loadable (tests/test_obs.py and the
    CI observability job both gate on it)."""
    problems: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["trace must be a dict with a 'traceEvents' list"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    async_depth: Dict[Tuple[str, str], int] = {}
    by_thread: Dict[Tuple[object, object], List[Tuple[float, float]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not a dict")
            continue
        ph = ev.get("ph")
        name = ev.get("name")
        ts = ev.get("ts")
        if ph is None or name is None:
            problems.append(f"event {i} missing ph/name: {ev}")
            continue
        if ph != "M" and not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({name!r}) has non-numeric ts")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({name!r}) X needs dur >= 0")
                continue
            by_thread.setdefault((ev.get("pid"), ev.get("tid")),
                                 []).append((float(ts), float(dur)))
        elif ph in ("b", "n", "e"):
            if "id" not in ev or "cat" not in ev:
                problems.append(f"event {i} ({name!r}) async needs id+cat")
                continue
            key = (str(ev["cat"]), str(ev["id"]))
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
            elif ph == "e":
                depth = async_depth.get(key, 0)
                if depth <= 0:
                    problems.append(
                        f"event {i}: async end for {key} without a begin")
                else:
                    async_depth[key] = depth - 1
    for key, depth in sorted(async_depth.items()):
        if depth != 0:
            problems.append(f"async span {key} left open ({depth} begins "
                            f"unmatched)")
    # X spans on one thread must nest: sorted by start (ties: longer
    # first), each span lies fully inside or fully outside the previous
    for tkey, spans in sorted(by_thread.items(), key=lambda kv: str(kv[0])):
        spans.sort(key=lambda sd: (sd[0], -sd[1]))
        stack: List[float] = []
        for ts, dur in spans:
            while stack and ts >= stack[-1]:
                stack.pop()
            if stack and ts + dur > stack[-1]:
                problems.append(
                    f"thread {tkey}: span [{ts}, {ts + dur}] partially "
                    f"overlaps its enclosing span (ends {stack[-1]})")
            stack.append(ts + dur)
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"trace does not json-serialize: {e}")
    return problems
