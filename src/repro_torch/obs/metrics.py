"""Metrics registry: counters, gauges, fixed-bucket histograms, timers.

A copy of ``repro/obs/metrics.py`` (the port imports nothing of the JAX
package).

The serving hot loop (one ``ServingEngine.step()`` per generated token
per live batch) cannot afford a metrics layer that hashes label dicts or
allocates per observation. The design here is the classic two-phase
split: **registration** (``Metrics.counter(...)``) happens once, at
engine construction, and may be as slow as it likes; the returned
*instrument* is then a tiny ``__slots__`` object whose hot method is one
attribute add (``Counter.inc``), one store (``Gauge.set``), or one bisect
plus two adds (``Histogram.observe``). Call sites hold direct instrument
references — the registry is never consulted per token.

Everything is host-side and stdlib-only: instrumentation lives strictly
outside the device work of prefill/decode (docs/observability.md) and
never synchronizes the card — there is nothing here a kernel could see.

``Histogram`` uses *fixed* buckets so that histograms from different
sources (per-request inter-token latencies, per-engine step times,
shards of a sweep) **merge associatively**: ``merge`` adds counts
bucket-by-bucket, so ``(a ⊕ b) ⊕ c == a ⊕ (b ⊕ c)`` exactly — the
property tests/test_obs.py pins. Quantiles from a histogram are
estimates (linear interpolation inside the winning bucket); exact
percentiles over raw samples use :func:`quantile`.

``Timer`` replaces the hand-rolled ``t0 = time.perf_counter() … dt``
pairs in launch/serve.py, launch/train.py and train/loop.py::

    with Timer() as tm:
        out = engine.generate(prompts, n)
    print(f"done in {tm.dt:.2f}s")

Optionally it feeds a histogram on exit (``timed(hist)``).
"""
from __future__ import annotations

import bisect
import json
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "NULL_METRICS", "Timer",
    "timed", "quantile", "TIME_BUCKETS_S", "json_scalars",
    "validate_metrics_snapshot", "merge_histograms",
]

# Default latency buckets (seconds): 100 µs … 10 s, roughly 1-2.5-5 per
# decade — wide enough for plain-version CPU runs and the card's steps
# to land in informative buckets of the SAME edges (merge-compatible).
TIME_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. Hot method: :meth:`inc` (one int add)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({_render(self.name, self.labels)}={self.value})"


class Gauge:
    """Last-value gauge with a max-tracking helper for high-water marks."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = v

    def __repr__(self) -> str:
        return f"Gauge({_render(self.name, self.labels)}={self.value})"


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper bounds, an
    implicit +inf bucket catches the overflow. ``counts`` has
    ``len(buckets) + 1`` cells. Merging is element-wise addition —
    associative and commutative by construction (same bucket edges
    required; anything else raises)."""

    __slots__ = ("name", "labels", "buckets", "counts", "total", "count")

    def __init__(self, name: str,
                 buckets: Sequence[float] = TIME_BUCKETS_S,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(
                f"histogram buckets must be non-empty strictly ascending "
                f"upper bounds, got {b}")
        self.name = name
        self.labels = labels
        self.buckets = b
        self.counts: List[int] = [0] * (len(b) + 1)
        self.total = 0.0          # sum of observations
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.total += v
        self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Return a NEW histogram holding ``self ⊕ other``; operands are
        untouched, so merging is safe mid-collection."""
        if self.buckets != other.buckets:
            raise ValueError(
                f"cannot merge histograms with different buckets: "
                f"{self.buckets} vs {other.buckets}")
        out = Histogram(self.name, self.buckets, self.labels)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.total = self.total + other.total
        out.count = self.count + other.count
        return out

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1): linear interpolation inside the
        winning bucket; the overflow bucket reports its lower edge."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if i >= len(self.buckets):
                    return lo              # overflow bucket: unbounded above
                hi = self.buckets[i]
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.buckets[-1]

    def snapshot(self) -> Dict[str, object]:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.total, "count": self.count}

    def __repr__(self) -> str:
        return (f"Histogram({_render(self.name, self.labels)} "
                f"count={self.count} mean={self.mean():.6g})")


class Metrics:
    """Instrument registry. ``counter``/``gauge``/``histogram`` memoize by
    (kind, name, labels): asking twice returns the same instrument, so
    components can bind by name without coordinating instances. A name
    registered as one kind cannot be re-registered as another."""

    def __init__(self) -> None:
        self._instruments: Dict[Tuple[str, str, Tuple], object] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object],
             factory):
        prior = self._kinds.setdefault(name, kind)
        if prior != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {prior}, "
                f"cannot re-register as a {kind}")
        key = (kind, name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = factory(name, key[2])
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = TIME_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda n, ls: Histogram(n, buckets, ls))

    def snapshot(self) -> Dict[str, object]:
        """One plain-JSON dict of every instrument's current state:
        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``.
        Keys are ``name`` or ``name{k=v,...}`` when labeled."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, labels), inst in sorted(
                self._instruments.items(), key=lambda kv: kv[0][:2]):
            key = _render(name, labels)
            if kind == "counter":
                out["counters"][key] = inst.value
            elif kind == "gauge":
                out["gauges"][key] = json_scalars({"v": inst.value})["v"]
            else:
                out["histograms"][key] = inst.snapshot()
        return out


class _NullInstrument:
    """Shared no-op instrument: the disabled path's counter, gauge AND
    histogram. Every method is a no-op; ``value`` stays 0."""

    __slots__ = ()
    value = 0
    count = 0
    total = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def set_max(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class _NullMetrics:
    """Registry stand-in for disabled observability: every registration
    returns the one shared no-op instrument — nothing is ever recorded
    and nothing per-call is allocated."""

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=TIME_BUCKETS_S,
                  **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> Dict[str, object]:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = _NullMetrics()


class Timer:
    """Context-manager stopwatch over ``time.perf_counter``.

    ``tm.dt`` is the elapsed seconds — final once the block exits, running
    while still inside it (so progress prints mid-block work too).
    ``tm.ms`` is the same in milliseconds. With ``histogram`` the duration
    is observed on exit (the ``timed(hist)`` spelling)."""

    __slots__ = ("_t0", "_dt", "_hist")

    def __init__(self, histogram: Optional[Histogram] = None):
        self._t0 = 0.0
        self._dt: Optional[float] = None
        self._hist = histogram

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._dt = time.perf_counter() - self._t0
        if self._hist is not None:
            self._hist.observe(self._dt)

    @property
    def dt(self) -> float:
        return (time.perf_counter() - self._t0 if self._dt is None
                else self._dt)

    @property
    def ms(self) -> float:
        return self.dt * 1e3


def timed(histogram: Optional[Histogram]) -> Timer:
    """``with timed(hist): ...`` — a Timer that records into ``hist``."""
    return Timer(histogram)


def quantile(values: Sequence[float], q: float) -> float:
    """Exact q-quantile (0..1) of raw samples, linear interpolation
    between order statistics (numpy's default method, stdlib-only so the
    frontend needs no numpy). Empty input returns 0.0."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] + frac * (xs[hi] - xs[lo]))


def json_scalars(d: Dict[str, object]) -> Dict[str, object]:
    """Coerce a flat dict's values to plain JSON types: numpy scalars
    (``np.int64`` from ``.sum()``, ``np.float32`` means, ``np.bool_``)
    become native int/float/bool via their ``item()``. Used by
    ``ServingEngine.stats()`` so the dict the benchmarks JSONL-serialize
    round-trips through ``json.dumps`` unchanged (tests/test_obs.py)."""
    out: Dict[str, object] = {}
    for k, v in d.items():
        item = getattr(v, "item", None)
        if item is not None and not isinstance(v, (int, float, bool, str)):
            v = item()
        out[k] = v
    return out


def validate_metrics_snapshot(snap: object) -> List[str]:
    """Schema check for :meth:`Metrics.snapshot` output (the CI
    observability job runs this over the file launch/serve.py writes).
    Returns a list of problems — empty means valid."""
    problems: List[str] = []
    if not isinstance(snap, dict):
        return [f"snapshot is {type(snap).__name__}, expected dict"]
    for section in ("counters", "gauges", "histograms"):
        if section not in snap:
            problems.append(f"missing section {section!r}")
    for key, v in snap.get("counters", {}).items():
        if not isinstance(v, int) or isinstance(v, bool):
            problems.append(f"counter {key!r} value {v!r} is not an int")
    for key, v in snap.get("gauges", {}).items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            problems.append(f"gauge {key!r} value {v!r} is not numeric")
    for key, h in snap.get("histograms", {}).items():
        if not isinstance(h, dict):
            problems.append(f"histogram {key!r} is not a dict")
            continue
        buckets = h.get("buckets")
        counts = h.get("counts")
        if (not isinstance(buckets, list) or not isinstance(counts, list)
                or len(counts) != len(buckets) + 1):
            problems.append(
                f"histogram {key!r} needs len(counts) == len(buckets)+1")
            continue
        if any(buckets[i] >= buckets[i + 1]
               for i in range(len(buckets) - 1)):
            problems.append(f"histogram {key!r} buckets not ascending")
        if sum(counts) != h.get("count"):
            problems.append(
                f"histogram {key!r} count {h.get('count')} != "
                f"sum(counts) {sum(counts)}")
    try:
        json.dumps(snap)
    except (TypeError, ValueError) as e:
        problems.append(f"snapshot does not json-serialize: {e}")
    return problems


def merge_histograms(hists: Iterable[Histogram]) -> Optional[Histogram]:
    """Fold any number of same-bucket histograms into one (associative —
    any grouping yields identical counts). None for an empty iterable."""
    out: Optional[Histogram] = None
    for h in hists:
        out = h if out is None else out.merge(h)
    return out
