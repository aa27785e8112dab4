"""Serving/training observability: metrics registry, span tracing,
per-request lifecycle records, Perfetto export (docs/observability.md).

The single object the rest of the stack threads around is
:class:`Observability` — a facade bundling a :class:`~repro_torch.obs.metrics.Metrics`
registry and a :class:`~repro_torch.obs.tracing.TraceRecorder`:

    from repro_torch.obs import Observability
    obs = Observability()                       # enabled
    eng = ServingEngine(cfg, params, ServeConfig(..., obs=obs))
    ...
    obs.trace.write("trace.json")               # open in ui.perfetto.dev
    print(json.dumps(obs.metrics.snapshot()))

The default everywhere is :data:`NULL_OBS` — ``enabled=False``, null
metrics, null recorder. Every per-token call site in the engine is
guarded by ``if obs.enabled:`` so the disabled path costs one attribute
load + branch and allocates nothing (tests/test_obs.py pins this).
"""
from __future__ import annotations

from repro_torch.obs.metrics import (
    NULL_METRICS,
    TIME_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    Metrics,
    Timer,
    json_scalars,
    merge_histograms,
    quantile,
    timed,
    validate_metrics_snapshot,
)
from repro_torch.obs.tracing import (
    NULL_RECORDER,
    PHASE_TRACKS,
    NullRecorder,
    RequestTrace,
    TraceRecorder,
    aggregate_request_traces,
    validate_trace,
)

__all__ = [
    "Observability", "NULL_OBS",
    # metrics
    "Metrics", "NULL_METRICS", "Counter", "Gauge", "Histogram",
    "Timer", "timed", "quantile", "json_scalars", "merge_histograms",
    "validate_metrics_snapshot", "TIME_BUCKETS_S",
    # tracing
    "TraceRecorder", "NullRecorder", "NULL_RECORDER", "PHASE_TRACKS",
    "RequestTrace", "aggregate_request_traces", "validate_trace",
]


class Observability:
    """Bundle of one metrics registry + one trace recorder.

    ``Observability()`` is live; ``Observability(enabled=False)`` (or the
    shared :data:`NULL_OBS`) swaps both members for their null twins, so
    holders never branch on construction — only hot paths check
    ``obs.enabled`` to skip building args dicts.
    """

    __slots__ = ("enabled", "metrics", "trace")

    def __init__(self, enabled: bool = True, trace_capacity: int = 65536):
        self.enabled = bool(enabled)
        if self.enabled:
            self.metrics = Metrics()
            self.trace = TraceRecorder(capacity=trace_capacity)
        else:
            self.metrics = NULL_METRICS
            self.trace = NULL_RECORDER

    def __repr__(self) -> str:
        return (f"Observability(enabled={self.enabled}, "
                f"trace_events={len(self.trace)})")


NULL_OBS = Observability(enabled=False)
