"""Validator CLI for emitted observability artifacts.

    PYTHONPATH=src python -m repro_torch.obs --trace trace.json \
        --metrics metrics.json

Checks a Chrome/Perfetto trace file (schema, async b/e balance, X-span
nesting — repro_torch.obs.tracing.validate_trace) and/or a metrics snapshot
(section shapes, histogram invariants, JSON round-trip —
repro_torch.obs.metrics.validate_metrics_snapshot). Exit 0 iff every checked
file is clean; the CI ``observability`` job runs this over the serve
demo's artifacts.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.obs import validate_metrics_snapshot, validate_trace


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.obs", description="validate trace/metrics artifacts")
    p.add_argument("--trace", action="append", default=[],
                   help="Chrome/Perfetto trace JSON to validate "
                        "(repeatable)")
    p.add_argument("--metrics", action="append", default=[],
                   help="metrics snapshot JSON to validate (repeatable)")
    args = p.parse_args(argv)
    if not args.trace and not args.metrics:
        p.error("nothing to do: pass --trace and/or --metrics")

    failures = 0
    for path in args.trace:
        with open(path) as f:
            trace = json.load(f)
        problems = validate_trace(trace)
        n = len(trace.get("traceEvents", []))
        if problems:
            failures += 1
            print(f"[obs] TRACE {path}: {len(problems)} problem(s) "
                  f"in {n} events")
            for msg in problems:
                print(f"  - {msg}")
        else:
            print(f"[obs] trace ok: {path} ({n} events)")
    for path in args.metrics:
        with open(path) as f:
            snap = json.load(f)
        problems = validate_metrics_snapshot(snap)
        if problems:
            failures += 1
            print(f"[obs] METRICS {path}: {len(problems)} problem(s)")
            for msg in problems:
                print(f"  - {msg}")
        else:
            n = sum(len(snap.get(k, {}))
                    for k in ("counters", "gauges", "histograms"))
            print(f"[obs] metrics ok: {path} ({n} series)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
