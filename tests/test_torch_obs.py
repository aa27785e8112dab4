"""The port's observability (repro_torch/obs and the engine's hooks)
against the JAX package's: one counterpart for each test of
tests/test_obs.py but the jaxpr lint (which has no counterpart in the
port: nothing of it is traced).

The metrics and tracing units drive the same operations through the
reference's ``repro.obs`` and the port's copy and compare what they give
back: the same values, snapshots and exported Chrome-trace events (times
masked). The engine tests serve the same requests through the JAX engine
and the port's with ``Observability()`` on (``serving_pair``): the same
counters and gauges, the same trace events in the same order (times
masked), request traces holding exactly each stream's tokens.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import asyncio
import json

import numpy as np
import pytest
import serving_pair as SP

from repro import obs as J
from repro.serving.frontend import AsyncServingEngine as JAsync
from repro_torch import obs as P
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.frontend import AsyncServingEngine


def events(doc):
    """Exported trace events with their times masked."""
    return SP.mask_ts(doc["traceEvents"])


def counters_gauges(snap):
    """A metrics snapshot without its timing histograms' values: counters
    and gauges whole, histograms by count."""
    return (snap["counters"], snap["gauges"],
            {k: v["count"] for k, v in snap["histograms"].items()})


# -- metrics -------------------------------------------------------------------

def test_counter_gauge_basics():
    got = []
    for m in (J, P):
        reg = m.Metrics()
        c = reg.counter("reqs_total", kind="fresh")
        c.inc()
        c.inc(3)
        assert c.value == 4
        assert reg.counter("reqs_total", kind="fresh") is c
        assert reg.counter("reqs_total", kind="resume") is not c
        g = reg.gauge("pool_free")
        g.set(7)
        g.set_max(3)
        assert g.value == 7
        g.set_max(11)
        assert g.value == 11
        got.append(reg.snapshot())
    assert got[0] == got[1]


def test_metric_kind_conflict_raises():
    for m in (J, P):
        reg = m.Metrics()
        reg.counter("x_total")
        with pytest.raises(ValueError):
            reg.gauge("x_total")


def test_histogram_quantile_and_exact_quantile():
    got = []
    for m in (J, P):
        h = m.Histogram("lat_s", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
        assert h.count == 4
        assert h.mean() == pytest.approx((0.05 + 0.5 + 0.5 + 5.0) / 4)
        assert 0.0 <= h.quantile(0.5) <= 1.0
        assert m.quantile([1.0, 2.0, 3.0, 4.0], 0.5) == pytest.approx(2.5)
        assert m.quantile([1.0], 0.99) == 1.0
        xs = list(np.random.default_rng(3).exponential(0.1, 37))
        got.append((h.snapshot(), h.quantile(0.5), h.quantile(0.99),
                    [m.quantile(xs, q) for q in (0.0, 0.5, 0.95, 0.99, 1.0)]))
    assert got[0] == got[1]


def test_histogram_merge_associative():
    buckets = (0.01, 0.1, 1.0)
    got = []
    for m in (J, P):
        rng = np.random.default_rng(0)
        hs = []
        for _ in range(3):
            h = m.Histogram("t_s", buckets=buckets)
            for v in rng.exponential(0.1, 50):
                h.observe(float(v))
            hs.append(h)
        a, b, c = hs
        left = a.merge(b).merge(c).snapshot()
        assert left == a.merge(b.merge(c)).snapshot()
        assert m.merge_histograms(hs).snapshot() == left
        assert a.count == 50
        got.append(left)
    assert got[0] == got[1]


def test_histogram_merge_bucket_mismatch_raises():
    for m in (J, P):
        with pytest.raises(ValueError):
            m.Histogram("a", buckets=(1.0,)).merge(
                m.Histogram("a", buckets=(2.0,)))


def test_metrics_snapshot_schema_and_roundtrip():
    got = []
    for m in (J, P):
        reg = m.Metrics()
        reg.counter("hits_total", cache="prefix").inc(2)
        reg.gauge("free_pages").set(5)
        reg.histogram("step_s").observe(0.01)
        snap = reg.snapshot()
        assert m.validate_metrics_snapshot(snap) == []
        assert snap == json.loads(json.dumps(snap))
        assert snap["counters"]["hits_total{cache=prefix}"] == 2
        assert snap["gauges"]["free_pages"] == 5
        assert snap["histograms"]["step_s"]["count"] == 1
        got.append(snap)
    assert got[0] == got[1]
    # each validator accepts the other's snapshot and flags the same faults
    bad = {"counters": {"x": -1}, "gauges": {}, "histograms": {
        "h": {"count": 2, "sum": 0.1, "buckets": [1.0], "counts": [1]}}}
    assert J.validate_metrics_snapshot(bad) == \
        P.validate_metrics_snapshot(bad) != []


def test_timer():
    for m in (J, P):
        with m.Timer() as tm:
            sum(range(1000))
        assert tm.dt > 0.0
        assert tm.ms == pytest.approx(tm.dt * 1e3)
        h = m.Histogram("t_s")
        with m.Timer(h):
            pass
        assert h.count == 1


# -- tracing -------------------------------------------------------------------

def test_trace_export_valid_and_balanced():
    got = []
    for m in (J, P):
        tr = m.TraceRecorder()
        t0 = tr.epoch
        tr.complete("decode-step", "decode x2", t0, t0 + 0.001,
                    args={"slots": 2})
        tr.instant("evict", "evict 3p")
        tr.async_begin(7, {"prompt_len": 4})
        tr.async_instant(7, "first-token")
        tr.async_end(7, {"n_tokens": 5})
        doc = tr.export()
        assert m.validate_trace(doc) == []
        evs = doc["traceEvents"]
        names = [e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "thread_name"]
        assert list(m.PHASE_TRACKS) == names[:len(m.PHASE_TRACKS)]
        b = [e for e in evs if e["ph"] == "b"]
        e_ = [e for e in evs if e["ph"] == "e"]
        assert len(b) == len(e_) == 1
        assert b[0]["id"] == e_[0]["id"] == "7"
        assert b[0]["cat"] == "request"
        got.append(events(doc))
    assert got[0] == got[1]


def test_trace_auto_closes_open_async_spans():
    got = []
    for m in (J, P):
        tr = m.TraceRecorder()
        tr.async_begin(3)
        tr.async_instant(3, "first-token")
        doc = tr.export()
        assert m.validate_trace(doc) == []
        closes = [e for e in doc["traceEvents"] if e["ph"] == "e"]
        assert len(closes) == 1
        assert closes[0]["args"]["truncated"] is True
        got.append(events(doc))
    assert got[0] == got[1]


def test_trace_ring_drops_oldest():
    got = []
    for m in (J, P):
        tr = m.TraceRecorder(capacity=4)
        for i in range(10):
            tr.instant("admit", f"ev{i}")
        assert len(tr) == 4
        assert tr.dropped == 6
        doc = tr.export()
        assert m.validate_trace(doc) == []
        got.append((events(doc), doc["otherData"]["dropped_events"]))
    assert got[0] == got[1]


def test_validate_trace_catches_imbalance():
    bad = {"traceEvents": [
        {"ph": "b", "cat": "request", "id": "1", "name": "req 1",
         "pid": 1, "ts": 0.0}]}
    assert J.validate_trace(bad) == P.validate_trace(bad) != []


# -- null mode -----------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    return SP.make_setup()


def test_null_obs_records_nothing(setup):
    eng = SP.port_engine(setup, batch_slots=2, max_len=32)
    assert eng.obs is P.NULL_OBS
    eng.submit([1, 2, 3])
    for _ in range(4):
        eng.step()
    assert len(eng.obs.trace) == 0
    snap = eng.obs.metrics.snapshot()
    assert all(v == {} for v in snap.values())
    assert eng.request_traces == {}
    assert eng.obs.metrics.counter("a") is eng.obs.metrics.gauge("b")
    assert eng.obs.trace.export()["traceEvents"] == []
    assert J.NULL_OBS.trace.export() == P.NULL_OBS.trace.export()


# -- engine integration ----------------------------------------------------------

def _serve(eng, prompts, max_steps=60):
    rids = [eng.submit(p) for p in prompts]
    streams = {r: [] for r in rids}
    for _ in range(max_steps):
        for h, t in eng.step().items():
            streams[h].extend(t if isinstance(t, list) else [t])
        if not eng.slot_live.any() and not eng.wait:
            break
    return rids, streams


def test_request_trace_token_exact_across_preempt_resume(setup):
    """A preempted and resumed request's trace holds exactly the tokens
    the engine reported, and records the preemption; trace events and
    counters equal the JAX engine's."""
    prompts = [[1, 2, 3], [4, 5, 6]]
    res = []
    for eng in SP.pair(setup, batch_slots=2, max_len=16, cache_pages=2,
                       obs=True):
        rids, streams = _serve(eng, prompts)
        assert eng.n_preemptions > 0
        preempted = 0
        for r in rids:
            rt = eng.request_trace(r)
            assert rt is not None
            assert rt.tokens == streams[r]
            assert rt.ttft_s() is not None and rt.ttft_s() > 0
            assert rt.retire_s is not None
            assert rt.prompt_len == 3
            assert rt.itl.count == len(rt.tokens) - 1
            assert len(rt.itl_list()) == len(rt.tokens) - 1
            assert rt.pages_timeline
            preempted += rt.n_preemptions
            assert json.loads(json.dumps(rt.to_json())) == rt.to_json()
        assert preempted == eng.n_preemptions
        m = J if isinstance(eng.obs, J.Observability) else P
        agg = m.aggregate_request_traces([eng.request_trace(r) for r in rids])
        assert agg["n_requests"] == 2
        assert agg["total_tokens"] == sum(len(s) for s in streams.values())
        assert agg["preemptions"] == eng.n_preemptions
        assert agg["ttft_s"]["p50"] is not None
        doc = eng.obs.trace.export()
        assert m.validate_trace(doc) == []
        tracks = {e.get("args", {}).get("name")
                  for e in doc["traceEvents"] if e["ph"] == "M"}
        assert "preempt" in tracks and "resume" in tracks
        snap = eng.obs.metrics.snapshot()
        assert m.validate_metrics_snapshot(snap) == []
        assert snap["counters"]["engine_preemptions_total"] == \
            eng.n_preemptions
        res.append((streams, [eng.request_trace(r).pages_timeline
                              for r in rids],
                    events(doc), counters_gauges(snap)))
    assert res[0] == res[1]


def test_engine_metrics_match_stats(setup):
    res = []
    for eng in SP.pair(setup, batch_slots=2, max_len=32, prefix_cache=True,
                       obs=True):
        eng.submit(list(range(1, 10)))
        eng.submit(list(range(1, 10)))
        for _ in range(3):
            eng.step()
        st = eng.stats()
        snap = eng.obs.metrics.snapshot()
        c = snap["counters"]
        assert c["engine_tokens_total{stage=prefill}"] == st["prefill_tokens"]
        assert c["engine_tokens_total{stage=decode}"] == st["decode_tokens"]
        assert c["prefix_hits_total"] == st["prefix_hits"]
        assert c["prefix_hit_tokens_total"] == st["prefix_hit_tokens"]
        assert snap["gauges"]["pool_pages_in_use"] == st["pool_pages_in_use"]
        assert snap["gauges"]["pool_high_water_pages"] == \
            st["pool_high_water"]
        assert snap["histograms"]["engine_prefill_chunk_s"]["count"] >= 1
        assert snap["histograms"]["engine_decode_step_s"]["count"] >= 1
        rts = sorted(eng.request_traces.values(), key=lambda t: t.rid)
        assert rts[1].prefix_hit_tokens > 0
        res.append((counters_gauges(snap), events(eng.obs.trace.export())))
    assert res[0] == res[1]


def test_stats_json_roundtrip_both_backends(setup):
    core = {"tick", "live_requests", "waiting_requests", "n_preemptions",
            "prefill_tokens", "decode_tokens"}
    paged_keys = core | {
        "pool_pages", "pool_free_pages", "pool_pages_in_use",
        "pool_high_water", "kv_dtype", "kv_page_bytes", "kv_pool_bytes",
        "kv_bytes_in_use", "prefix_hits", "prefix_misses",
        "prefix_evictions", "prefix_cow_forks", "prefix_cached_pages",
        "prefix_hit_tokens", "prefix_lookup_tokens", "prefix_hit_rate"}
    for attn, kw, want in (("default", {}, core),
                           ("paged", dict(prefix_cache=True), paged_keys)):
        got = []
        for eng in SP.pair(setup, attn, batch_slots=2, max_len=32, **kw):
            eng.submit([1, 2, 3])
            eng.step()
            st = eng.stats()
            assert want <= set(st)
            assert json.loads(json.dumps(st)) == st
            for k, v in st.items():
                assert type(v) in (int, float, str, bool, type(None)), (k, v)
            got.append(st)
        # the same values; bytes differ only with the pools' dtype, which
        # is fp32 on both sides here
        assert got[0] == got[1]


def test_frontend_slo_report(setup):
    reps = []
    for eng, Front in zip(SP.pair(setup, batch_slots=2, max_len=32,
                                  obs=True), (JAsync, AsyncServingEngine)):
        aeng = Front(eng)

        async def demo():
            return await asyncio.gather(
                aeng.complete([1, 2, 3], 4),
                aeng.complete([4, 5], 4, deadline=0.0))

        outs = asyncio.run(demo())
        assert all(len(o) == 4 for o in outs)
        rep = aeng.slo_report()
        assert rep["n_completed"] == 2
        assert rep["n_first_tokens"] == 2
        assert rep["ttft_s"]["p50"] is not None
        assert rep["itl_s"]["p95"] is not None
        assert rep["deadline_misses"] == 1
        assert json.loads(json.dumps(rep)) == rep
        reps.append((outs, {k: rep[k] for k in ("n_completed",
                                                "n_first_tokens",
                                                "deadline_misses")},
                     eng.obs.metrics.snapshot()["counters"]))
    assert reps[0] == reps[1]


def test_cancel_live_slot_emits_cancelled_end(setup):
    for attn in ("default", "paged"):
        got = []
        for eng in SP.pair(setup, attn, batch_slots=2, max_len=32, obs=True):
            h = eng.submit([1, 2, 3])
            eng.step()
            eng.step()
            assert eng.cancel(h) is True
            c = eng.obs.metrics.snapshot()["counters"]
            assert c["engine_cancelled_total"] == 1
            assert c.get("engine_retired_total", 0) == 0
            ends = [e for e in eng.obs.trace.export()["traceEvents"]
                    if e["ph"] == "e" and e["id"] == str(h)]
            assert len(ends) == 1
            assert ends[0]["args"]["cancelled"] is True
            assert ends[0]["args"]["n_tokens"] == 2
            got.append((c, events(eng.obs.trace.export())))
        assert got[0] == got[1]


def test_cancel_waiting_request_still_counts_cancelled(setup):
    got = []
    for eng in SP.pair(setup, batch_slots=2, max_len=16, cache_pages=2,
                       obs=True):
        r0 = eng.submit([1, 2, 3])
        assert r0 is not None
        for _ in range(12):
            eng.step()
            if any(w.rid == r0 for w in eng.wait):
                break
        if not any(w.rid == r0 for w in eng.wait):
            s = next(s for s in range(2) if eng.slot_live[s]
                     and int(eng.slot_rid[s]) == r0)
            eng._preempt(s)
        assert eng.cancel(r0) is True
        c = eng.obs.metrics.snapshot()["counters"]
        assert c["engine_cancelled_total"] == 1
        assert c.get("engine_retired_total", 0) == 0
        got.append((c, events(eng.obs.trace.export())))
    assert got[0] == got[1]


def test_spec_metrics_and_phase_spans(setup):
    got = []
    for eng in SP.pair(setup, batch_slots=2, max_len=48, obs=True,
                       spec=lambda m: m.NGramDrafter(k=4)):
        eng.submit([7, 7, 7, 7, 7, 7])
        eng.submit([1, 2, 3, 1, 2, 3])
        for _ in range(10):
            eng.step()
        st = eng.stats()
        assert st["spec_accepted_tokens"] + st["spec_rejected_tokens"] > 0
        snap = eng.obs.metrics.snapshot()
        c = snap["counters"]
        assert c["spec_tokens_total{verdict=accepted}"] == \
            st["spec_accepted_tokens"]
        assert c["spec_tokens_total{verdict=rejected}"] == \
            st["spec_rejected_tokens"]
        assert c.get("spec_rollback_pages_total", 0) == \
            st["spec_rollback_pages"]
        assert snap["histograms"]["spec_acceptance_rate"]["count"] >= 1
        doc = eng.obs.trace.export()
        tracks = {e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"draft", "verify"} <= tracks
        spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert any(n.startswith("draft x") for n in spans)
        assert any(n.startswith("verify x") for n in spans)
        got.append((st, snap["counters"],
                    snap["histograms"]["spec_acceptance_rate"],
                    events(doc)))
    assert P.validate_trace(J.Observability().trace.export()) == []
    assert got[0] == got[1]


# -- the launcher's flags and the validator CLI ---------------------------------

@pytest.mark.parametrize("flag", ["--trace-out", "--metrics-json"])
def test_cli_obs_artifacts(capsys, tmp_path, flag):
    from repro_torch.obs.__main__ import main as validate
    path = tmp_path / "out.json"
    assert serve_cli.main(
        ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
         "--max-len", "16", "--batch-slots", "2", "--n-requests", "3",
         "--prompt-len", "6", "--gen-len", "4", "--page-size", "8",
         "--cache-pages", "4", "--prefix-cache", "--spec", "ngram",
         flag, str(path)]) == 0
    doc = json.loads(path.read_text())
    kind = "--trace" if flag == "--trace-out" else "--metrics"
    assert validate([kind, str(path)]) == 0
    if kind == "--trace":
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert any(n.startswith("verify x") for n in names)
        assert sum(e["ph"] == "b" for e in doc["traceEvents"]) == 3
    else:
        assert doc["counters"]["engine_tokens_total{stage=decode}"] > 0
        assert doc["counters"]["engine_admissions_total{kind=fresh}"] == 3
