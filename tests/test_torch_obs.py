"""Port of the serve observability package (`repro_torch.obs`), on the
CPU: the metrics registry (counters / gauges / fixed-bucket histograms and
the frozen stats() schema), request span tracing, the bounded flight
recorder with exactly-once incident dumps, and the JSONL / Prometheus
exporters, plus the scheduler contracts at mini-MinkUNet size: the stats()
key sets, obs-enabled serving bit-identical to the default path, a span
tree per request, separate error latencies, and a multi-producer chaos
run that leaves the registry consistent.  Mirrors tests/test_obs.py
(its router and partition cases are mirrored in
tests/test_torch_serve_router.py and tests/test_torch_partition.py); the
registry, the tracer, the recorder and both exporters are also driven
beside the reference's on the same seeded contents."""

import json
import threading

import numpy as np
import pytest

from repro import obs as RefObs
from repro_torch import obs as TObs
from repro_torch.data.synthetic import lidar_scene
from repro_torch.obs import (FlightRecorder, Histogram, MetricsRegistry,
                             Observability, SpanTracer, TraceSchemaError,
                             iter_trace_records, metrics as MX,
                             prometheus_text, validate_trace_jsonl,
                             write_prometheus, write_trace_jsonl)
from repro_torch.serve import faults as FLT
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.scheduler import ServeScheduler
from tests.test_torch_serve_faults import (  # noqa: F401 (a fixture)
    mini_engine, one_torch_thread, seg_preds)


def _scene(seed, n):
    c, m, f = lidar_scene(seed=340 + seed, n_points=n, grid=16)
    return c, f, m


@pytest.fixture(scope="module")
def engine():
    return mini_engine()


# ---------------------------------------------------------------------------
# registry units (no engine)
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.inc()
    c.inc(3)
    assert c.value == 4
    g = reg.gauge("depth")
    assert g.value is None                    # unset gauge reads None
    g.set(2)
    g.inc()
    g.dec(3)
    assert g.value == 0
    lazy = reg.gauge("lazy_depth")
    backing = [7]
    lazy.labels().set_function(lambda: backing[0])
    assert lazy.value == 7
    backing[0] = 9
    assert lazy.value == 9
    lazy.labels().set_function(lambda: 1 / 0)  # broken fn reads None
    assert lazy.value is None


def test_registry_idempotent_and_mismatch():
    reg = MetricsRegistry()
    a = reg.counter("x_total", "x", labelnames=("instance",))
    b = reg.counter("x_total", "different help", labelnames=("instance",))
    assert a is b                             # get-or-create, help ignored
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")                  # kind mismatch
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("x_total", labelnames=("code",))  # label mismatch
    with pytest.raises(ValueError, match="takes labels"):
        a.labels()                            # arity enforced


def test_family_labels_and_items():
    reg = MetricsRegistry()
    fam = reg.counter("f_total", labelnames=("instance", "code"))
    fam.labels("w0", "shed").inc(2)
    fam.labels("w1", "shed").inc()
    fam.labels("w0", "timeout").inc()
    assert fam.labels("w0", "shed") is fam.labels("w0", "shed")
    only_w0 = fam.items(instance="w0")
    assert [k for k, _ in only_w0] == [("w0", "shed"), ("w0", "timeout")]
    assert sum(c.value for _, c in fam.items(code="shed")) == 3
    with pytest.raises(ValueError, match="no label"):
        fam.items(bucket="64")


def test_histogram_quantiles():
    h = Histogram(bounds=(1.0, 2.0, 4.0))
    assert h.quantile(0.5) == 0.0             # empty
    for v in (0.5, 1.5, 1.5, 3.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(6.5)
    assert h.counts == [1, 2, 1, 0]
    # p50: rank 2 lands in the (1, 2] bucket, interpolated
    assert 1.0 <= h.quantile(0.5) <= 2.0
    h.observe(100.0)                          # +Inf bucket
    assert h.quantile(0.999) == 4.0           # clamped to the last bound
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)
    q = h.quantiles()
    assert set(q) == {"p50", "p95", "p99"}
    with pytest.raises(ValueError, match="strictly"):
        Histogram(bounds=(2.0, 1.0))


def test_prometheus_text_exposition():
    reg = MetricsRegistry()
    reg.counter("serve_reqs_total", "requests",
                labelnames=("instance",)).labels("w0").inc(3)
    reg.gauge("serve_depth", "queue depth").set(2)
    h = reg.histogram("serve_lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    text = prometheus_text(reg)
    assert "# HELP serve_reqs_total requests" in text
    assert "# TYPE serve_reqs_total counter" in text
    assert 'serve_reqs_total{instance="w0"} 3' in text
    assert "serve_depth 2" in text
    # cumulative buckets + the implicit +Inf bucket + sum/count
    assert 'serve_lat_seconds_bucket{le="0.1"} 1' in text
    assert 'serve_lat_seconds_bucket{le="1"} 2' in text
    assert 'serve_lat_seconds_bucket{le="+Inf"} 2' in text
    assert "serve_lat_seconds_sum 0.55" in text
    assert "serve_lat_seconds_count 2" in text


# ---------------------------------------------------------------------------
# tracer + recorder units
# ---------------------------------------------------------------------------

def test_tracer_span_tree():
    tr = SpanTracer()
    tr.begin("t1", t=0.0, rid=1)
    tr.begin("t1", t=5.0)                     # idempotent: keeps root t=0
    a = tr.span("t1", "assembly", t_start=1.0, t_end=2.0, cache_hit=True)
    tr.span("t1", "arena_staging", parent=a, t_start=1.0, t_end=1.5)
    w = tr.span("t1", "device_wait", t_start=2.0)
    tr.end_span("t1", w, t_end=3.0, ok=True)
    tr.event("t1", "retire", t=3.0)
    trace = tr.get("t1")
    assert not trace.closed
    assert trace.names() == ["request", "assembly", "arena_staging",
                             "device_wait", "retire"]
    tree = trace.tree()
    assert tree["name"] == "request" and tree["attrs"] == {"rid": 1}
    asm = next(c for c in tree["children"] if c["name"] == "assembly")
    assert [c["name"] for c in asm["children"]] == ["arena_staging"]
    (dw,) = trace.find("device_wait")
    assert dw.t_end == 3.0 and dw.attrs == {"ok": True}
    (rt,) = trace.find("retire")
    assert rt.t_start == rt.t_end == 3.0      # events are instant
    tr.end("t1", t=4.0, outcome="ok")
    trace = tr.get("t1")
    assert trace.closed
    assert trace.spans[trace.root_id].attrs["outcome"] == "ok"
    assert tr.stats() == {"live": 0, "finished": 1, "spans_recorded": 5,
                          "dropped": 0}


def test_tracer_unknown_tid_drops_and_bound():
    tr = SpanTracer(max_finished=2)
    assert tr.span("ghost", "x") is None      # unknown tid no-ops
    tr.end_span("ghost", 0)
    tr.end("ghost")
    assert tr.stats()["dropped"] == 3
    for i in range(5):
        tr.begin(f"t{i}", t=0.0)
        tr.end(f"t{i}", t=1.0)
    assert tr.stats()["finished"] == 2        # bounded deque
    assert tr.get("t0") is None               # evicted
    assert tr.get("t4").closed


def test_flight_recorder_dump_once():
    shipped = []
    rec = FlightRecorder(capacity=3, max_dumps=2, sink=shipped.append)
    for i in range(5):
        rec.record("submit", t=float(i), rid=i)
    assert [e["rid"] for e in rec.events()] == [2, 3, 4]   # ring bound
    d = rec.dump("exec_failed", key=("exec_failed", "s", 4))
    assert d["reason"] == "exec_failed"
    assert [e["rid"] for e in d["events"]] == [2, 3, 4]
    assert rec.dump("exec_failed", key=("exec_failed", "s", 4)) is None
    assert shipped == [d]                     # sink got it exactly once
    st = rec.stats()
    assert st["events"] == 5 and st["ring"] == 3
    assert st["dumps"] == 1 and st["suppressed"] == 1
    bad = FlightRecorder(sink=lambda d: 1 / 0)
    bad.record("x")
    assert bad.dump("r", key="k") is not None  # broken sink swallowed
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_trace_jsonl_roundtrip(tmp_path):
    tr = SpanTracer()
    tr.begin("rid:1", t=0.0, rid=1)
    tr.span("rid:1", "dispatch", t_start=1.0, t_end=2.0,
            n=np.int64(3))                     # numpy attrs must serialize
    tr.end("rid:1", t=3.0, outcome="ok")
    tr.begin("rid:2", t=0.0)                   # still live
    rec = FlightRecorder()
    rec.record("submit", t=0.5, rid=1)
    rec.dump("failover", key="w0")
    path = tmp_path / "trace.jsonl"
    n = write_trace_jsonl(path, tr, recorder=rec)
    kinds = [r["kind"] for r in iter_trace_records(tr, rec)]
    assert n == len(kinds) == 4                # 3 spans + 1 dump
    report = validate_trace_jsonl(path)
    assert report == {"lines": 4, "spans": 3, "dumps": 1, "traces": 2,
                      "closed_traces": 1}
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    disp = next(r for r in rows if r.get("name") == "dispatch")
    assert disp["attrs"]["n"] == 3             # np.int64 -> plain int

    # schema violations are loud
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "span"}) + "\n")
    with pytest.raises(TraceSchemaError, match="missing"):
        validate_trace_jsonl(bad)
    bad.write_text("not json\n")
    with pytest.raises(TraceSchemaError, match="not valid JSON"):
        validate_trace_jsonl(bad)
    bad.write_text(json.dumps(dict(rows[1], t_end=0.5)) + "\n")
    with pytest.raises(TraceSchemaError, match="t_end"):
        validate_trace_jsonl(bad)


def test_observability_bundle():
    default = Observability()
    assert default.tracer is None and default.recorder is None
    assert isinstance(default.registry, MetricsRegistry)
    on = Observability.enabled(max_finished=8, capacity=4)
    assert on.tracer is not None and on.recorder is not None
    assert on.recorder.capacity == 4


# ---------------------------------------------------------------------------
# same contents through the reference and the port (no engine)
# ---------------------------------------------------------------------------

def _registry_render(pkg, seed):
    """A registry filled from one seeded script (labelled counters,
    gauges set / incremented / lazy, histograms on custom and default
    bounds): (Prometheus text, every histogram's quantiles, counts and
    sum)."""
    rng = np.random.default_rng(seed)
    reg = pkg.MetricsRegistry()
    reqs = reg.counter("serve_reqs_total", "requests",
                       labelnames=("instance", "code"))
    depth = reg.gauge("serve_depth", "queue depth", ("instance",))
    lat = reg.histogram("serve_lat_seconds", "latency",
                        labelnames=("instance",), buckets=(0.01, 0.1, 1.0))
    wait = reg.histogram("serve_wait_seconds", "wait")
    backing = [3]
    reg.gauge("serve_lazy", "lazy").labels().set_function(
        lambda: backing[0])
    for op in rng.integers(0, 5, 200):
        inst = str(rng.choice(["w0", "w1", "w2"]))
        if op == 0:
            reqs.labels(inst, str(rng.choice(["ok", "shed", "timeout"]))
                        ).inc(int(rng.integers(1, 4)))
        elif op == 1:
            depth.labels(inst).set(int(rng.integers(0, 9)))
        elif op == 2:
            depth.labels(inst).inc()
        elif op == 3:
            lat.labels(inst).observe(float(rng.exponential(0.2)))
        else:
            wait.labels().observe(float(rng.exponential(0.05)))
    backing[0] = 9
    hists = [(h.counts, h.count, h.sum, h.quantiles())
             for h in [lat.labels(i) for i in ("w0", "w1", "w2")]
             + [wait.labels()]]
    return pkg.prometheus_text(reg), hists


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_and_prometheus_match_reference(seed):
    got_text, got_h = _registry_render(TObs, seed)
    want_text, want_h = _registry_render(RefObs, seed)
    assert got_text == want_text
    assert got_h == want_h


def _trace_export(pkg, seed, path):
    """A tracer and a flight recorder filled from one seeded script
    (finished and live traces, nested spans, events, dumps with repeated
    keys), written through the JSONL exporter: (rows without the dumps'
    wall-clock stamps, validator report, tracer and recorder stats,
    trace trees)."""
    rng = np.random.default_rng(seed)
    tr = pkg.SpanTracer(max_finished=6)
    rec = pkg.FlightRecorder(capacity=5, max_dumps=3)
    for rid in range(10):
        tid = f"rid:{rid}"
        t = float(rid)
        tr.begin(tid, t=t, rid=rid)
        d = tr.span(tid, "dispatch", t_start=t + 0.1, t_end=t + 0.4,
                    bucket=np.int64(64), retries=int(rng.integers(0, 3)))
        tr.span(tid, "assembly", parent=d, t_start=t + 0.1, t_end=t + 0.2,
                cache_hit=bool(rng.integers(0, 2)))
        w = tr.span(tid, "device_wait", t_start=t + 0.4)
        rec.record("dispatch", t=t + 0.1, rid=rid)
        if rng.integers(0, 4):
            tr.end_span(tid, w, t_end=t + 0.8, ok=True)
            tr.event(tid, "retire", t=t + 0.8)
            tr.end(tid, t=t + 0.9, outcome="ok")
        if rng.integers(0, 3) == 0:
            rec.dump("exec_failed", key=("exec_failed", int(rid % 3)))
    tr.span("ghost", "x")                      # unknown tid: dropped
    n = pkg.write_trace_jsonl(path, tr, recorder=rec)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for r in rows:
        r.pop("t", None) if r["kind"] == "dump" else None
    trees = [t.tree() for t in tr.finished() + tr.live()]
    return (n, rows, pkg.validate_trace_jsonl(path), tr.stats(),
            rec.stats(), trees)


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_export_matches_reference(seed, tmp_path):
    got = _trace_export(TObs, seed, tmp_path / "port.jsonl")
    want = _trace_export(RefObs, seed, tmp_path / "ref.jsonl")
    assert got == want
    assert want[2]["dumps"] >= 1 and want[2]["closed_traces"] >= 1


# ---------------------------------------------------------------------------
# stats() schema shapes
# ---------------------------------------------------------------------------

def test_scheduler_stats_schema(engine, tmp_path):
    sched = ServeScheduler(engine, max_batch=2)
    out = sched.serve([_scene(0, 40), _scene(1, 90)])
    assert all(r.ok for r in out.values())
    st = sched.stats()
    assert set(st) == MX.SCHEDULER_STATS_KEYS
    assert set(st["faults"]) == MX.SCHEDULER_FAULT_KEYS
    for b in st["buckets"].values():
        assert set(b) == MX.SCHEDULER_BUCKET_KEYS
    q = st["latency_quantiles_s"]
    assert set(q) == {"p50", "p95", "p99"}
    assert 0.0 < q["p50"] <= q["p95"] <= q["p99"]
    text = prometheus_text(sched.obs.registry)
    assert 'serve_requests_ok_total{instance="scheduler"} 2' in text
    path = tmp_path / "metrics.prom"
    write_prometheus(path, sched.obs.registry)
    assert path.read_text() == text
    sched.close()


# ---------------------------------------------------------------------------
# scheduler integration: parity, span trees, error-path latencies
# ---------------------------------------------------------------------------

def test_obs_enabled_bit_identical(engine):
    scenes = [_scene(i, 40 + 10 * i) for i in range(4)]
    plain = ServeScheduler(engine, max_batch=2)
    traced = ServeScheduler(engine, max_batch=2,
                            obs=Observability.enabled())
    ref = plain.serve(scenes)
    got = traced.serve(scenes)
    for rid in ref:
        assert ref[rid].ok and got[rid].ok
        np.testing.assert_array_equal(ref[rid].preds, got[rid].preds)
    a, b = plain.stats(), traced.stats()
    for key in ("n_submitted", "n_completed", "n_ok", "faults",
                "padding_overhead"):
        assert a[key] == b[key]
    plain.close()
    traced.close()


def test_scheduler_request_span_tree(engine):
    obs = Observability.enabled()
    sched = ServeScheduler(engine, max_batch=2, obs=obs, instance="s0")
    scenes = [_scene(0, 40), _scene(1, 90)]
    out = sched.serve(scenes)
    assert all(r.ok for r in out.values())
    for rid, (c, f, m) in zip(sorted(out), scenes):
        np.testing.assert_array_equal(out[rid].preds, seg_preds(c, m, f))
    assert obs.tracer.stats()["live"] == 0
    for rid in out:
        trace = obs.tracer.get(f"s0:rid:{rid}")
        assert trace is not None and trace.closed
        names = trace.names()
        for stage in ("request", "admission", "queue_wait", "dispatch",
                      "assembly", "arena_staging", "assembly_lookup",
                      "device_wait", "retire"):
            assert stage in names, (rid, names)
        root = trace.spans[trace.root_id]
        assert root.attrs["outcome"] == "ok"
        (qw,) = trace.find("queue_wait")
        (dp,) = trace.find("dispatch")
        assert qw.t_end is not None and qw.t_end <= dp.t_start + 1e-9
    kinds = {e["type"] for e in obs.recorder.events()}
    assert {"submit", "dispatch", "retire"} <= kinds
    sched.close()


def test_error_latency_separate_histogram(engine):
    obs = Observability.enabled()
    sched = ServeScheduler(engine, max_batch=2, obs=obs, instance="s1")
    rid_rej = sched.submit(*_scene(7, 300))
    rid_to = sched.submit(*_scene(8, 40), deadline_s=0.0)
    sched.flush()
    out = sched.take([rid_rej, rid_to])
    assert out[rid_rej].error.code == FLT.REJECTED
    assert out[rid_to].error.code == FLT.TIMEOUT
    st = sched.stats()
    assert st["faults"]["rejected"] == 1
    assert st["faults"]["timeout"] == 1
    assert st["latency_avg_s"] == 0.0
    errlat = obs.registry.histogram(
        "serve_error_latency_seconds", labelnames=("instance", "code"))
    assert errlat.labels("s1", FLT.REJECTED).count == 1
    assert errlat.labels("s1", FLT.TIMEOUT).count == 1
    trace = obs.tracer.get(f"s1:rid:{rid_rej}")
    assert trace.closed
    assert trace.spans[trace.root_id].attrs["outcome"] == FLT.REJECTED
    sched.close()


def test_chaos_registry_reconciles(engine):
    """Concurrent producers, then one corrupted and one poisoned submit
    from this thread: the plan's submit ordinals follow the rids only
    once the producers have joined (the reference's rid 1 / ordinal 2 may
    land on one scene under thread interleaving, and then nothing
    exec-fails)."""
    n_producers, per_producer = 3, 4
    n_total = n_producers * per_producer + 2
    plan = FaultPlan(poison_rids=frozenset({n_total - 1}),
                     corrupt_scenes=frozenset({n_total - 2}))
    obs = Observability.enabled()
    sched = ServeScheduler(engine, max_batch=2, fault_plan=plan,
                           obs=obs, instance="cx")
    rids, errs = [], []
    lock = threading.Lock()

    def producer(k):
        try:
            for j in range(per_producer):
                rid = sched.submit(*_scene(10 + k * per_producer + j,
                                           40 + 10 * j))
                with lock:
                    rids.append(rid)
        except Exception as e:                # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(n_producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and not any(t.is_alive() for t in threads)
    rids += [sched.submit(*_scene(30 + i, 40)) for i in range(2)]
    assert rids[-2:] == [n_total - 2, n_total - 1]
    sched.flush()
    out = sched.take(rids)
    st = sched.stats()
    ft = st["faults"]
    assert st["n_submitted"] == n_total
    assert st["n_completed"] == n_total
    assert st["n_submitted"] == (st["n_ok"] + ft["rejected"] + ft["shed"]
                                 + ft["timeout"] + ft["exec_failed"])
    assert ft["exec_failed"] == 1
    assert ft["rejected"] == 1
    assert sum(1 for r in out.values() if r.ok) == st["n_ok"]
    assert obs.tracer.stats()["live"] == 0
    for rid in rids:
        trace = obs.tracer.get(f"cx:rid:{rid}")
        assert trace is not None and trace.closed, rid
        assert "outcome" in trace.spans[trace.root_id].attrs
    assert obs.recorder.stats()["dumps"] == 1
    (dump,) = obs.recorder.dumps
    assert dump["reason"] == "exec_failed"
    sched.close()
