"""The port's fleet telemetry plane (`obs/fleet.py`) and SLO watchdog
(`obs/watchdog.py`), case for case with the JAX package's: the exporter's
full-then-delta publishes, its span ring sampling with counted drops, no
re-export of remote spans, a failed publish counted with its delta kept,
spans re-pended when the bus dies mid-round, truncated snapshots rotating
through every key; the aggregator stitching remote spans with role and
pid, ignoring its own role, bounding roles, full snapshots replacing
deltas, the `/api/fleet` roll-up folding the supervisor's verdicts, the
role-labelled exposition without duplicate series; the watchdog's
threshold parsing, its structured breach events and its per-role
judgment. Every case runs on both packages (`pkg`); a port exporter's
wire feeds a JAX aggregator and the other way round."""

import asyncio
import json
import types

import pytest

import symbiont_tpu.obs.fleet as jfleet
import symbiont_tpu.obs.watchdog as jwatchdog
import symbiont_tpu.subjects as jsubjects
import symbiont_tpu.utils.telemetry as jtelemetry
import symbiont_tpu_torch.obs.fleet as tfleet
import symbiont_tpu_torch.obs.watchdog as twatchdog
import symbiont_tpu_torch.subjects as tsubjects
import symbiont_tpu_torch.utils.telemetry as ttelemetry
from symbiont_tpu.obs.trace_store import SpanRecord as JSpanRecord
from symbiont_tpu.obs.trace_store import TraceStore as JTraceStore
from symbiont_tpu_torch.obs.trace_store import SpanRecord as TSpanRecord
from symbiont_tpu_torch.obs.trace_store import TraceStore as TTraceStore

# obs/__init__ exports the process's `trace_store`, which shadows the module
PACKAGES = {
    "jax": types.SimpleNamespace(
        fleet=jfleet, watchdog=jwatchdog, subjects=jsubjects, Metrics=jtelemetry.Metrics,
        trace=types.SimpleNamespace(SpanRecord=JSpanRecord, TraceStore=JTraceStore)),
    "port": types.SimpleNamespace(
        fleet=tfleet, watchdog=twatchdog, subjects=tsubjects, Metrics=ttelemetry.Metrics,
        trace=types.SimpleNamespace(SpanRecord=TSpanRecord, TraceStore=TTraceStore)),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class _FakeBus:
    def __init__(self):
        self.msgs = []

    async def publish(self, subject, data, headers=None):
        self.msgs.append((subject, data))


def _exporter(pkg, bus, **kw):
    kw = dict(dict(role="worker", publish_s=5.0, registry=pkg.Metrics(),
                   store=pkg.trace.TraceStore(256)), **kw)
    return pkg.fleet.TelemetryExporter(lambda: bus, **kw)


def _aggregator(pkg, registry=None, **kw):
    return pkg.fleet.FleetAggregator(local_role="api", store=pkg.trace.TraceStore(64),
                                     registry=registry or pkg.Metrics(), **kw)


def _span(pkg, i, name="perception.handle", fields=None):
    return pkg.trace.SpanRecord("t1", f"s{i}", None, name, 100.0 + i, 2.0, "ok",
                                fields=dict(fields or {}))


def _spans_payload(role, spans, pid=1234):
    return json.dumps({"role": role, "pid": pid, "ts": 0.0,
                       "spans": [s.to_dict() for s in spans]}).encode()


# ------------------------------------------------------------------ exporter


def test_exporter_full_then_delta_then_quiet(pkg):
    async def main():
        bus = _FakeBus()
        exp = _exporter(pkg, bus)
        exp.registry.inc("a.ticks")
        exp.registry.inc("b.ticks")
        await exp.publish_once()
        first = json.loads(bus.msgs[-1][1])
        assert first["full"] is True and "counter.a.ticks" in first["metrics"]
        exp.registry.inc("a.ticks")
        await exp.publish_once()
        second = json.loads(bus.msgs[-1][1])
        assert second["full"] is False and "counter.a.ticks" in second["metrics"]
        assert "counter.b.ticks" not in second["metrics"]
        await exp.publish_once()
        assert "counter.a.ticks" not in json.loads(bus.msgs[-1][1])["metrics"]

    asyncio.run(main())


def test_exporter_samples_spans_and_counts_drops(pkg):
    async def main():
        bus = _FakeBus()
        exp = _exporter(pkg, bus, spans_max=4, pending_max=8)
        exp.store.add_tap(exp._tap)
        for i in range(20):
            exp.store.record(_span(pkg, i))
        assert len(exp._pending) == 8 and exp.registry.get("fleet.spans_dropped") == 12
        await exp.publish_once()
        assert len(json.loads(bus.msgs[-1][1])["spans"]) == 4
        await exp.publish_once()
        assert len(json.loads(bus.msgs[-1][1])["spans"]) == 4

    asyncio.run(main())


def test_exporter_never_reexports_remote_spans(pkg):
    exp = _exporter(pkg, _FakeBus())
    exp.store.add_tap(exp._tap)
    exp.store.record(_span(pkg, 1, fields={"role": "embed", "pid": 7}))
    exp.store.record(_span(pkg, 2))
    assert [r.span_id for r in exp._pending] == ["s2"]


def test_exporter_failure_is_counted_and_the_delta_survives(pkg):
    async def main():
        exp = _exporter(pkg, None)
        exp.registry.inc("a.ticks")
        assert await exp.publish_once() is False
        assert exp.registry.get("fleet.publish_failures") == 1
        bus = _FakeBus()
        exp.bus_fn = lambda: bus
        await exp.publish_once()
        assert "counter.a.ticks" in json.loads(bus.msgs[-1][1])["metrics"]

    asyncio.run(main())


def test_exporter_repends_spans_when_the_bus_dies_midway(pkg):
    class _HalfDeadBus:
        async def publish(self, subject, data, headers=None):
            if ".spans." in subject:
                raise ConnectionError("broker died mid-round")

    async def main():
        exp = _exporter(pkg, _HalfDeadBus(), spans_max=4)
        exp.store.add_tap(exp._tap)
        for i in range(3):
            exp.store.record(_span(pkg, i))
        with pytest.raises(ConnectionError):
            await exp.publish_once()
        assert [r.span_id for r in exp._pending] == ["s0", "s1", "s2"]
        good = _FakeBus()
        exp.bus_fn = lambda: good
        await exp.publish_once()
        assert [s["span_id"] for s in json.loads(good.msgs[-1][1])["spans"]] == \
            ["s0", "s1", "s2"]

    asyncio.run(main())


@pytest.mark.parametrize("churn", [False, True], ids=["stable", "churning"])
def test_truncated_snapshots_rotate_through_every_key(pkg, churn):
    async def main():
        bus = _FakeBus()
        exp = _exporter(pkg, bus, metrics_max=10, full_every=1000)
        agg = _aggregator(pkg)
        for rnd in range(8):
            if churn or rnd == 0:
                for i in range(20):
                    exp.registry.gauge_set(f"g.k{i:02d}", float(rnd * 100 + i))
            await exp.publish_once()
            agg.handle(*bus.msgs[-1])
        merged = agg.role_snapshots()["worker"]
        assert all(f"gauge.g.k{i:02d}" in merged for i in range(20))

    asyncio.run(main())


# ---------------------------------------------------------------- aggregator


def test_aggregator_stitches_remote_spans_with_role_and_pid(pkg):
    agg = _aggregator(pkg)
    agg.handle(f"{pkg.subjects.SYS_TELEMETRY_SPANS}.embed",
               _spans_payload("embed", [_span(pkg, 1)], pid=77))
    [rec] = agg.store.spans_for("t1")
    assert rec.fields["role"] == "embed" and rec.fields["pid"] == 77
    [(labels, summary)] = agg.registry.histogram_summaries("span.perception.handle.ms")
    assert labels == {"role": "embed"} and summary["count"] == 1


def test_aggregator_ignores_its_own_role_and_bounds_roles(pkg):
    agg = _aggregator(pkg, max_roles=2)
    agg.handle(f"{pkg.subjects.SYS_TELEMETRY_SPANS}.api",
               _spans_payload("api", [_span(pkg, 1)]))
    assert len(agg.store) == 0
    for i in range(4):
        agg.handle(f"{pkg.subjects.SYS_TELEMETRY_METRICS}.r{i}",
                   json.dumps({"role": f"r{i}", "full": True,
                               "metrics": {"gauge.x": 1.0}}).encode())
    assert len(agg.role_snapshots()) == 2
    assert agg.registry.get("fleet.role_overflow") == 2


def test_full_snapshot_replaces_delta_updates(pkg):
    agg = _aggregator(pkg)

    def send(full, metrics):
        agg.handle(f"{pkg.subjects.SYS_TELEMETRY_METRICS}.w",
                   json.dumps({"role": "w", "full": full, "metrics": metrics}).encode())

    send(True, {"gauge.a": 1.0, "gauge.b": 2.0})
    send(False, {"gauge.a": 5.0})
    assert agg.role_snapshots()["w"] == {"gauge.a": 5.0, "gauge.b": 2.0}
    send(True, {"gauge.a": 6.0})
    assert agg.role_snapshots()["w"] == {"gauge.a": 6.0}


def test_rollup_folds_the_supervisors_verdicts(pkg):
    agg = _aggregator(pkg)
    agg.merge_metrics("procsup", {"full": True, "pid": 1, "metrics": {
        'gauge.procsup.up{role="broker"}': 1.0,
        'gauge.procsup.up{role="embed"}': 0.0,
        'gauge.procsup.heartbeat_age_s{role="embed"}': 9.5,
        'counter.procsup.restarts{role="embed"}': 3.0,
        'counter.procsup.hangs{role="embed"}': 1.0,
        'gauge.procsup.draining{role="embed-2"}': 1.0,
        'gauge.procsup.crashlooped{role="embed-2"}': 0.0,
        'counter.procsup.scale_out{role="embed"}': 2.0,
        'counter.procsup.scale_in{role="embed"}': 1.0}})
    roles = agg.rollup()["roles"]
    assert roles["broker"]["up"] == 1.0 and "procsup" in roles
    assert {k: roles["embed"][k] for k in ("up", "heartbeat_age_s", "restarts", "hangs",
                                           "scale_out", "scale_in")} == \
        {"up": 0.0, "heartbeat_age_s": 9.5, "restarts": 3.0, "hangs": 1.0,
         "scale_out": 2.0, "scale_in": 1.0}
    assert roles["embed-2"]["draining"] == 1.0 and roles["embed-2"]["crashlooped"] == 0.0


def test_exposition_is_role_labelled_without_duplicate_series(pkg):
    reg = pkg.Metrics()
    reg.inc("bus.consumed", labels={"service": "api"})
    agg = _aggregator(pkg, registry=reg)
    agg.handle(f"{pkg.subjects.SYS_TELEMETRY_SPANS}.embed",
               _spans_payload("embed", [_span(pkg, 1)]))
    agg.handle(f"{pkg.subjects.SYS_TELEMETRY_METRICS}.embed", json.dumps({
        "role": "embed", "full": True, "metrics": {
            'counter.bus.consumed{service="preprocessing"}': 7.0,
            "gauge.batcher.queue_depth": 3.0,
            "hist.span.perception.handle.ms.p99": 9.0,
            "hist.span.perception.handle.ms.count": 1.0,
            'gauge.slo.p99_ms{span="api.search"}': 9.0}}).encode())
    agg.handle(f"{pkg.subjects.SYS_TELEMETRY_METRICS}.procsup", json.dumps({
        "role": "procsup", "full": True,
        "metrics": {'gauge.procsup.up{role="broker"}': 1.0}}).encode())
    out = agg.render_exposition()
    assert 'symbiont_bus_consumed_total{role="api",service="api"} 1' in out
    assert 'symbiont_bus_consumed_total{role="embed",service="preprocessing"} 7' in out
    assert 'symbiont_queue_depth{role="embed",service="batcher"} 3' in out
    assert 'symbiont_procsup_up{role="broker"} 1' in out
    assert ('symbiont_span_duration_ms_count{role="embed",service="perception",'
            'span="perception.handle"} 1') in out
    samples = [line.split(" ")[0] for line in out.splitlines()
               if line and not line.startswith("#")]
    assert len(samples) == len(set(samples))
    assert out.count("# TYPE symbiont_bus_consumed_total counter") == 1


@pytest.mark.parametrize("exp_pkg,agg_pkg", [("jax", "port"), ("port", "jax")])
def test_one_wire_across_the_packages(exp_pkg, agg_pkg):
    e, a = PACKAGES[exp_pkg], PACKAGES[agg_pkg]

    async def main():
        bus = _FakeBus()
        exp = _exporter(e, bus)
        exp.store.add_tap(exp._tap)
        exp.registry.inc("bus.consumed", 3, labels={"service": "embed"})
        exp.store.record(_span(e, 1))
        await exp.publish_once()
        agg = _aggregator(a)
        for subject, data in bus.msgs:
            agg.handle(subject, data)
        assert agg.role_snapshots()["worker"]['counter.bus.consumed{service="embed"}'] == 3.0
        [rec] = agg.store.spans_for("t1")
        assert rec.fields["role"] == "worker"

    asyncio.run(main())


# ------------------------------------------------------------------ watchdog


def test_watchdog_threshold_parsing(pkg):
    assert pkg.watchdog.parse_thresholds(["api.search=500", "x.y=1.5"]) == {
        "api.search": 500.0, "x.y": 1.5}
    for bad in (["api.search"], ["=5"], ["a=notanumber"], ["a=-3"]):
        with pytest.raises(ValueError):
            pkg.watchdog.parse_thresholds(bad)


def test_watchdog_breach_emits_a_structured_event(pkg):
    m = pkg.Metrics()
    for v in (5.0, 6.0, 900.0):
        m.observe("span.api.search.ms", v)
    m.observe("span.api.healthy.ms", 1.0)
    wd = pkg.watchdog.SloWatchdog({"api.search": 100.0, "api.healthy": 100.0,
                                   "api.never_ran": 1.0}, registry=m)
    breaches = wd.evaluate()
    assert [(b["event"], b["span"]) for b in breaches] == [("slo_breach", "api.search")]
    assert breaches[0]["p99_ms"] > breaches[0]["threshold_ms"] == 100.0
    gauges = m.snapshot()["gauges"]
    assert 'slo.p99_ms{span="api.search"}' in gauges and 'slo.p99_ms{span="api.healthy"}' in gauges
    assert list(wd.events) == breaches
    assert wd.evaluate() == []  # no new samples: no re-alert
    m.observe("span.api.search.ms", 2.0)
    wd.evaluate()
    assert m.get("slo.breaches", labels={"span": "api.search"}) == 2


def test_watchdog_judges_each_role_separately(pkg):
    reg = pkg.Metrics()
    reg.observe("span.api.search.ms", 5.0)
    reg.observe("span.api.search.ms", 900.0, labels={"role": "edge2"})
    wd = pkg.watchdog.SloWatchdog({"api.search": 100.0}, registry=reg)
    breaches = wd.evaluate()
    assert [b["labels"] for b in breaches] == [{"role": "edge2"}]
    assert reg.get("slo.breaches", labels={"span": "api.search", "role": "edge2"}) == 1
    assert wd.evaluate() == []


def test_watchdog_passes_drive_the_shedding_ladder(pkg):
    """The listener the runner wires (`ladder.on_slo_pass`) hears every
    pass, breached or not."""
    reg = pkg.Metrics()
    reg.observe("span.api.search.ms", 900.0)
    wd = pkg.watchdog.SloWatchdog({"api.search": 100.0}, registry=reg)
    heard = []
    wd.add_listener(lambda breaches: heard.append(len(breaches)))
    wd.evaluate()
    wd.evaluate()
    assert heard == [1, 0]
