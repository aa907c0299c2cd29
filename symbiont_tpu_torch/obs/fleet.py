"""Fleet telemetry plane: cross-process metrics federation and trace
stitching over the bus.

Copy of the JAX package's `symbiont_tpu/obs/fleet.py`.

PR 10's ProcessSupervisor turned the deployment into real OS processes —
and quietly shrank the reach of the whole observability plane with it:
each runner process holds its own Metrics registry and TraceStore, only
the API-role process serves ``GET /metrics``, the supervisor's own
``procsup.*`` gauges live in a process with no HTTP server at all, and a
trace whose spans cross three processes is scattered across three ring
buffers no endpoint can see whole. This module closes that gap with two
halves riding the bus the deployment already has:

- ``TelemetryExporter`` (one per role, started by the runner and by the
  ProcessSupervisor for its own ``procsup.*`` gauges): a bounded periodic
  publisher of ``metrics.flat_snapshot()`` DELTAS on
  ``_sys.telemetry.metrics.<role>`` (every Nth publish is a full snapshot
  so a late-joining aggregator converges) and of completed span records on
  ``_sys.telemetry.spans.<role>`` (tapped off the flight recorder).
  Telemetry must never compete with the data path: the pending-span ring
  is bounded (overflow SAMPLED away and counted in ``fleet.spans_dropped``),
  oversized metric deltas are truncated-and-counted, and a publish failure
  is a counted skip, never a queue.
- ``FleetAggregator`` (hosted by the API-role process and the
  ProcessSupervisor): merges role snapshots into the federated
  ``GET /metrics`` exposition (every series labeled with the role that
  produced it — ``obs/prometheus.render_fleet``), feeds remote spans into
  the LOCAL TraceStore (stamped with ``role``/``pid`` fields) so
  ``GET /api/traces/<id>``, critical-path attribution, Chrome export (one
  process lane per role) and the SLO watchdog (per-role
  ``span.<name>.ms{role=}`` histograms) all work across process
  boundaries, and serves the ``GET /api/fleet`` roll-up (per-role
  up/heartbeat-age/restarts from the supervisor's ``procsup.*`` gauges
  plus key engine gauges).

Proven end-to-end by the ``load_multiproc`` bench tier: one client-carried
trace crossing >= 3 OS processes comes back as a single stitched tree with
a dominant-hop verdict, and every supervised role (broker probe and
``procsup.*`` included) appears in one exposition with a ``role`` label.

Layering: imports only the obs/trace_store + telemetry layers (and
subjects); the runner / procsup inject the bus.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.obs.trace_store import (
    SpanRecord,
    TraceStore,
    trace_store as _global_store,
)
from symbiont_tpu_torch.utils.telemetry import (
    Metrics,
    metrics as _global_metrics,
)

log = logging.getLogger(__name__)

# field key the aggregator stamps on every remote-fed span; the exporter's
# tap skips spans that carry it, so an aggregator+exporter process (the
# API role, the supervisor) never re-exports another role's spans in a loop
ROLE_FIELD = "role"
PID_FIELD = "pid"

# key-gauge prefixes surfaced in the GET /api/fleet roll-up per role (the
# operator's one-page deployment view; the full series stay on /metrics)
ROLLUP_GAUGE_PREFIXES = (
    "gauge.batcher.queue_depth",
    "gauge.batcher.tenant_depth",
    "gauge.lm.kv_rows_active",
    "gauge.lm.kv_rows_allocated",
    "gauge.admission.queued",
    "gauge.api.sse_clients",
    "gauge.lm.hbm_headroom_bytes",
    "counter.runner.heartbeats",
    "counter.bus.consumed",
    # OOM verdicts per role (obs/hbm.py forensics): a device allocator
    # failure anywhere in the fleet shows on the one-page roll-up
    "counter.engine.oom_total",
)
ROLLUP_MAX_SERIES = 32


class TelemetryExporter:
    """Per-role telemetry publisher (see module docstring). ``bus_fn``
    returns the live bus or None (the supervisor's bus reconnects; a None
    bus skips the round, it never queues)."""

    def __init__(self, bus_fn: Callable, role: str,
                 publish_s: float = 2.0, spans_max: int = 256,
                 pending_max: int = 2048, metrics_max: int = 4096,
                 full_every: int = 15,
                 registry: Optional[Metrics] = None,
                 store: Optional[TraceStore] = None):
        self.bus_fn = bus_fn
        self.role = role
        self.publish_s = max(0.05, float(publish_s))
        self.spans_max = max(1, int(spans_max))
        self.pending_max = max(1, int(pending_max))
        self.metrics_max = max(1, int(metrics_max))
        self.full_every = max(1, int(full_every))
        self.registry = registry if registry is not None else _global_metrics
        # `is not None`, never truthiness: an EMPTY TraceStore is falsy
        # (__len__ == 0) and would silently fall back to the global ring
        self.store = store if store is not None else _global_store
        self._pending: deque = deque()
        # tail-based retention, exporter half (docs/OBSERVABILITY.md "Tail
        # retention"): errored spans keep their OWN bounded pending ring so
        # a burst of healthy spans can never sample away the one span the
        # aggregator (and whoever reads the stitched trace) actually needs.
        # Bounded like everything here — errored overflow drops oldest
        # errored, counted in the same fleet.spans_dropped.
        self._pending_err: deque = deque(
            maxlen=max(1, min(256, self.pending_max)))
        self._pending_lock = threading.Lock()
        self._last_flat: Dict[str, float] = {}
        self._seq = 0
        self._trunc_cursor = 0  # rotating truncation window (see publish)
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        # families zero-registered up front so the doc-drift contract sees
        # them on every fleet-enabled boot, not only after the first drop
        for kind in ("metrics", "spans"):
            self.registry.inc("fleet.publishes", 0, labels={"kind": kind})
        self.registry.inc("fleet.publish_failures", 0)
        self.registry.inc("fleet.spans_dropped", 0)
        self.registry.inc("fleet.metrics_dropped", 0)
        self.store.add_tap(self._tap)
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name=f"fleet-exporter-{self.role}")

    async def stop(self) -> None:
        self.store.remove_tap(self._tap)
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # ------------------------------------------------------------- span tap

    def _tap(self, rec: SpanRecord) -> None:
        """Called on every local span exit (TraceStore tap). Remote-fed
        spans (ROLE_FIELD stamped by an aggregator in this process) are
        skipped — they belong to their origin role. Overflow is a counted
        drop: the newest spans win the bounded ring (sampling, not
        queueing)."""
        if rec.fields and ROLE_FIELD in rec.fields:
            return
        with self._pending_lock:
            if rec.status != "ok":
                # errored spans ride the retention ring: healthy churn
                # cannot displace them; only errored overflow evicts
                dropped = len(self._pending_err) == self._pending_err.maxlen
                self._pending_err.append(rec)
            elif len(self._pending) >= self.pending_max:
                self._pending.popleft()
                self._pending.append(rec)
                dropped = True
            else:
                self._pending.append(rec)
                dropped = False
        if dropped:
            self.registry.inc("fleet.spans_dropped")

    def _drain_spans(self) -> List[SpanRecord]:
        with self._pending_lock:
            # errored spans publish FIRST (they are the ones a breach
            # investigation needs stitched), healthy fill the remainder
            batch = [self._pending_err.popleft()
                     for _ in range(min(self.spans_max,
                                        len(self._pending_err)))]
            room = self.spans_max - len(batch)
            batch += [self._pending.popleft()
                      for _ in range(min(room, len(self._pending)))]
        return batch

    # -------------------------------------------------------------- publish

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.publish_s)
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # telemetry failures are counted, never fatal and never
                # retried into a queue — the next round re-snapshots
                self.registry.inc("fleet.publish_failures")
                log.debug("fleet telemetry publish failed", exc_info=True)

    async def publish_once(self) -> bool:
        """One export round: a metrics delta + up to spans_max pending
        spans. Returns False when no bus is available (counted skip)."""
        bus = self.bus_fn() if callable(self.bus_fn) else self.bus_fn
        if bus is None:
            self.registry.inc("fleet.publish_failures")
            return False
        flat = self.registry.flat_snapshot()
        self._seq += 1
        full = (self._seq % self.full_every) == 1 or self.full_every == 1
        delta = (dict(flat) if full else
                 {k: v for k, v in flat.items()
                  if self._last_flat.get(k) != v})
        candidates = set(delta)
        dropped_metrics = 0
        if len(delta) > self.metrics_max:
            # ROTATING window over the sorted candidates: under continuous
            # churn every round's delta is oversized, and a fixed sorted
            # prefix would starve alphabetically-late keys forever — the
            # cursor guarantees every key federates within
            # ceil(n / metrics_max) rounds regardless of churn
            keys = sorted(delta)
            start = self._trunc_cursor % len(keys)
            picked = [keys[(start + i) % len(keys)]
                      for i in range(self.metrics_max)]
            self._trunc_cursor = (start + self.metrics_max) % len(keys)
            dropped_metrics = len(delta) - self.metrics_max
            self.registry.inc("fleet.metrics_dropped", dropped_metrics)
            delta = {k: delta[k] for k in picked}
        payload = json.dumps({
            "role": self.role, "pid": os.getpid(), "seq": self._seq,
            "full": full, "ts": time.time(), "dropped": dropped_metrics,
            "metrics": delta,
        }).encode()
        await bus.publish(
            f"{subjects.SYS_TELEMETRY_METRICS}.{self.role}", payload)
        # baseline advances only after a successful publish — and only for
        # the keys actually SENT. A truncated key is REMOVED from the
        # baseline (not kept at its old value): a stable gauge truncated
        # out of a full snapshot would otherwise compare equal forever and
        # never re-enter any delta — removal makes the next round's delta
        # re-select exactly the dropped set, so successive rounds rotate
        # through an oversized registry until every key has federated.
        if dropped_metrics:
            new_base = dict(self._last_flat)
            new_base.update(delta)
            for k in candidates - set(delta):
                new_base.pop(k, None)
            self._last_flat = new_base
        else:
            self._last_flat = flat
        self.registry.inc("fleet.publishes", labels={"kind": "metrics"})

        batch = self._drain_spans()
        if batch:
            spans_payload = json.dumps({
                "role": self.role, "pid": os.getpid(), "ts": time.time(),
                "spans": [r.to_dict() for r in batch],
            }).encode()
            try:
                await bus.publish(
                    f"{subjects.SYS_TELEMETRY_SPANS}.{self.role}",
                    spans_payload)
            except BaseException:
                # the bus died between the two publishes: re-pend the
                # drained batch at the FRONT (bounded — overflow is a
                # counted drop, per the module contract) instead of
                # silently losing up to spans_max stitched hops. Errored
                # spans go back to their retention ring, healthy to the
                # sampled ring.
                errored = [r for r in batch if r.status != "ok"]
                healthy = [r for r in batch if r.status == "ok"]
                with self._pending_lock:
                    space = max(0, self.pending_max - len(self._pending))
                    # NB: healthy[-0:] is the WHOLE list — zero space must
                    # requeue nothing, not everything
                    requeue = (healthy if space >= len(healthy)
                               else healthy[-space:] if space else [])
                    lost = len(healthy) - len(requeue)
                    self._pending.extendleft(reversed(requeue))
                    err_space = (self._pending_err.maxlen
                                 - len(self._pending_err))
                    lost += max(0, len(errored) - err_space)
                    self._pending_err.extendleft(reversed(errored))
                if lost:
                    self.registry.inc("fleet.spans_dropped", lost)
                raise
            self.registry.inc("fleet.publishes", labels={"kind": "spans"})
        return True


class FleetAggregator:
    """Merge role telemetry into the local observability plane (see module
    docstring). ``attach(subs)`` spawns one pump task per subscription;
    ``handle()`` / ``merge_metrics()`` / ``merge_spans()`` are synchronous
    so the bench obs tier can measure the merge hot path directly."""

    def __init__(self, local_role: str = "",
                 store: Optional[TraceStore] = None,
                 registry: Optional[Metrics] = None,
                 max_roles: int = 64):
        self.local_role = local_role
        # same `is not None` stance as the exporter: an empty TraceStore
        # is falsy and must not alias the global ring
        self.store = store if store is not None else _global_store
        self.registry = registry if registry is not None else _global_metrics
        self.max_roles = max(1, int(max_roles))
        self._roles: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._tasks: List[asyncio.Task] = []
        self._subs: list = []
        # doc-drift contract: families exist from boot
        for kind in ("metrics", "spans"):
            self.registry.inc("fleet.merges", 0, labels={"kind": kind})
        self.registry.inc("fleet.remote_spans", 0)
        self.registry.inc("fleet.role_overflow", 0)
        self.registry.gauge_set("fleet.roles", 0)

    # ------------------------------------------------------------ lifecycle

    def attach(self, subs: list) -> None:
        """Adopt bus subscriptions (``_sys.telemetry.metrics.>`` and
        ``_sys.telemetry.spans.>``); re-attaching (the supervisor after a
        bus reconnect) cancels the previous pumps."""
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        self._subs = list(subs)

        async def pump(sub) -> None:
            async for msg in sub:
                try:
                    self.handle(msg.subject, msg.data)
                except Exception:
                    log.debug("fleet telemetry merge failed", exc_info=True)

        self._tasks = [asyncio.create_task(pump(s), name="fleet-aggregator")
                       for s in self._subs]

    async def detach(self) -> None:
        for s in self._subs:
            try:
                s.close()
            except Exception:
                pass
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        self._subs = []

    # --------------------------------------------------------------- merges

    def handle(self, subject: str, data: bytes) -> None:
        """Route one telemetry message by its subject."""
        metrics_prefix = subjects.SYS_TELEMETRY_METRICS + "."
        spans_prefix = subjects.SYS_TELEMETRY_SPANS + "."
        if subject.startswith(metrics_prefix):
            role, kind = subject[len(metrics_prefix):], "metrics"
        elif subject.startswith(spans_prefix):
            role, kind = subject[len(spans_prefix):], "spans"
        else:
            return
        if not role or role == self.local_role:
            return  # the local registry/ring is already the fresher view
        obj = json.loads(data)
        if kind == "metrics":
            self.merge_metrics(role, obj)
        else:
            self.merge_spans(role, obj)

    def _role_state(self, role: str) -> Optional[dict]:
        with self._lock:
            st = self._roles.get(role)
            if st is None:
                if len(self._roles) >= self.max_roles:
                    self.registry.inc("fleet.role_overflow")
                    return None
                st = self._roles[role] = {"metrics": {}, "pid": None,
                                          "ts": 0.0, "seq": 0}
                self.registry.gauge_set("fleet.roles", len(self._roles))
            return st

    def merge_metrics(self, role: str, obj: dict) -> None:
        st = self._role_state(role)
        if st is None:
            return
        delta = obj.get("metrics") or {}
        with self._lock:
            if obj.get("full"):
                st["metrics"] = dict(delta)
            else:
                st["metrics"].update(delta)
            st["pid"] = obj.get("pid")
            st["seq"] = obj.get("seq", 0)
            st["ts"] = time.time()
        self.registry.inc("fleet.merges", labels={"kind": "metrics"})

    def merge_spans(self, role: str, obj: dict) -> None:
        st = self._role_state(role)
        if st is None:
            return
        pid = obj.get("pid")
        n = 0
        for sd in obj.get("spans") or []:
            try:
                fields = dict(sd.get("fields") or {})
                fields[ROLE_FIELD] = role
                if pid is not None:
                    fields.setdefault(PID_FIELD, pid)
                rec = SpanRecord(
                    trace_id=str(sd["trace_id"]),
                    span_id=str(sd["span_id"]),
                    parent_id=sd.get("parent_id"),
                    name=str(sd["name"]),
                    start_s=float(sd["start_ms"]) / 1000.0,
                    duration_ms=float(sd["duration_ms"]),
                    status=str(sd.get("status", "ok")),
                    fields=fields)
            except (KeyError, TypeError, ValueError):
                continue  # one malformed span must not drop the batch
            self.store.record(rec)
            # per-role span histograms: the SLO watchdog judges each role's
            # latency separately (histogram_summaries), and the federated
            # exposition shows them role-labeled — never blended cross-role
            self.registry.observe(f"span.{rec.name}.ms", rec.duration_ms,
                                  labels={"role": role},
                                  exemplar={"trace_id": rec.trace_id})
            n += 1
        if n:
            self.registry.inc("fleet.remote_spans", n)
        self.registry.inc("fleet.merges", labels={"kind": "spans"})

    # -------------------------------------------------------------- surface

    def role_snapshots(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {role: dict(st["metrics"])
                    for role, st in self._roles.items()}

    def render_exposition(self, openmetrics: bool = False) -> str:
        """The federated ``GET /metrics`` body: local registry under
        ``role=<local_role>`` plus every remote role's snapshot, one family
        table (obs/prometheus.render_fleet)."""
        from symbiont_tpu_torch.obs import prometheus

        return prometheus.render_fleet(self.local_role,
                                       self.role_snapshots(),
                                       registry=self.registry,
                                       openmetrics=openmetrics)

    def rollup(self) -> dict:
        """The ``GET /api/fleet`` body: one entry per role — telemetry
        freshness, pid, supervisor verdicts (``procsup.*`` found in
        whichever role's snapshot carries them — the supervisor exports its
        own registry under its role), and a bounded set of key gauges."""
        now = time.time()
        roles: Dict[str, dict] = {}

        def entry(role: str) -> dict:
            return roles.setdefault(role, {"metrics": {}})

        with self._lock:
            states = {r: (dict(st["metrics"]), st["pid"], st["ts"],
                          st["seq"]) for r, st in self._roles.items()}
        # the local process is a role too (telemetry age 0 by definition)
        local_flat = self.registry.flat_snapshot()
        if self.local_role:
            states[self.local_role] = (local_flat, os.getpid(), now, -1)
        for role, (flat, pid, ts, _seq) in states.items():
            e = entry(role)
            e["pid"] = pid
            e["telemetry_age_s"] = round(max(0.0, now - ts), 2)
            picked = 0
            for k in sorted(flat):
                if picked >= ROLLUP_MAX_SERIES:
                    break
                if any(k.startswith(p) for p in ROLLUP_GAUGE_PREFIXES):
                    e["metrics"][k] = flat[k]
                    picked += 1
            # supervisor verdicts fold into the TARGET role's entry
            for k, v in flat.items():
                parsed = _parse_procsup_key(k)
                if parsed is None:
                    continue
                stat, target = parsed
                entry(target)[stat] = v
        return {"generated_at": round(now, 3),
                "local_role": self.local_role,
                "roles": roles}


_PROCSUP_STATS = {"gauge": ("up", "heartbeat_age_s", "draining",
                            "crashlooped"),
                  "counter": ("restarts", "hangs", "scale_out", "scale_in",
                              "drain_timeouts")}


def _parse_procsup_key(key: str):
    """``gauge.procsup.up{role="embed"}`` → ("up", "embed"); None for
    everything else. Covers up / heartbeat_age_s / draining / crashlooped
    gauges and restarts / hangs / scale_out / scale_in / drain_timeouts
    counters — the supervisor-side liveness + elastic-scaling verdicts
    the roll-up folds into each supervised role's entry (broker probe
    included). One key grammar, one parser: prometheus.parse_flat_key."""
    from symbiont_tpu_torch.obs.prometheus import parse_flat_key

    parsed = parse_flat_key(key)
    if parsed is None:
        return None
    kind, name, labels, stat = parsed
    if stat is not None or not name.startswith("procsup."):
        return None
    verdict = name[len("procsup."):]
    if verdict not in _PROCSUP_STATS.get(kind, ()):
        return None
    role = labels.get("role")
    return (verdict, role) if role else None


async def subscribe_telemetry(bus) -> list:
    """The two wildcard subscriptions an aggregator pumps (one per
    telemetry kind — each subject constant keeps both a producer and a
    consumer, the wiring contract tests/test_pipeline_wiring.py scans
    for)."""
    return [
        await bus.subscribe(subjects.SYS_TELEMETRY_METRICS + ".>"),
        await bus.subscribe(subjects.SYS_TELEMETRY_SPANS + ".>"),
    ]
