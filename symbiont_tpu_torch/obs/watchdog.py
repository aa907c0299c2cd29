"""SLO watchdog: periodic p99 evaluation over the span histograms.

Copy of the JAX package's `symbiont_tpu/obs/watchdog.py`.

The flight recorder answers "what happened to THIS request"; the watchdog
answers "is the pipeline meeting its latency objectives AT ALL" — without an
external alerting stack. The runner starts one task when
``obs.slo_p99_ms`` is configured (entries like ``"api.search=500"``); every
interval it reads each named span's p99 from the metrics registry and, on
breach, emits a structured warning event: a JSON log line, an
``slo.breaches{span=}`` counter, and a bounded in-memory event list (the
last ``max_events`` breaches, queryable by tests/operators via
``watchdog.events``). Evaluated p99s are exported as ``slo.p99_ms{span=}``
gauges whether breached or not, so dashboards see the margin, not just the
violation.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from typing import Dict, List, Optional

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

log = logging.getLogger("symbiont.slo")


def parse_thresholds(entries: List[str]) -> Dict[str, float]:
    """``["api.search=500", "preprocessing.handle=2000"]`` → {span: p99_ms}.
    Raises ValueError on malformed entries — a typo'd SLO must fail at boot,
    not silently never fire."""
    out: Dict[str, float] = {}
    for entry in entries:
        name, sep, raw = entry.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"SLO threshold {entry!r} must look like 'span.name=p99_ms'")
        try:
            limit = float(raw)
        except ValueError:
            raise ValueError(
                f"SLO threshold {entry!r}: {raw!r} is not a number") from None
        if limit <= 0:
            raise ValueError(f"SLO threshold {entry!r} must be positive")
        out[name] = limit
    return out


class SloWatchdog:
    def __init__(self, thresholds: Dict[str, float],
                 interval_s: float = 10.0,
                 registry: Optional[Metrics] = None,
                 max_events: int = 256,
                 burn_fast_s: float = 60.0, burn_slow_s: float = 600.0,
                 store=None):
        self.thresholds = dict(thresholds)
        self.interval_s = max(0.1, float(interval_s))
        self.registry = registry or _global_metrics
        self.events: deque = deque(maxlen=max_events)
        self._task: Optional[asyncio.Task] = None
        # observation count at the last evaluation, per (span, label
        # variant): an idle span must not re-alert every interval off the
        # same old samples
        self._seen_counts: Dict[tuple, int] = {}
        # two-window burn rates (multiwindow SRE shape): every judged pass
        # outcome lands in a per-variant (ts, breached) history; breach
        # events carry the breach FRACTION over the fast and slow windows
        # so a consumer (the elastic autoscaler's SLO signal) can tell a
        # blip (fast high, slow low) from a sustained burn (both high)
        self.burn_fast_s = float(burn_fast_s)
        self.burn_slow_s = float(burn_slow_s)
        self._outcomes: Dict[tuple, deque] = {}
        # tail-based retention hook: breached buckets' exemplar traces pin
        # into the flight recorder's keep-set (obs/trace_store.py) so the
        # evidence behind an SLO breach survives ring churn
        if store is None:
            from symbiont_tpu_torch.obs.trace_store import trace_store as store
        self.store = store
        # pass listeners: fn(breaches) called at the END of every
        # evaluation — with the empty list too, which is what lets the
        # admission shed ladder (resilience/admission.DegradationLadder)
        # count breach-free passes toward stepping back down
        self.listeners: list = []

    def add_listener(self, fn) -> None:
        """Subscribe fn(breaches: list[dict]) to every evaluation pass.
        The watchdog was observe-only before the overload-protection
        plane; listeners are how breaches now ACT (shed ladder)."""
        self.listeners.append(fn)

    def evaluate(self) -> List[dict]:
        """One evaluation pass; returns the breach events it emitted.
        Synchronous so tests (and one-shot CLI checks) can drive it without
        an event loop.

        The judged p99 is over the span histogram's process lifetime (the
        registry keeps no windows), with one guard: a span that received NO
        new observations since the last pass is skipped, so a single old
        outlier cannot alert every interval forever. The flip side — a
        fresh regression diluted under a long healthy history crosses the
        cumulative p99 late — is the accepted flight-recorder trade
        (documented in docs/OBSERVABILITY.md); windowed histograms are the
        upgrade path if it bites."""
        breaches: List[dict] = []
        for span_name, limit_ms in self.thresholds.items():
            # every labeled variant is judged separately: the fleet plane
            # (obs/fleet.py) federates remote roles' span durations as
            # `span.<name>.ms{role=...}` histograms, and a breach in ONE
            # role must not hide inside a fleet-wide blend — the unlabeled
            # local series stays variant () and behaves exactly as before
            variants = self.registry.histogram_summaries(
                f"span.{span_name}.ms")
            for labels, summary in variants:
                if not summary["count"]:
                    continue  # span never ran: nothing to judge
                seen_key = (span_name,
                            tuple(sorted(labels.items())))
                if summary["count"] == self._seen_counts.get(seen_key):
                    continue  # idle since last pass: no fresh evidence
                self._seen_counts[seen_key] = summary["count"]
                p99 = summary["p99"]
                self.registry.gauge_set("slo.p99_ms", p99,
                                        labels={"span": span_name, **labels})
                breached = p99 > limit_ms
                fast, slow = self._note_outcome(seen_key, breached)
                self.registry.gauge_set(
                    "slo.burn_rate_fast", fast,
                    labels={"span": span_name, **labels})
                self.registry.gauge_set(
                    "slo.burn_rate_slow", slow,
                    labels={"span": span_name, **labels})
                if not breached:
                    continue
                event = {
                    "event": "slo_breach",
                    "span": span_name,
                    "p99_ms": round(p99, 3),
                    "threshold_ms": limit_ms,
                    "count": summary["count"],
                    # two-window burn rates: the autoscaler's blip-vs-burn
                    # discriminator (fast high + slow low = transient;
                    # both high = sustained — scale, don't flap)
                    "burn_rate_fast": fast,
                    "burn_rate_slow": slow,
                    "ts": time.time(),
                }
                if labels:
                    event["labels"] = dict(labels)
                self.registry.inc("slo.breaches",
                                  labels={"span": span_name, **labels})
                self._pin_exemplars(summary, limit_ms)
                self.events.append(event)
                breaches.append(event)
                log.warning(json.dumps(event, ensure_ascii=False))
        for fn in list(self.listeners):
            try:
                fn(breaches)
            except Exception:
                # listeners act on breaches (shedding); a broken one must
                # not take the watchdog down with it
                log.exception("SLO pass listener failed")
        return breaches

    def _note_outcome(self, key: tuple, breached: bool) -> tuple:
        """Record one judged pass outcome and return the (fast, slow)
        breach fractions over the two windows. Bounded history: entries
        past the slow window are dropped eagerly."""
        now = time.time()
        hist = self._outcomes.setdefault(key, deque())
        hist.append((now, breached))
        horizon = now - self.burn_slow_s
        while hist and hist[0][0] < horizon:
            hist.popleft()

        def rate(window_s: float) -> float:
            cut = now - window_s
            judged = [b for ts, b in hist if ts >= cut]
            if not judged:
                return 0.0
            return round(sum(judged) / len(judged), 4)

        return rate(self.burn_fast_s), rate(self.burn_slow_s)

    def _pin_exemplars(self, summary: dict, limit_ms: float) -> None:
        """Pin the BREACHING buckets' exemplar traces into the flight
        recorder's keep-set: the concrete slow requests behind a breach
        must survive the ring churn the breach itself causes. Only
        exemplars whose observed value exceeds the threshold pin — the
        histogram keeps one exemplar per bucket including the fast ones,
        and pinning those would churn healthy traces through the bounded
        keep-set, evicting exactly the evidence it protects."""
        for ex in summary.get("exemplars") or ():
            if not ex:
                continue
            try:
                value, labels = float(ex[0]), ex[1]
                trace_id = labels.get("trace_id")
            except (AttributeError, IndexError, TypeError, ValueError):
                continue
            if trace_id and value > limit_ms:
                try:
                    self.store.pin(trace_id)
                except Exception:
                    log.debug("exemplar pin failed", exc_info=True)

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.evaluate()
            except Exception:
                # the watchdog observes; it must never take the stack down
                log.exception("SLO evaluation failed")

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="slo-watchdog")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
