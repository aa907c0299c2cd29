"""Flight-recorder span store: a bounded in-process ring buffer of finished

Copy of the JAX package's `symbiont_tpu/obs/trace_store.py`.
spans, queryable by trace id.

The pre-existing telemetry layer wrote spans as structured log LINES — fine
for grepping one hop, useless for answering "where did this submit→embed→
upsert pipeline spend its time" without log aggregation infrastructure. This
store keeps the last N span records in memory (a flight recorder, not a
tracing backend: bounded, lossy under sustained overload, zero dependencies)
and reassembles parent-linked trees on demand for ``GET /api/traces/<id>``
and ``GET /api/traces/recent``.

No symbiont imports here: ``utils/telemetry`` writes into this module on
every span exit, and anything above telemetry may read from it.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SpanRecord:
    """One finished span. ``parent_id`` is the span id of the enclosing
    span (same process) or of the publishing hop's handler span (across the
    bus, via the X-Span-Id header) — None for roots."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start_s: float          # wall clock (time.time) at span entry
    duration_ms: float
    status: str             # "ok" | "error"
    fields: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": round(self.start_s * 1000.0, 3),
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
            "fields": self.fields,
        }


class TraceStore:
    """Thread-safe bounded ring of SpanRecords, with tail-based retention.

    Lookup scans the ring (capacity is a few thousand records; a scan is
    microseconds) instead of maintaining a per-trace index — the ring is the
    single source of truth, so eviction can never leave a stale index entry
    behind.

    Tail-based retention (the FIFO ring's worst production flaw fixed):
    under sustained load a plain ring evicts oldest-first, which is
    *exactly* the errored and slow traces an operator opens the recorder
    for — an error happens, a burst of healthy traffic follows, and the
    evidence is gone before anyone looks. Three pin triggers copy a
    trace's spans into a bounded KEEP-SET that ring churn cannot touch:

    - any span with ``status != "ok"`` pins its trace;
    - a ROOT span in the slowest decile of recent roots pins its trace
      (streaming p90 over a bounded window);
    - an explicit :meth:`pin` call — the SLO watchdog pins the exemplar
      traces of every breached histogram bucket (obs/watchdog.py).

    The keep-set holds at most ``keep_traces`` traces (oldest pinned trace
    evicted first, counted) x ``keep_spans`` spans each. Healthy traces
    additionally SAMPLE at ``sample_rate`` (a per-trace decision — 1.0
    keeps the historical record-everything behavior; 0.1 keeps every 10th
    new trace, while pinned traces always record). Query surfaces merge
    ring + keep-set, so an errored trace demonstrably survives churn that
    evicts every healthy neighbor (pinned in tests)."""

    def __init__(self, capacity: int = 4096, sample_rate: float = 1.0,
                 keep_traces: int = 64, keep_spans: int = 512):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        # taps: fn(SpanRecord) called on every record() AFTER the ring
        # append, outside the lock (a tap may touch the metrics registry;
        # holding our lock across foreign locks invites ordering
        # deadlocks). The fleet exporter (obs/fleet.py) taps here to ship
        # finished spans to the aggregator; a tap that raises is dropped
        # from this record only, never unregistered.
        self._taps: list = []
        # ---- tail-based retention state ----
        self._sample_rate = float(sample_rate)
        self._keep_traces = max(1, int(keep_traces))
        self._keep_spans = max(1, int(keep_spans))
        # trace_id -> [SpanRecord] pinned copies (insertion order = LRU)
        self._pinned: "OrderedDict[str, List[SpanRecord]]" = OrderedDict()
        # per-trace sampling decisions (bounded; oldest forgotten first)
        self._decisions: "OrderedDict[str, bool]" = OrderedDict()
        self._sample_acc = 0.0
        # streaming slow-decile detector over recent ROOT span durations:
        # a sorted window (bisect) paired with a FIFO of the same values
        self._root_sorted: List[float] = []
        self._root_fifo: deque = deque(maxlen=256)
        # counters surfaced as obs.trace_* gauges by the runner
        self.sampled_out = 0
        self.pin_evictions = 0

    def configure_retention(self, sample_rate: float = 1.0,
                            keep_traces: int = 64,
                            keep_spans: int = 512) -> None:
        """Apply ObsConfig retention knobs (runner, at boot)."""
        with self._lock:
            self._sample_rate = float(sample_rate)
            self._keep_traces = max(1, int(keep_traces))
            self._keep_spans = max(1, int(keep_spans))
            while len(self._pinned) > self._keep_traces:
                self._pinned.popitem(last=False)
                self.pin_evictions += 1

    def pinned_traces(self) -> int:
        with self._lock:
            return len(self._pinned)

    def pin(self, trace_id: str) -> None:
        """Pin one trace into the keep-set: its spans already in the ring
        are copied now, and every future span of the trace joins them
        regardless of ring churn or sampling. Idempotent; unknown ids
        create an (empty) pin that future spans fill."""
        if not trace_id:
            return
        with self._lock:
            self._pin_locked(trace_id)

    def _pin_locked(self, trace_id: str) -> None:
        if trace_id in self._pinned:
            self._pinned.move_to_end(trace_id)
            return
        spans = [r for r in self._ring if r.trace_id == trace_id]
        self._pinned[trace_id] = spans[-self._keep_spans:]
        while len(self._pinned) > self._keep_traces:
            self._pinned.popitem(last=False)
            self.pin_evictions += 1

    def _sampled(self, trace_id: str) -> bool:
        """Per-trace healthy-sampling decision: a deterministic fractional
        accumulator (error-diffusion — no randomness, replayable under
        seeds, and EVERY rate in (0, 1) keeps exactly that long-run
        fraction of new traces; an integer period would quantize 0.75 to
        keep-everything). Pinned traces bypass sampling entirely."""
        if self._sample_rate >= 1.0:
            return True
        known = self._decisions.get(trace_id)
        if known is not None:
            self._decisions.move_to_end(trace_id)
            return known
        self._sample_acc += self._sample_rate
        keep = self._sample_acc >= 1.0
        if keep:
            self._sample_acc -= 1.0
        self._decisions[trace_id] = keep
        while len(self._decisions) > 4 * (self._ring.maxlen or 1):
            self._decisions.popitem(last=False)
        return keep

    def _note_root_duration(self, rec: SpanRecord) -> bool:
        """Streaming slowest-decile detector: insert this root's duration
        into the bounded window and report whether it sits at/above the
        window's p90 (with >= 32 samples of evidence)."""
        if len(self._root_fifo) == self._root_fifo.maxlen:
            gone = self._root_fifo.popleft()
            i = bisect.bisect_left(self._root_sorted, gone)
            if i < len(self._root_sorted):
                del self._root_sorted[i]
        self._root_fifo.append(rec.duration_ms)
        bisect.insort(self._root_sorted, rec.duration_ms)
        n = len(self._root_sorted)
        if n < 32:
            return False
        # STRICTLY above the p90: uniform traffic (every root the same
        # duration) must pin nothing — ties with the threshold are the
        # common case, not the tail
        return rec.duration_ms > self._root_sorted[int(0.9 * n)]

    def add_tap(self, fn) -> None:
        with self._lock:
            if fn not in self._taps:
                self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        with self._lock:
            if fn in self._taps:
                self._taps.remove(fn)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring, keeping the newest records (runner applies
        ObsConfig.trace_capacity at boot)."""
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            pinned = self._pinned.get(rec.trace_id)
            if pinned is not None:
                # a pinned trace's future spans join the keep-set directly
                # (bounded) — churn and sampling cannot touch them
                if len(pinned) < self._keep_spans:
                    pinned.append(rec)
                self._pinned.move_to_end(rec.trace_id)
                self._ring.append(rec)
                if rec.parent_id is None:
                    self._note_root_duration(rec)
            else:
                sampled = self._sampled(rec.trace_id)
                if sampled:
                    self._ring.append(rec)
                else:
                    self.sampled_out += 1
                # pin triggers AFTER the append so the pin copy sees this
                # span: an errored span pins its trace (even when sampling
                # dropped the trace's earlier spans — a partial trace is
                # still evidence); a slowest-decile ROOT pins the same way
                slow_root = (rec.parent_id is None
                             and self._note_root_duration(rec))
                if rec.status != "ok" or slow_root:
                    self._pin_locked(rec.trace_id)
                    kept = self._pinned.get(rec.trace_id)
                    if (kept is not None and not sampled
                            and len(kept) < self._keep_spans):
                        # the trigger span itself was sampled out of the
                        # ring — the keep-set must still carry it
                        kept.append(rec)
            taps = list(self._taps) if self._taps else None
        if taps:
            for fn in taps:
                try:
                    fn(rec)
                except Exception:
                    pass  # a broken tap must never break span recording

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pinned.clear()
            self._decisions.clear()
            self._root_sorted = []
            self._root_fifo.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ---------------------------------------------------------------- query

    @staticmethod
    def _merge(pinned: List[SpanRecord],
               ring: List[SpanRecord]) -> List[SpanRecord]:
        """Pinned copies + ring records, deduped by span id (a pinned
        trace's recent spans live in both), insertion order preserved."""
        if not pinned:
            return ring
        seen = {r.span_id for r in pinned}
        return pinned + [r for r in ring if r.span_id not in seen]

    def spans_for(self, trace_id: str) -> List[SpanRecord]:
        with self._lock:
            pinned = list(self._pinned.get(trace_id, ()))
            ring = [r for r in self._ring if r.trace_id == trace_id]
        return self._merge(pinned, ring)

    def spans_by_trace(self) -> Dict[str, List[SpanRecord]]:
        """ONE ring pass grouping every record by trace id (insertion
        order preserved: oldest-recorded trace first; keep-set traces
        merged in — a pinned errored trace stays visible to recent() and
        the stage aggregator no matter how hard the ring churned). Bulk
        consumers use this instead of per-trace spans_for() scans —
        O(traces × ring) rescans under the record() lock would stall live
        span exits."""
        with self._lock:
            records = list(self._ring)
            pinned = {tid: list(spans) for tid, spans in self._pinned.items()}
        out: Dict[str, List[SpanRecord]] = {}
        for tid, spans in pinned.items():
            out[tid] = spans
        for r in records:
            if r.trace_id in pinned:
                if all(r.span_id != p.span_id for p in pinned[r.trace_id]):
                    out[r.trace_id].append(r)
            else:
                out.setdefault(r.trace_id, []).append(r)
        return out

    def trace_tree(self, trace_id: str) -> Optional[dict]:
        """Reassemble the parent-linked span tree for one trace. Returns
        None when the ring holds nothing for this trace id."""
        return tree_from_spans(trace_id, self.spans_for(trace_id))

    def recent(self, limit: int = 20) -> List[dict]:
        """Trace summaries for the flight-recorder window, errored traces
        first, then slowest-first — the triage order an operator wants."""
        by_trace = self.spans_by_trace()
        summaries = []
        for trace_id, spans in by_trace.items():
            t0 = min(r.start_s for r in spans)
            t1 = max(r.start_s + r.duration_ms / 1000.0 for r in spans)
            errors = sum(1 for r in spans if r.status != "ok")
            root = min(spans, key=lambda r: r.start_s)
            summaries.append({
                "trace_id": trace_id,
                "root": root.name,
                "span_count": len(spans),
                "error_count": errors,
                "services": sorted({r.name.split(".", 1)[0] for r in spans}),
                "duration_ms": round((t1 - t0) * 1000.0, 3),
                "start_ms": round(t0 * 1000.0, 3),
            })
        summaries.sort(key=lambda s: (-(s["error_count"] > 0),
                                      -s["duration_ms"]))
        return summaries[: max(0, int(limit))]


def tree_from_spans(trace_id: str,
                    spans: List[SpanRecord]) -> Optional[dict]:
    """Parent-linked span tree from one trace's records (sorts the given
    list in place).

    Spans whose parent was never recorded (evicted from the ring, or a
    context hop through a process that doesn't record spans — e.g. the
    native C++ workers) surface as top-level roots rather than being
    dropped: a partial trace is still a trace. Returns None for an empty
    span list."""
    if not spans:
        return None
    spans.sort(key=lambda r: r.start_s)
    ids = {r.span_id for r in spans}
    nodes: Dict[str, dict] = {}
    for r in spans:
        node = r.to_dict()
        node["children"] = []
        # duplicate span ids cannot happen (uuid per span), but a
        # defensive setdefault keeps the tree well-formed regardless
        nodes.setdefault(r.span_id, node)
    roots: List[dict] = []
    for r in spans:
        node = nodes[r.span_id]
        if r.parent_id is not None and r.parent_id in ids:
            nodes[r.parent_id]["children"].append(node)
        else:
            roots.append(node)
    t0 = min(r.start_s for r in spans)
    t1 = max(r.start_s + r.duration_ms / 1000.0 for r in spans)
    return {
        "trace_id": trace_id,
        "span_count": len(spans),
        "error_count": sum(1 for r in spans if r.status != "ok"),
        "services": sorted({r.name.split(".", 1)[0] for r in spans}),
        "duration_ms": round((t1 - t0) * 1000.0, 3),
        "start_ms": round(t0 * 1000.0, 3),
        "roots": roots,
    }


# process-global flight recorder (one per process, like the metrics registry)
trace_store = TraceStore()
