"""Tracing + metrics — the observability layer the reference lacks.

Copy of the JAX package's `symbiont_tpu/utils/telemetry.py`; `maybe_profile`
runs `torch.profiler` where the JAX package runs `jax.profiler`.

Reference state (SURVEY.md §5.1/§5.5): bare env_logger lines with bracket tags,
ids carried only inside payloads, NATS monitoring port exposed but unscraped,
zero counters. Here:

- Trace: every message carries trace/span ids in bus headers
  (X-Trace-Id/X-Span-Id); `child_headers` propagates across hops; `span`
  times a handler, logs a structured line, AND appends a SpanRecord to the
  process-global flight recorder (obs/trace_store.py) so
  `GET /api/traces/<id>` can reassemble the full pipeline tree.
- Metrics: process-global registry of counters, histograms (p50/p95/p99 +
  exact running min/max), and gauges (set/add, plus callback gauges read at
  scrape time). All three kinds take optional `{label: value}` labels —
  rendered as JSON (api /api/metrics) and as Prometheus text exposition
  (api /metrics, obs/prometheus.py).

Span-id semantics (the contract the trace tree depends on): the X-Span-Id
header names the ACTIVE span — the one under which a message was published.
`span()` mints its own id with the header's id as parent and exposes its own
context at `handle.headers`; `child_headers` PROPAGATES the active context
unchanged (a bus hop is an edge, not a span). The service base loop hands
each handler a message rebound to the handler span's context, so every
downstream publish links to it (services/base.py).
"""

from __future__ import annotations

import bisect
import itertools
import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

from symbiont_tpu_torch.obs.trace_store import SpanRecord, trace_store
from symbiont_tpu_torch.utils.ids import generate_uuid

log = logging.getLogger("symbiont.trace")

TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"
# Overload-protection plane (resilience/admission.py): the request deadline
# (absolute unix epoch MILLISECONDS, minted at the API edge) and the tenant
# identity ride the same bus-header channel as the trace context, and
# child_headers threads them across every hop — a downstream service drops
# expired work BEFORE its handler runs (services/base.py).
DEADLINE_HEADER = "X-Symbiont-Deadline"
TENANT_HEADER = "X-Symbiont-Tenant"

# headers child_headers carries verbatim beyond the trace pair
_THREADED_HEADERS = (DEADLINE_HEADER, TENANT_HEADER)


def new_trace_headers() -> Dict[str, str]:
    return {TRACE_HEADER: generate_uuid(), SPAN_HEADER: generate_uuid()}


def child_headers(parent: Optional[Dict[str, str]]) -> Dict[str, str]:
    """Propagate the active trace context; start a new trace without one.

    The span id is carried over VERBATIM (it names the publishing span):
    the receiving handler's span records it as parent_id, which is what
    links hops into one tree. (Pre-obs versions minted a fresh span id per
    hop — an id that no recorded span owned, so trees could never link.)

    Deadline/tenant headers (the admission plane's channel) thread through
    verbatim too: a deadline minted at the API edge must reach the LAST hop
    of the pipeline, or expired work is only droppable at the first."""
    if not parent or TRACE_HEADER not in parent:
        out = new_trace_headers()
    else:
        out = {TRACE_HEADER: parent[TRACE_HEADER]}
        if SPAN_HEADER in parent:
            out[SPAN_HEADER] = parent[SPAN_HEADER]
    if parent:
        for h in _THREADED_HEADERS:
            if h in parent:
                out[h] = parent[h]
    return out


_profile_lock = threading.Lock()
_profile_seq = itertools.count()

# flight-recorder trace id for skipped-profile markers (obs/device.py owns
# the compile-event twin; duplicated as a literal here to keep this module
# importable below the whole obs layer)
_PROFILE_TRACE_ID = "profiler"


@contextmanager
def maybe_profile(name: str):
    """Profile the wrapped call into `$SYMBIONT_PROFILE_DIR` (one Chrome
    trace per call, `<name>.<pid>.<n>.json`, from `torch.profiler` over the
    CPU and, where there is one, the CUDA device), or do nothing when the
    variable is unset. One profile runs at a time: a call that finds one
    running goes on unprofiled, counts `profile.skipped{name}` and leaves a
    `profile.skipped` span in the flight recorder (trace id "profiler"); a
    profiled call counts `profile.captured{name}`."""
    import os

    d = os.environ.get("SYMBIONT_PROFILE_DIR")
    if not d:
        yield
        return
    if not _profile_lock.acquire(blocking=False):
        metrics.inc("profile.skipped", labels={"name": name})
        t0 = time.perf_counter()
        start_s = time.time()
        try:
            yield
        finally:
            trace_store.record(SpanRecord(
                trace_id=_PROFILE_TRACE_ID, span_id=generate_uuid(),
                parent_id=None, name="profile.skipped", start_s=start_s,
                duration_ms=(time.perf_counter() - t0) * 1000.0,
                status="ok", fields={"target": name}))
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        metrics.inc("profile.captured", labels={"name": name})
        with profile(activities=activities) as prof:
            with record_function(name):
                yield
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(d, f"{name}.{os.getpid()}.{next(_profile_seq)}.json"))
    finally:
        _profile_lock.release()


class SpanHandle:
    """Live-span context yielded by `span()`. `headers` is the context to
    publish downstream messages under (same trace, THIS span as the active
    id); `fields` may be extended while the span is open and lands on the
    flight-recorder record."""

    __slots__ = ("trace_id", "span_id", "parent_id", "fields")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], fields: dict):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.fields = fields

    @property
    def headers(self) -> Dict[str, str]:
        return {TRACE_HEADER: self.trace_id, SPAN_HEADER: self.span_id}


@contextmanager
def span(name: str, headers: Optional[Dict[str, str]] = None, **fields):
    """Timed span: structured log line + `span.<name>.ms` histogram + a
    SpanRecord in the flight recorder. Errors are accounted, not swallowed:
    status lands on the record (queryable via /api/traces) and
    `span.<name>.errors` increments before the exception propagates."""
    t0 = time.perf_counter()
    start_s = time.time()
    ctx = headers or {}
    trace_id = ctx.get(TRACE_HEADER) or generate_uuid()
    handle = SpanHandle(trace_id, generate_uuid(), ctx.get(SPAN_HEADER),
                        dict(fields))
    status = "ok"
    try:
        yield handle
    except BaseException as e:
        status = "error"
        handle.fields.setdefault("error", type(e).__name__)
        metrics.inc(f"span.{name}.errors")
        raise
    finally:
        dur_ms = (time.perf_counter() - t0) * 1000
        # the trace id rides along as an exemplar: a bad histogram bucket
        # on /metrics links straight to a concrete flight-recorder trace
        metrics.observe(f"span.{name}.ms", dur_ms,
                        exemplar={"trace_id": trace_id})
        trace_store.record(SpanRecord(
            trace_id=trace_id, span_id=handle.span_id,
            parent_id=handle.parent_id, name=name, start_s=start_s,
            duration_ms=dur_ms, status=status, fields=handle.fields))
        log.info(json.dumps({"span": name, "trace": trace_id,
                             "status": status,
                             "duration_ms": round(dur_ms, 3),
                             **handle.fields}, ensure_ascii=False,
                            default=str))


# default cumulative-bucket bounds for span-duration histograms, in ms
# (Prometheus `le` upper bounds; +Inf is implicit). Chosen to straddle the
# measured pipeline: sub-ms bus hops up through multi-second cold compiles.
# Override per process via ObsConfig.histogram_buckets_ms (runner applies
# Metrics.set_bucket_bounds at boot — BEFORE traffic; bounds are fixed per
# histogram at first observation, rebucketing recorded data is impossible).
DEFAULT_BUCKET_BOUNDS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                            500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class _Histogram:
    __slots__ = ("values", "count", "total", "vmin", "vmax",
                 "bounds", "bucket_counts", "exemplars")

    def __init__(self, bounds: tuple = DEFAULT_BUCKET_BOUNDS_MS) -> None:
        self.values: list = []  # sorted reservoir (bounded)
        self.count = 0
        self.total = 0.0
        # exact running extremes: the reservoir decimation below drops
        # alternating samples (including, half the time, the true min) and
        # truncates tails — min/max must not ride the lossy reservoir
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        # real Prometheus histogram state: exact per-bucket counts (the
        # reservoir's quantiles cannot be aggregated across processes;
        # `_bucket`/`le` series can) + the latest exemplar seen per bucket
        # (value, {label: v}, unix ts) — a bad bucket links to a concrete
        # flight-recorder trace
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.bucket_counts: list = [0] * (len(self.bounds) + 1)
        self.exemplars: list = [None] * (len(self.bounds) + 1)

    def observe(self, v: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        # non-cumulative bucket index; bisect_left keeps `le` INCLUSIVE
        # (v == bound counts in that bound's bucket, Prometheus semantics)
        b = bisect.bisect_left(self.bounds, v)
        self.bucket_counts[b] += 1
        if exemplar:
            self.exemplars[b] = (v, dict(exemplar), time.time())
        bisect.insort(self.values, v)
        if len(self.values) > 4096:
            # drop alternating samples to stay bounded but keep the shape
            del self.values[::2]

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        idx = min(len(self.values) - 1, int(q * len(self.values)))
        return self.values[idx]

    def cumulative_buckets(self) -> list:
        """[(le_bound, cumulative_count), ...] ending with ("+Inf", count)."""
        out, running = [], 0
        for bound, n in zip(self.bounds, self.bucket_counts):
            running += n
            out.append((bound, running))
        out.append(("+Inf", running + self.bucket_counts[-1]))
        return out

    def summary(self) -> dict:
        return {"count": self.count,
                "sum": self.total,  # exact running total (renderers must
                                    # not reconstruct it as mean*count)
                "mean": self.total / self.count if self.count else 0.0,
                "min": self.vmin if self.vmin is not None else 0.0,
                "max": self.vmax if self.vmax is not None else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "buckets": self.cumulative_buckets(),
                "exemplars": list(self.exemplars)}


# label set normalized to a sorted tuple: one canonical key per
# (name, labels) pair regardless of caller dict ordering
_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_key(name: str, lk: _LabelKey) -> str:
    if not lk:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in lk)
    return f"{name}{{{inner}}}"


class Metrics:
    """Counters + histograms + gauges, each optionally labeled.

    Gauges come in two flavors: value gauges (`gauge_set`/`gauge_add` — e.g.
    live SSE clients) and callback gauges (`register_gauge` — evaluated at
    scrape time, e.g. batcher queue depth). A callback returning None (or
    raising) is dropped from the registry: callbacks close over weakrefs of
    engine/batcher instances, and a dead instance must disappear from the
    scrape instead of pinning the object or poisoning the snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], _Histogram] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauge_fns: Dict[Tuple[str, _LabelKey], Callable] = {}
        self._bucket_bounds: Tuple[float, ...] = DEFAULT_BUCKET_BOUNDS_MS

    def set_bucket_bounds(self, bounds) -> None:
        """Cumulative-bucket upper bounds (`le`) for histograms created
        AFTER this call — existing histograms keep theirs (recorded samples
        cannot be rebucketed). The runner applies ObsConfig
        .histogram_buckets_ms here at boot, before traffic."""
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b <= 0 for b in bounds) \
                or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                "bucket bounds must be positive, strictly increasing and "
                f"non-empty, got {bounds!r}")
        with self._lock:
            self._bucket_bounds = bounds

    # ------------------------------------------------------------- counters

    def inc(self, name: str, n: float = 1,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0)

    # ----------------------------------------------------------- histograms

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        """`exemplar` is a tiny label dict (by convention `{"trace_id":
        ...}`) attached to the bucket this sample lands in — rendered as an
        OpenMetrics exemplar so a bad bucket links to a flight-recorder
        trace."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram(self._bucket_bounds)
            h.observe(value, exemplar=exemplar)

    def histogram_summary(self, name: str,
                          labels: Optional[Dict[str, str]] = None
                          ) -> Optional[dict]:
        with self._lock:
            h = self._hists.get((name, _label_key(labels)))
            return h.summary() if h is not None else None

    def histogram_summaries(self, name: str) -> list:
        """Every labeled variant of one histogram family:
        [(labels_dict, summary), ...]. The SLO watchdog judges each variant
        separately — remote-role span durations federated by the fleet
        plane (obs/fleet.py) land as `{role: ...}`-labeled histograms, and
        a breach in ONE role must not hide inside a fleet-wide blend."""
        with self._lock:
            found = [(dict(lk), h.summary())
                     for (n, lk), h in self._hists.items() if n == name]
        return found

    # --------------------------------------------------------------- gauges

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[(name, _label_key(labels))] = value

    def gauge_add(self, name: str, delta: float,
                  labels: Optional[Dict[str, str]] = None) -> float:
        key = (name, _label_key(labels))
        with self._lock:
            v = self._gauges.get(key, 0) + delta
            self._gauges[key] = v
            return v

    def gauge_get(self, name: str,
                  labels: Optional[Dict[str, str]] = None) -> float:
        key = (name, _label_key(labels))
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            fn = self._gauge_fns.get(key)
        if fn is None:
            return 0
        evaluated = self._eval_gauge_fns({key: fn})
        return evaluated.get(key, 0)

    def register_gauge(self, name: str, fn: Callable,
                       labels: Optional[Dict[str, str]] = None) -> None:
        """Callback gauge, read at scrape time. Re-registering the same
        (name, labels) replaces the callback (a fresh engine instance takes
        over its predecessor's gauge)."""
        with self._lock:
            self._gauge_fns[(name, _label_key(labels))] = fn

    def register_weakref_gauge(self, name: str, obj, reader: Callable,
                               labels: Optional[Dict[str, str]] = None
                               ) -> None:
        """Callback gauge bound to `obj` WITHOUT pinning it: the registry
        holds a weakref, `reader(obj)` produces the value, and when the
        owner dies (or the reader signals retirement by returning None) the
        gauge unregisters itself at the next scrape. The one place the
        owner-lifecycle contract lives — engine/batcher/LM gauges all go
        through here."""
        import weakref

        ref = weakref.ref(obj)

        def fn():
            o = ref()
            return None if o is None else reader(o)

        self.register_gauge(name, fn, labels=labels)

    def unregister_gauge(self, name: str,
                         labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauge_fns.pop((name, _label_key(labels)), None)

    def _eval_gauge_fns(self, fns: Dict) -> Dict:
        """Evaluate callback gauges OUTSIDE the registry lock (a callback may
        take an engine/batcher lock; holding ours too invites ordering
        deadlocks). A callback returning None is retired (the weakref-death
        convention); one that RAISES is skipped for this scrape but kept —
        a transient error (e.g. a racing collection mutation) must not
        silently delete a gauge for the life of the process."""
        out, dead = {}, []
        for key, fn in fns.items():
            try:
                v = fn()
            except Exception:
                log.debug("callback gauge %s failed this scrape", key[0],
                          exc_info=True)
                continue
            if v is None:
                dead.append(key)
            else:
                out[key] = v
        if dead:
            with self._lock:
                for key in dead:
                    self._gauge_fns.pop(key, None)
        return out

    # ------------------------------------------------------------ rendering

    def export(self) -> dict:
        """Structured dump for renderers: kind → [(name, labels-dict,
        value-or-summary)]. Callback gauges are evaluated here."""
        with self._lock:
            counters = list(self._counters.items())
            hists = [(k, h.summary()) for k, h in self._hists.items()]
            gauges = list(self._gauges.items())
            fns = dict(self._gauge_fns)
        gauges += list(self._eval_gauge_fns(fns).items())
        return {
            "counters": [(n, dict(lk), v) for (n, lk), v in counters],
            "histograms": [(n, dict(lk), s) for (n, lk), s in hists],
            "gauges": [(n, dict(lk), v) for (n, lk), v in gauges],
        }

    def snapshot(self) -> dict:
        """JSON-shaped view (api /api/metrics; BASELINE.md numbers). Labeled
        series render as `name{k="v"}` keys; unlabeled keep their bare name
        (the shape every pre-obs consumer knows)."""
        ex = self.export()
        return {
            "counters": {_render_key(n, _label_key(lb)): v
                         for n, lb, v in ex["counters"]},
            # exemplars (trace-id samples) are an exposition-format detail;
            # the JSON view keeps stats + buckets only
            "histograms": {_render_key(n, _label_key(lb)):
                           {k: v for k, v in s.items() if k != "exemplars"}
                           for n, lb, s in ex["histograms"]},
            "gauges": {_render_key(n, _label_key(lb)): v
                       for n, lb, v in ex["gauges"]},
        }

    def flat_snapshot(self) -> Dict[str, float]:
        """One flat string→number dict (archived into bench JSON so
        BENCH_*.json carries the internal gauges, not just external
        timings). Histograms contribute count/p50/p99/min/max."""
        snap = self.snapshot()
        flat: Dict[str, float] = {}
        for k, v in snap["counters"].items():
            flat[f"counter.{k}"] = v
        for k, v in snap["gauges"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                flat[f"gauge.{k}"] = float(v)
        for k, s in snap["histograms"].items():
            for stat in ("count", "p50", "p99", "min", "max"):
                flat[f"hist.{k}.{stat}"] = float(s[stat])
        return flat

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._gauges.clear()
            self._gauge_fns.clear()


metrics = Metrics()
