"""Metrics registry and the profiler hook of the port.

The port's own copy of `symbiont_tpu/utils/telemetry.py`'s `Metrics` and
`maybe_profile`, so the engine's series read as they do on the JAX side:

- `Metrics`: counters, histograms (p50/p95/p99, exact running min/max,
  cumulative `le` buckets with exemplars) and gauges (set/add, callback
  gauges read at scrape time, weakref gauges that retire with their owner),
  each optionally labeled; `export` and `snapshot` render it. `metrics`
  is the process-global registry the engine writes to. It is an object
  of its own, apart from the JAX package's registry.
- `maybe_profile(name)`: when `SYMBIONT_PROFILE_DIR` is set, the wrapped
  call runs under `torch.profiler` (CPU and, where there is one, the CUDA
  device) and a Chrome trace lands in that directory; otherwise a no-op.

Trace spans, the flight recorder and trace headers come with the stack on
the port (ROADMAP Queue A, item 8).
"""

from __future__ import annotations

import bisect
import itertools
import logging
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

log = logging.getLogger(__name__)

_profile_lock = threading.Lock()
_profile_seq = itertools.count()


@contextmanager
def maybe_profile(name: str):
    """Profile the wrapped call into `$SYMBIONT_PROFILE_DIR` (one Chrome
    trace per call, `<name>.<pid>.<n>.json`), or do nothing when the
    variable is unset. One profile runs at a time: a call that finds one
    running goes on unprofiled and counts `profile.skipped{name}`; a
    profiled call counts `profile.captured{name}`."""
    d = os.environ.get("SYMBIONT_PROFILE_DIR")
    if not d:
        yield
        return
    if not _profile_lock.acquire(blocking=False):
        metrics.inc("profile.skipped", labels={"name": name})
        yield
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


# default cumulative-bucket bounds for histograms, in ms (Prometheus `le`
# upper bounds; +Inf is implicit)
DEFAULT_BUCKET_BOUNDS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                            500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class _Histogram:
    __slots__ = ("values", "count", "total", "vmin", "vmax",
                 "bounds", "bucket_counts", "exemplars")

    def __init__(self, bounds: tuple = DEFAULT_BUCKET_BOUNDS_MS) -> None:
        self.values: list = []  # sorted reservoir (bounded)
        self.count = 0
        self.total = 0.0
        # exact running extremes: the reservoir's decimation may drop them
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.bucket_counts: list = [0] * (len(self.bounds) + 1)
        self.exemplars: list = [None] * (len(self.bounds) + 1)

    def observe(self, v: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        # bisect_left keeps `le` inclusive (Prometheus semantics)
        b = bisect.bisect_left(self.bounds, v)
        self.bucket_counts[b] += 1
        if exemplar:
            self.exemplars[b] = (v, dict(exemplar), time.time())
        bisect.insort(self.values, v)
        if len(self.values) > 4096:
            del self.values[::2]  # drop alternate samples, keep the shape

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        return self.values[min(len(self.values) - 1, int(q * len(self.values)))]

    def cumulative_buckets(self) -> list:
        """[(le_bound, cumulative_count), ...] ending with ("+Inf", count)."""
        out, running = [], 0
        for bound, n in zip(self.bounds, self.bucket_counts):
            running += n
            out.append((bound, running))
        out.append(("+Inf", running + self.bucket_counts[-1]))
        return out

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count if self.count else 0.0,
                "min": self.vmin if self.vmin is not None else 0.0,
                "max": self.vmax if self.vmax is not None else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "buckets": self.cumulative_buckets(),
                "exemplars": list(self.exemplars)}


# a label set as a sorted tuple: one key per (name, labels) pair
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

    Value gauges (`gauge_set`/`gauge_add`) hold a number; callback gauges
    (`register_gauge`) are evaluated at scrape time. A callback returning
    None is retired from the registry (a weakref gauge whose owner died);
    one that raises is skipped for that scrape and kept."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], _Histogram] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauge_fns: Dict[Tuple[str, _LabelKey], Callable] = {}

    # ------------------------------------------------------------- counters

    def inc(self, name: str, n: float = 1,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def get(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0)

    # ----------------------------------------------------------- histograms

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram()
            h.observe(value, exemplar=exemplar)

    def histogram_summary(self, name: str,
                          labels: Optional[Dict[str, str]] = None) -> Optional[dict]:
        with self._lock:
            h = self._hists.get((name, _label_key(labels)))
            return h.summary() if h is not None else None

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

    def gauge_get(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        key = (name, _label_key(labels))
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            fn = self._gauge_fns.get(key)
        if fn is None:
            return 0
        return self._eval_gauge_fns({key: fn}).get(key, 0)

    def register_gauge(self, name: str, fn: Callable,
                       labels: Optional[Dict[str, str]] = None) -> None:
        """Callback gauge, read at scrape time; re-registering the same
        (name, labels) replaces the callback."""
        with self._lock:
            self._gauge_fns[(name, _label_key(labels))] = fn

    def register_weakref_gauge(self, name: str, obj, reader: Callable,
                               labels: Optional[Dict[str, str]] = None) -> None:
        """Callback gauge bound to `obj` without keeping it alive: the value
        is `reader(obj)`, and the gauge retires once `obj` is gone."""
        ref = weakref.ref(obj)

        def fn():
            o = ref()
            return None if o is None else reader(o)

        self.register_gauge(name, fn, labels=labels)

    def _eval_gauge_fns(self, fns: Dict) -> Dict:
        # callbacks run outside the registry lock: one may take an engine lock
        out, dead = {}, []
        for key, fn in fns.items():
            try:
                v = fn()
            except Exception:
                log.debug("callback gauge %s failed this scrape", key[0], exc_info=True)
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
        """kind → [(name, labels dict, value or summary)]; callback gauges
        are evaluated here."""
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
        """JSON-shaped view: labeled series as `name{k="v"}` keys."""
        ex = self.export()
        return {
            "counters": {_render_key(n, _label_key(lb)): v for n, lb, v in ex["counters"]},
            "histograms": {_render_key(n, _label_key(lb)):
                           {k: v for k, v in s.items() if k != "exemplars"}
                           for n, lb, s in ex["histograms"]},
            "gauges": {_render_key(n, _label_key(lb)): v for n, lb, v in ex["gauges"]},
        }


metrics = Metrics()
