"""Circuit breaker for the external store backends.

Copy of the JAX package's `symbiont_tpu/resilience/breaker.py`.

`utils/retry.py` covers startup connects; this covers the mid-run outage a
heavy-traffic deployment guarantees (ROADMAP north-star): after
`failure_threshold` consecutive failures the breaker OPENS and callers fail
fast (or degrade — see resilience/stores.py for the WAL-spill policy)
instead of stacking `retries x delay` blocking waits in the executor pool.
After `reset_timeout_s` one probe call is let through (HALF-OPEN); success
closes the breaker, failure re-opens it for another window.

State is exported as gauges so the PR-2 observability plane can prove the
degradation story: `breaker.state{name=...}` (0 closed / 1 half-open /
2 open), plus `breaker.opened`/`breaker.failures`/`breaker.fast_fail`
counters. Thread-safe: store calls run in executor threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple, Type

from symbiont_tpu_torch.utils.telemetry import metrics

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(ConnectionError):
    """Raised (fast, no network wait) when a call is refused by an open
    breaker. Subclasses ConnectionError so existing except-clauses around
    store calls treat it like the outage it represents."""

    def __init__(self, name: str, retry_in_s: float):
        super().__init__(
            f"circuit breaker {name!r} is open (probe in {retry_in_s:.1f}s)")
        self.breaker_name = name
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s <= 0:
            raise ValueError("reset_timeout_s must be positive")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock  # injectable for deterministic tests
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._export()

    # ------------------------------------------------------------ state api

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _export(self) -> None:
        metrics.gauge_set("breaker.state", _STATE_GAUGE[self._state],
                          labels={"name": self.name})

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = HALF_OPEN
            self._probe_inflight = False
            self._export()

    def allow(self) -> bool:
        """True if a call may proceed. In HALF-OPEN exactly one in-flight
        probe is admitted; everyone else keeps failing fast until the probe
        settles."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._state = CLOSED
                metrics.inc("breaker.closed", labels={"name": self.name})
            self._export()

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            metrics.inc("breaker.failures", labels={"name": self.name})
            self._probe_inflight = False
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.failure_threshold):
                self._state = OPEN
                self._opened_at = self._clock()
                metrics.inc("breaker.opened", labels={"name": self.name})
            self._export()

    def retry_in_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_timeout_s
                       - (self._clock() - self._opened_at))

    # ------------------------------------------------------------- wrapping

    def call(self, fn: Callable, *args,
             fatal: Tuple[Type[BaseException], ...] = (), **kwargs):
        """Run fn through the breaker: refuse fast when open, record the
        outcome otherwise. Exceptions in `fatal` (config errors — retrying
        or tripping the breaker cannot fix them) propagate without counting
        as a breaker failure."""
        if not self.allow():
            metrics.inc("breaker.fast_fail", labels={"name": self.name})
            raise CircuitOpenError(self.name, self.retry_in_s())
        try:
            out = fn(*args, **kwargs)
        except fatal:
            with self._lock:
                self._probe_inflight = False
            raise
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
