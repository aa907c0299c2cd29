"""Overload-protection plane: admission control, deadlines, SLO shedding.

Copy of the JAX package's `symbiont_tpu/resilience/admission.py`.

The resilience plane (streams/DLQ/breakers) makes the pipeline survive
FAULTS; this module makes it survive LOAD. Four cooperating pieces, all
wired at the API edge (services/api.py) and the service base
(services/base.py), proven under chaos by bench/load.py:

- `TokenBucket` + `AdmissionController` — per-tenant quotas per request
  class (ingest / search / generate). Tenant identity comes from the
  `X-Symbiont-Tenant` HTTP header (default tenant otherwise); an exhausted
  bucket is answered 429-with-Retry-After at the edge instead of queuing
  unboundedly. One hot tenant is clamped to its quota; everyone else keeps
  theirs.
- `WeightedFairQueue` — bounded per-tenant wait queues over a shared
  concurrency budget (stride scheduling by configured weights): when the
  search path saturates, slots hand out fairly across tenants instead of
  FIFO across the hot tenant's backlog; a full tenant queue rejects (429),
  never grows.
- deadline helpers — an `X-Symbiont-Deadline` header (absolute unix epoch
  ms) minted at the edge and threaded through every bus hop by
  `telemetry.child_headers`; `expired()` lets `Service._run_handler` drop
  dead work BEFORE the handler runs: counted as `admission.expired{service}`,
  ACKED on durable streams (never retried, never quarantined as poison —
  expiry is the caller giving up, not the handler failing).
- `DegradationLadder` — SLO-aware shedding driven by SloWatchdog breach
  passes (obs/watchdog.py listeners), with breaker-style hysteresis (dwell
  time both directions + N consecutive healthy passes to step down, so an
  oscillating breach cannot flap the level). Rungs: shed lowest-priority
  generation first, then degrade search (clamped top-k, rerank skipped).
  Ingest acks are NEVER shed — losing accepted data is worse than slow data.

Everything takes an injectable clock so tests assert refill/hysteresis
timing exactly; nothing here imports jax or any service module.
"""

from __future__ import annotations

import asyncio
import math
import time
from collections import deque
from typing import Callable, Dict, Optional

from symbiont_tpu_torch.utils.telemetry import (
    DEADLINE_HEADER,
    TENANT_HEADER,
    metrics,
)

DEFAULT_TENANT = "default"

# the shared identity every tenant beyond AdmissionConfig.max_tenants maps
# to: the X-Symbiont-Tenant header is CLIENT-supplied, so without a bound an
# attacker minting a fresh tenant per request would get a fresh full-burst
# bucket every time (quota bypass) while growing buckets / fair-queue state /
# metric label cardinality without limit — the exact unbounded-growth-under-
# overload this plane exists to prevent
OVERFLOW_TENANT = "(overflow)"

# request classes the controller quotas independently
CLASSES = ("ingest", "search", "generate")

# generation priorities (X-Symbiont-Priority); unknown values → "normal"
PRIORITIES = ("low", "normal", "high")


class AdmissionReject(Exception):
    """Raised when a request must be answered 429: quota exhausted, fair
    queue full, or capacity/shed refusal. Carries the Retry-After hint and
    a bounded-cardinality reason label for `admission.*` counters."""

    def __init__(self, reason: str, retry_after_s: float = 1.0,
                 message: str = ""):
        super().__init__(message or reason)
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))


# ------------------------------------------------------------ token buckets


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst`. Injectable
    clock; no background task — tokens materialize lazily at take time."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will have refilled (the Retry-After
        hint a 429 carries)."""
        self._refill()
        deficit = n - self._tokens
        return max(0.0, deficit / self.rate)


# ------------------------------------------------------- stride scheduling


class StrideClock:
    """The stride-scheduling core shared by the edge fair queue and the
    engine batcher's tenant lanes: each grant charges the tenant's
    virtual time by 1/weight, and the pending tenant with the SMALLEST
    effective virtual time goes next. The global clock (`vnow`) follows
    EVERY grant so a tenant active while uncontended banks no virtual
    lateness, and a tenant returning from idle starts at the current floor
    instead of its stale past time (no burst catch-up) — both behaviors
    are regression-pinned by tests/test_admission.py."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._vtime: Dict[str, float] = {}
        self._vnow = 0.0  # floor for tenants returning from idle

    def _weight(self, tenant: str) -> float:
        return max(1e-6, float(self.weights.get(tenant,
                                                self.default_weight)))

    def effective(self, tenant: str) -> float:
        """The virtual time a grant to `tenant` would happen at."""
        return max(self._vtime.get(tenant, 0.0), self._vnow)

    def pick(self, tenants) -> Optional[str]:
        """The pending tenant that goes next (smallest effective virtual
        time; name breaks exact ties deterministically). None when empty."""
        best = None
        for t in tenants:
            key = (self.effective(t), t)
            if best is None or key < best:
                best = key
        return None if best is None else best[1]

    def charge(self, tenant: str) -> None:
        """Record one grant: advance the global clock to the grant's
        virtual time and push the tenant's next entitlement out by
        1/weight."""
        v = self.effective(tenant)
        self._vnow = v
        self._vtime[tenant] = v + 1.0 / self._weight(tenant)

    def forget(self, tenant: str) -> None:
        """Drop a drained tenant's bookkeeping once it carries at most ONE
        grant of debt — after a tenant's last grant its vtime sits exactly
        1/weight past the floor, so an at-the-floor-only condition would
        never fire and the dict would grow with every identity ever seen.
        Erasing ≤ one grant of lateness is the same forgiveness the
        idle-return floor already grants (effective() clamps to vnow)."""
        if (self._vtime.get(tenant, 0.0)
                <= self._vnow + 1.0 / self._weight(tenant)):
            self._vtime.pop(tenant, None)

    def snapshot(self) -> "StrideClock":
        """Cheap copy for non-mutating fair-order walks."""
        c = StrideClock(self.weights, self.default_weight)
        c._vtime = dict(self._vtime)
        c._vnow = self._vnow
        return c


# ------------------------------------------------------- weighted-fair queue


class WeightedFairQueue:
    """Bounded per-tenant wait queues over a shared concurrency budget.

    Stride scheduling: each grant charges the tenant's virtual time by
    1/weight; the pending tenant with the SMALLEST virtual time is served
    next, so a tenant with weight 4 gets 4 slots for every 1 a weight-1
    tenant gets — and a hot tenant's deep backlog can never starve a light
    tenant (the light tenant's next request always has an earlier virtual
    time than the hot tenant's Nth). A tenant whose queue is full rejects
    immediately (`AdmissionReject("queue_full")`) — bounded memory, shed
    instead of unbounded growth.

    Event-loop-only state (no locks): acquire/release run on the loop.
    """

    def __init__(self, concurrency: int = 32, max_queue: int = 64,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        if concurrency < 1 or max_queue < 1:
            raise ValueError("concurrency and max_queue must be >= 1")
        self.concurrency = concurrency
        self.max_queue = max_queue
        # the stride core is shared with the engine batcher's tenant lanes
        # (engine/batcher.TenantLanes) — one scheduling policy, two planes
        self._clock = StrideClock(weights, default_weight)
        self._free = concurrency
        self._waiting: Dict[str, deque] = {}

    @property
    def weights(self) -> Dict[str, float]:
        return self._clock.weights

    def queued(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return len(self._waiting.get(tenant, ()))
        return sum(len(q) for q in self._waiting.values())

    async def acquire(self, tenant: str) -> None:
        if self._free > 0 and not self._waiting:
            self._free -= 1
            self._charge(tenant)
            return
        q = self._waiting.setdefault(tenant, deque())
        if len(q) >= self.max_queue:
            metrics.inc("admission.queue_rejected",
                        labels={"tenant": tenant})
            raise AdmissionReject(
                "queue_full", retry_after_s=1.0,
                message=f"tenant {tenant!r} fair-queue is full "
                        f"({self.max_queue} waiting)")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        q.append(fut)
        metrics.gauge_set("admission.queued", self.queued())
        try:
            await fut
        except asyncio.CancelledError:
            # caller gave up while queued: withdraw, or hand the slot back
            # if the grant raced the cancellation
            if fut in q:
                q.remove(fut)
                if not q:
                    # an empty deque left mapped would park the uncontended
                    # fast path forever (acquire checks `not self._waiting`)
                    # with no slot holder left to ever run _grant
                    del self._waiting[tenant]
            elif fut.cancelled() is False and fut.done():
                self.release(tenant)
            raise
        finally:
            metrics.gauge_set("admission.queued", self.queued())

    def _charge(self, tenant: str) -> None:
        # returning-from-idle tenants start at the current floor (no burst
        # catch-up), and the global clock follows EVERY grant, fast-path
        # ones included: a tenant active while the queue was empty must not
        # bank virtual lateness that lets later contenders monopolize the
        # slots (and starve it into queue_full 429s) until they catch up —
        # both behaviors live in StrideClock.charge now
        self._clock.charge(tenant)

    def release(self, tenant: str) -> None:
        self._free += 1
        self._grant()

    def _grant(self) -> None:
        while self._free > 0:
            tenant = self._clock.pick(
                t for t, q in self._waiting.items() if q)
            if tenant is None:
                return
            q = self._waiting[tenant]
            fut = q.popleft()
            if not q:
                del self._waiting[tenant]
            if fut.done():  # cancelled while queued
                continue
            self._free -= 1
            self._charge(tenant)
            fut.set_result(None)


# -------------------------------------------------------------- controller


class AdmissionController:
    """Per-tenant token-bucket quotas per request class + the shared
    weighted-fair queue for the search concurrency budget. Built from
    `AdmissionConfig` (config.py) by the runner; owned by the API service.

    Buckets are created lazily per (tenant, class) — tenant cardinality is
    whatever the deployment sends, so the label space is operator-bounded,
    not framework-bounded."""

    def __init__(self, cfg=None, clock: Callable[[], float] = time.monotonic):
        from symbiont_tpu_torch.config import AdmissionConfig

        self.cfg = cfg or AdmissionConfig()
        self._clock = clock
        self._buckets: Dict[tuple, TokenBucket] = {}
        self.fair_queue = WeightedFairQueue(
            concurrency=self.cfg.search_concurrency,
            max_queue=self.cfg.max_queue_per_tenant,
            weights=parse_weights(self.cfg.fair_weights))
        # distinct tenant identities this controller will track (see
        # resolve_tenant / OVERFLOW_TENANT)
        self._seen_tenants: set = {DEFAULT_TENANT}

    def resolve_tenant(self, tenant: str) -> str:
        """Bound the tenant universe: known tenants (seen before, or named
        in fair_weights — i.e. operator-configured) resolve to themselves;
        once max_tenants distinct identities exist, every NEW one shares
        the overflow identity, its single set of buckets, and its one fair
        queue — so minting fresh tenant headers stops buying fresh burst
        budgets and stops growing state."""
        if (tenant in self._seen_tenants
                or tenant in self.fair_queue.weights):
            return tenant
        if len(self._seen_tenants) >= self.cfg.max_tenants:
            metrics.inc("admission.tenant_overflow")
            return OVERFLOW_TENANT
        self._seen_tenants.add(tenant)
        return tenant

    def _bucket(self, tenant: str, klass: str) -> TokenBucket:
        key = (tenant, klass)
        b = self._buckets.get(key)
        if b is None:
            rate = getattr(self.cfg, f"{klass}_rate")
            burst = getattr(self.cfg, f"{klass}_burst")
            b = self._buckets[key] = TokenBucket(rate, burst,
                                                clock=self._clock)
        return b

    def admit(self, klass: str, tenant: str) -> None:
        """One admission decision at the edge. Raises AdmissionReject
        (→ 429 + Retry-After) on quota exhaustion; counts both outcomes."""
        if klass not in CLASSES:
            raise ValueError(f"unknown admission class {klass!r}")
        bucket = self._bucket(tenant, klass)
        if bucket.try_take():
            metrics.inc("admission.admitted",
                        labels={"class": klass, "tenant": tenant})
            return
        metrics.inc("admission.throttled",
                    labels={"class": klass, "tenant": tenant})
        raise AdmissionReject(
            "quota", retry_after_s=bucket.retry_after_s(),
            message=f"tenant {tenant!r} over its {klass} quota")


def parse_weights(spec: str) -> Dict[str, float]:
    """`"gold=4,free=1"` → {"gold": 4.0, "free": 1.0}. Raises ValueError on
    malformed entries — a typo'd weight must fail at boot, not silently
    weight 1."""
    out: Dict[str, float] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, raw = entry.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"fair weight {entry!r} must look like 'tenant=weight'")
        try:
            w = float(raw)
        except ValueError:
            raise ValueError(
                f"fair weight {entry!r}: {raw!r} is not a number") from None
        if w <= 0:
            raise ValueError(f"fair weight {entry!r} must be positive")
        out[name.strip()] = w
    return out


# ---------------------------------------------------------------- deadlines


def mint_deadline(budget_ms: float, headers: Optional[dict] = None,
                  clock: Callable[[], float] = time.time) -> Optional[str]:
    """The edge's deadline header value: now + budget, tightened by any
    client-supplied deadline (a client promising less time wins; a client
    promising MORE cannot extend the operator's budget). budget <= 0
    disables minting (a client deadline still passes through)."""
    client = parse_deadline_ms(headers)
    if budget_ms <= 0:
        return None if client is None else str(int(client))
    minted = clock() * 1000.0 + budget_ms
    if client is not None:
        minted = min(minted, client)
    return str(int(minted))


def parse_deadline_ms(headers: Optional[dict]) -> Optional[float]:
    """The absolute epoch-ms deadline out of a (bus or lowercased HTTP)
    header dict; None when absent or unparseable (garbage must not make
    work immortal OR instantly dead — it is simply no deadline)."""
    if not headers:
        return None
    raw = headers.get(DEADLINE_HEADER) or headers.get(DEADLINE_HEADER.lower())
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def expired(headers: Optional[dict],
            clock: Callable[[], float] = time.time) -> bool:
    dl = parse_deadline_ms(headers)
    return dl is not None and clock() * 1000.0 > dl


def remaining_ms(headers: Optional[dict],
                 clock: Callable[[], float] = time.time) -> Optional[float]:
    dl = parse_deadline_ms(headers)
    return None if dl is None else dl - clock() * 1000.0


def tenant_of(headers: Optional[dict]) -> str:
    """Tenant identity from a (bus or lowercased HTTP) header dict."""
    if not headers:
        return DEFAULT_TENANT
    raw = (headers.get(TENANT_HEADER)
           or headers.get(TENANT_HEADER.lower()) or "")
    raw = raw.strip()
    return raw or DEFAULT_TENANT


def retry_after_header(seconds: float) -> Dict[str, str]:
    """RFC-shaped Retry-After (integer seconds, rounded up, minimum 1)."""
    return {"Retry-After": str(max(1, math.ceil(seconds)))}


# --------------------------------------------------------- shedding ladder


class DegradationLadder:
    """SLO-aware shedding with breaker-style hysteresis.

    Driven by SloWatchdog evaluation passes (`watchdog.add_listener(
    ladder.on_slo_pass)`): a pass with ≥1 breach escalates one rung (at
    most once per `hold_s` dwell window); stepping DOWN needs
    `recovery_passes` consecutive breach-free passes AND the dwell time —
    so an oscillating breach (breach, clear, breach, ...) parks the ladder
    at its current rung instead of flapping.

    Rungs (never touching ingest — accepted data is never shed):
      0  normal
      1  shed lowest-priority generation (`X-Symbiont-Priority: low`)
      2  shed all non-high generation AND degrade search: top-k clamped to
         `degraded_top_k`, cross-encoder rerank skipped
    """

    MAX_LEVEL = 2
    RUNGS = ("normal", "shed_gen_low", "degrade_search")

    def __init__(self, recovery_passes: int = 3, hold_s: float = 5.0,
                 degraded_top_k: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if recovery_passes < 1:
            raise ValueError("recovery_passes must be >= 1")
        self.recovery_passes = recovery_passes
        self.hold_s = float(hold_s)
        self.degraded_top_k = int(degraded_top_k)
        self._clock = clock
        self.level = 0
        self._healthy = 0
        self._last_change = clock() - self.hold_s  # first breach acts now
        metrics.gauge_set("admission.level", 0)

    def on_slo_pass(self, breaches) -> None:
        self.observe(bool(breaches))

    def observe(self, breached: bool) -> None:
        """One watchdog evaluation outcome. Idempotent per pass."""
        now = self._clock()
        if breached:
            self._healthy = 0
            if (self.level < self.MAX_LEVEL
                    and now - self._last_change >= self.hold_s):
                self.level += 1
                self._last_change = now
                metrics.inc("admission.level_changes",
                            labels={"direction": "up"})
        else:
            self._healthy += 1
            if (self.level > 0 and self._healthy >= self.recovery_passes
                    and now - self._last_change >= self.hold_s):
                self.level -= 1
                self._last_change = now
                self._healthy = 0
                metrics.inc("admission.level_changes",
                            labels={"direction": "down"})
        metrics.gauge_set("admission.level", self.level)

    # ------------------------------------------------------------- queries

    def shed_generation(self, priority: str = "normal") -> Optional[str]:
        """The shed reason when a generation request must be refused at the
        current rung, else None. high priority is only ever shed by quota /
        capacity, never by the ladder."""
        if priority not in PRIORITIES:
            priority = "normal"
        if self.level >= 2 and priority != "high":
            return self.RUNGS[2]
        if self.level >= 1 and priority == "low":
            return self.RUNGS[1]
        return None

    def search_degraded(self) -> bool:
        return self.level >= 2

    def degrade_top_k(self, top_k: int) -> int:
        return min(int(top_k), self.degraded_top_k) \
            if self.search_degraded() else int(top_k)
