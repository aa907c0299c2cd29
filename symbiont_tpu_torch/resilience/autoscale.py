"""SLO-driven elastic autoscaling: role-split fleets that grow, shrink,
and drain safely under traffic ramps.

Copy of the JAX package's `symbiont_tpu/resilience/autoscale.py`.

The reference system's "evolving organism" runs every service as exactly
one container forever; PR 10's ProcessSupervisor can RESTART roles but not
RESIZE them, so a traffic ramp ends in the shed ladder
(resilience/admission.py) instead of more capacity. This module closes
ROADMAP item 3's serving half: an `Autoscaler` attached to the supervisor
consumes the pressure signals the admission plane and fleet telemetry
already measure —

- per-role engine queue depth (`batcher.queue_depth` /
  `batcher.tenant_depth` gauges, federated over `_sys.telemetry.metrics.*`
  by obs/fleet.py),
- KV occupancy for decode roles (`lm.kv_rows_allocated` vs
  `autoscale.kv_high_rows`),
- SLO-watchdog breach counts and shed-ladder activity
  (`slo.breaches`, `admission.shed` — gateway-side, global pressure),

and drives `ProcessSupervisor.scale_role(role, n)`:

- **scale-out** spawns additional replicas (`embed-2`, `embed-3`, …) that
  join the existing queue groups — durable queue-group delivery shards the
  work with zero routing changes;
- **scale-in** retires the newest replica through the first-class **drain
  protocol**: the supervisor publishes `_sys.drain.<role>`, the worker
  stops pulling new durable deliveries (consumers DETACH, so unacked work
  redelivers to the survivors), flushes its `UpsertCoalescer`
  (ack-after-flush waits release), finishes in-flight generation, beats
  `draining: true` once, and exits rc 0. The supervisor enforces
  `drain_deadline_s`; a hung drain is SIGKILLed and durable redelivery
  still loses nothing (proven by tests/test_autoscale.py `-m chaos` and
  the `load_ramp` bench phase).

Scaling decisions carry breaker-style hysteresis (the DegradationLadder
shape: dwell both directions + `in_clean_passes` consecutive clean passes
to shrink) plus a global `OpsBudget`, so a flapping signal or a
crash-looping role cannot thrash the box — the supervisor's own
restart-storm budget (`crashlooped` parking) covers the restart half.

Nothing here imports jax or any service module; the signal reader and the
clock are injectable so the policy is unit-testable without processes.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

# flat-snapshot key prefixes (obs/fleet.py role snapshots) the default
# signal reader folds into per-role pressure
_DEPTH_PREFIX = "gauge.batcher.queue_depth"
_LANE_PREFIX = "gauge.batcher.tenant_depth"
_KV_PREFIX = "gauge.lm.kv_rows_allocated"
# gateway-side counters whose GROWTH is global "capacity is short" evidence
_GLOBAL_PREFIXES = ("counter.slo.breaches", "counter.admission.shed")


@dataclass(frozen=True)
class RoleBounds:
    """Replica bounds of one elastic role ("embed=1:4")."""

    min: int
    max: int


def parse_role_bounds(spec: str) -> Dict[str, RoleBounds]:
    """`"embed=1:4,decode=1:2"` → {"embed": RoleBounds(1, 4), ...}.
    Raises ValueError on malformed entries — a typo'd bound must fail at
    boot, not silently never scale. min >= 1 (the base replica never
    retires), max >= min."""
    out: Dict[str, RoleBounds] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, raw = entry.partition("=")
        name = name.strip()
        lo, sep2, hi = raw.partition(":")
        if not sep or not sep2 or not name:
            raise ValueError(
                f"autoscale role {entry!r} must look like 'role=min:max'")
        try:
            bounds = RoleBounds(int(lo), int(hi))
        except ValueError:
            raise ValueError(
                f"autoscale role {entry!r}: bounds must be integers"
            ) from None
        if bounds.min < 1 or bounds.max < bounds.min:
            raise ValueError(
                f"autoscale role {entry!r}: need 1 <= min <= max")
        out[name] = bounds
    return out


class OpsBudget:
    """Global scale/restart budget: at most `max_ops` operations per
    sliding `window_s`. One budget covers every role and both directions —
    the box-thrash bound, not a fairness mechanism."""

    def __init__(self, max_ops: int, window_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if max_ops < 1 or window_s <= 0:
            raise ValueError("budget max_ops >= 1 and window_s > 0")
        self.max_ops = int(max_ops)
        self.window_s = float(window_s)
        self._clock = clock
        self._ops: deque = deque()

    def try_take(self) -> bool:
        now = self._clock()
        while self._ops and now - self._ops[0] > self.window_s:
            self._ops.popleft()
        if len(self._ops) >= self.max_ops:
            return False
        self._ops.append(now)
        return True

    def remaining(self) -> int:
        now = self._clock()
        while self._ops and now - self._ops[0] > self.window_s:
            self._ops.popleft()
        return self.max_ops - len(self._ops)


@dataclass
class RoleSignals:
    """One role's pressure inputs for one evaluation pass."""

    # engine queue depth per LIVE replica (the averaged federated gauges)
    queue_depth: float = 0.0
    # allocated KV rows per live replica (decode roles)
    kv_rows: float = 0.0
    # global capacity-shortfall evidence this pass (SLO breach / shed
    # counters grew since the previous pass)
    breach: bool = False


class FleetSignalReader:
    """Default signal source: the supervisor's FleetAggregator role
    snapshots (obs/fleet.py). Per elastic role it averages the engine
    queue-depth and KV gauges over that role's live replicas, and turns
    gateway-side `slo.breaches` / `admission.shed` counter GROWTH into the
    global breach flag. Stateless callers can inject any
    `fn(bounds) -> {role: RoleSignals}` instead."""

    def __init__(self, sup):
        self.sup = sup
        self._last_global = 0.0

    def _snapshots(self) -> Dict[str, Dict[str, float]]:
        fleet = getattr(self.sup, "fleet", None)
        return {} if fleet is None else fleet.role_snapshots()

    @staticmethod
    def _sum_prefix(snap: Dict[str, float], prefix: str) -> float:
        return sum(v for k, v in snap.items() if k.startswith(prefix))

    def __call__(self, bounds: Dict[str, RoleBounds]
                 ) -> Dict[str, RoleSignals]:
        snaps = self._snapshots()
        total_global = sum(self._sum_prefix(snap, p)
                           for snap in snaps.values()
                           for p in _GLOBAL_PREFIXES)
        breach = total_global > self._last_global
        self._last_global = total_global
        out: Dict[str, RoleSignals] = {}
        for role in bounds:
            depth = kv = 0.0
            live = 0
            for name in self.sup.replicas(role):
                w = self.sup.workers.get(name)
                if w is None or w.draining:
                    continue
                live += 1
                snap = snaps.get(name, {})
                d = self._sum_prefix(snap, _DEPTH_PREFIX)
                if d == 0.0:
                    # pre-queue_depth gauges (or a batcher-less role):
                    # the per-tenant lane depths are the same backlog
                    d = self._sum_prefix(snap, _LANE_PREFIX)
                depth += d
                kv += self._sum_prefix(snap, _KV_PREFIX)
            live = max(1, live)
            out[role] = RoleSignals(queue_depth=depth / live,
                                    kv_rows=kv / live, breach=breach)
        return out


class _RoleState:
    def __init__(self, now: float, out_dwell_s: float):
        # first pressure pass acts immediately (DegradationLadder stance)
        self.last_change = now - out_dwell_s
        self.clean = 0


class Autoscaler:
    """The policy loop: every `cfg.eval_s`, read signals, apply
    hysteresis + the global budget, and call `sup.scale_role`. Decisions
    are recorded in `self.decisions` (monotonic ts, role, "out"/"in",
    target) — the flap gate and the ramp bench phase read them."""

    def __init__(self, sup, cfg=None,
                 signals: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        from symbiont_tpu_torch.config import AutoscaleConfig

        self.sup = sup
        self.cfg = cfg or AutoscaleConfig()
        self.bounds = parse_role_bounds(self.cfg.roles)
        self.signals = signals or FleetSignalReader(sup)
        self._clock = clock
        self.budget = OpsBudget(self.cfg.budget_ops,
                                self.cfg.budget_window_s, clock)
        now = clock()
        self._state = {role: _RoleState(now, self.cfg.out_dwell_s)
                       for role in self.bounds}
        self.decisions: list = []
        self._task: Optional[asyncio.Task] = None
        # the drain deadline is policy, enforced by the supervisor
        sup.drain_deadline_s = self.cfg.drain_deadline_s
        metrics.inc("autoscale.budget_exhausted", 0)
        for role in self.bounds:
            metrics.gauge_set("autoscale.pressure", 0.0,
                              labels={"role": role})
            metrics.gauge_set("autoscale.replicas",
                              len(sup.replicas(role)) or 1,
                              labels={"role": role})

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="autoscaler")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.eval_s)
            try:
                await self.evaluate_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                metrics.inc("autoscale.errors")
                log.exception("autoscale evaluation failed")

    # --------------------------------------------------------------- policy

    def _pressure(self, sig: RoleSignals) -> float:
        p = sig.queue_depth / self.cfg.queue_high
        if self.cfg.kv_high_rows > 0:
            p = max(p, sig.kv_rows / self.cfg.kv_high_rows)
        if sig.breach:
            p = max(p, 1.0)
        return p

    def _clean(self, sig: RoleSignals) -> bool:
        if sig.breach or sig.queue_depth > self.cfg.queue_low:
            return False
        return (self.cfg.kv_high_rows <= 0
                or sig.kv_rows <= 0.5 * self.cfg.kv_high_rows)

    def flaps(self) -> int:
        """Direction reversals inside one hysteresis window — the no-flap
        hard gate of the ramp bench phase. Dwell enforcement makes this 0
        by construction; the gate proves the enforcement held."""
        last: Dict[str, tuple] = {}
        n = 0
        for ts, role, direction, _target in self.decisions:
            prev = last.get(role)
            window = (self.cfg.in_dwell_s if direction == "in"
                      else self.cfg.out_dwell_s)
            if prev is not None and prev[1] != direction \
                    and ts - prev[0] < window:
                n += 1
            last[role] = (ts, direction)
        return n

    async def evaluate_once(self) -> None:
        """One policy pass. Skipped entirely while the broker is
        unhealthy: every signal is stale then, and a drain request could
        not even be published — scaling on a dead bus is exactly the
        thrash the budget exists to prevent."""
        if not getattr(self.sup, "_broker_healthy", True):
            metrics.inc("autoscale.skipped_broker_down")
            return
        sigs = self.signals(self.bounds)
        now = self._clock()
        for role, bounds in self.bounds.items():
            sig = sigs.get(role)
            if sig is None:
                continue
            live = [n for n in self.sup.replicas(role)
                    if n in self.sup.workers
                    and not self.sup.workers[n].draining]
            cur = len(live)
            if cur == 0:
                continue  # base replica mid-restart: nothing to resize
            p = self._pressure(sig)
            st = self._state[role]
            metrics.gauge_set("autoscale.pressure", round(p, 3),
                              labels={"role": role})
            metrics.gauge_set("autoscale.replicas", cur,
                              labels={"role": role})
            if p >= 1.0:
                st.clean = 0
                if cur >= bounds.max:
                    continue
                if now - st.last_change < self.cfg.out_dwell_s:
                    continue
                if not self.budget.try_take():
                    metrics.inc("autoscale.budget_exhausted")
                    log.warning("autoscale: %s pressure %.2f but the "
                                "global scale budget is exhausted", role, p)
                    continue
                st.last_change = now
                target = cur + 1
                self.decisions.append((now, role, "out", target))
                metrics.inc("autoscale.decisions",
                            labels={"role": role, "direction": "out"})
                log.info("autoscale: %s -> %d replicas (pressure %.2f)",
                         role, target, p)
                await self.sup.scale_role(role, target)
            elif self._clean(sig):
                st.clean += 1
                if cur <= bounds.min:
                    continue
                if st.clean < self.cfg.in_clean_passes:
                    continue
                if now - st.last_change < self.cfg.in_dwell_s:
                    continue
                if not self.budget.try_take():
                    metrics.inc("autoscale.budget_exhausted")
                    continue
                st.last_change = now
                st.clean = 0
                target = cur - 1
                self.decisions.append((now, role, "in", target))
                metrics.inc("autoscale.decisions",
                            labels={"role": role, "direction": "in"})
                log.info("autoscale: %s -> %d replicas (drain scale-in, "
                         "%d clean passes)", role, target,
                         self.cfg.in_clean_passes)
                await self.sup.scale_role(role, target)
            else:
                # neither hot nor clean: the dead band — hold, and reset
                # the clean streak so a noisy signal never shrinks
                st.clean = 0
