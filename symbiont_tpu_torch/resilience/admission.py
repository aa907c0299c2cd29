"""Tenant identities and stride scheduling: the port's copy of the parts
of `symbiont_tpu/resilience/admission.py` that the generation batcher
(`engine/batcher.py`) and the usage meter (`obs/usage.py`) use.

- `DEFAULT_TENANT`: the lane of a request that names no tenant;
- `OVERFLOW_TENANT`: the one shared identity of every tenant past a
  bounded universe (tenant names come from clients, so a fresh name must
  buy no fresh state);
- `AdmissionReject`: a request refused with a Retry-After hint (a full
  tenant lane);
- `StrideClock`: the stride-scheduling core the batcher's tenant lanes
  drain by.

The rest of the admission plane (token buckets, the weighted-fair queue,
deadlines, the degradation ladder) sits at the API edge and comes with the
stack (ROADMAP A8).
"""

from __future__ import annotations

from typing import Dict, Optional

DEFAULT_TENANT = "default"

# past a bounded number of distinct tenants every NEW name maps here, so
# client-minted identities grow no state and no metric-label cardinality
OVERFLOW_TENANT = "(overflow)"


class AdmissionReject(Exception):
    """A request that must be answered 429: carries the Retry-After hint
    and a bounded-cardinality reason label."""

    def __init__(self, reason: str, retry_after_s: float = 1.0, message: str = ""):
        super().__init__(message or reason)
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))


class StrideClock:
    """Stride scheduling: each grant charges the tenant's virtual time by
    1/weight, and the pending tenant with the smallest effective virtual
    time goes next. The global clock (`_vnow`) follows every grant, so a
    tenant active while uncontended banks no lateness, and a tenant back
    from idle starts at the current floor (no burst catch-up)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._vtime: Dict[str, float] = {}
        self._vnow = 0.0  # floor for tenants returning from idle

    def _weight(self, tenant: str) -> float:
        return max(1e-6, float(self.weights.get(tenant, self.default_weight)))

    def effective(self, tenant: str) -> float:
        """The virtual time a grant to `tenant` would happen at."""
        return max(self._vtime.get(tenant, 0.0), self._vnow)

    def pick(self, tenants) -> Optional[str]:
        """The pending tenant that goes next (smallest effective virtual
        time, the name breaking exact ties); None when there is none."""
        best = None
        for t in tenants:
            key = (self.effective(t), t)
            if best is None or key < best:
                best = key
        return None if best is None else best[1]

    def charge(self, tenant: str) -> None:
        """One grant: the global clock moves to the grant's virtual time and
        the tenant's next entitlement moves out by 1/weight."""
        v = self.effective(tenant)
        self._vnow = v
        self._vtime[tenant] = v + 1.0 / self._weight(tenant)

    def forget(self, tenant: str) -> None:
        """Drop a drained tenant carrying at most one grant of debt (after
        its last grant its vtime sits 1/weight past the floor), so the
        table does not grow with every identity ever seen."""
        if self._vtime.get(tenant, 0.0) <= self._vnow + 1.0 / self._weight(tenant):
            self._vtime.pop(tenant, None)

    def snapshot(self) -> "StrideClock":
        """A copy for walks in fair order that consume nothing."""
        c = StrideClock(self.weights, self.default_weight)
        c._vtime = dict(self._vtime)
        c._vnow = self._vnow
        return c
