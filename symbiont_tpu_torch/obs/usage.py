"""Per-tenant usage metering: the port's copy of `symbiont_tpu/obs/usage.py`.

Bounded per-tenant counters of the serving stack's five cost drivers:

- `tokens_in` / `tokens_out`: prompt tokens prefilled and tokens decoded
  for the tenant, counted by the LM engine at its chunk boundaries;
- `embed_rows`: sentences embedded through the micro-batcher;
- `search_queries`: admitted search requests at the API edge;
- `kv_row_seconds`: KV-cache row-seconds held by the tenant's live decode
  rows (two tenants with equal token counts can differ 10x here).

Every `note()` lands twice: in this module's per-tenant totals and as a
`tenant.usage.<kind>` counter of the metrics registry, labeled by tenant.
Past `max_tenants` distinct identities every new name shares the
`(overflow)` ledger, so client-minted tenants grow no state. The runner's
sizing and zero-registration of the families come with the stack
(ROADMAP A8).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from symbiont_tpu_torch.resilience.admission import DEFAULT_TENANT, OVERFLOW_TENANT
from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

# the metered kinds; note() refuses any other, so a typo fails at its call
# site instead of minting a new counter family
KINDS = ("tokens_in", "tokens_out", "embed_rows", "search_queries", "kv_row_seconds")


class UsageMeter:
    """Thread-safe bounded per-tenant usage ledger."""

    def __init__(self, max_tenants: int = 1024, registry: Optional[Metrics] = None):
        self.registry = registry if registry is not None else _global_metrics
        self.max_tenants = max(1, int(max_tenants))
        self._lock = threading.Lock()
        self._totals: Dict[str, Dict[str, float]] = {}
        # the bound counts identities ever seen, not those tracked now
        self._seen: set = {DEFAULT_TENANT}

    def _resolve(self, tenant: Optional[str]) -> str:
        t = (tenant or "").strip() or DEFAULT_TENANT
        with self._lock:
            if t in self._seen:
                return t
            if len(self._seen) >= self.max_tenants:
                return OVERFLOW_TENANT
            self._seen.add(t)
            return t

    def note(self, tenant: Optional[str], **counts) -> None:
        """Charge one tenant: `note(t, tokens_out=12, kv_row_seconds=0.4)`.
        Unknown kinds raise; zero counts are skipped (no empty series)."""
        bad = [k for k in counts if k not in KINDS]
        if bad:
            raise ValueError(f"unknown usage kind(s) {bad}; known: {KINDS}")
        live = {k: v for k, v in counts.items() if v}
        if not live:
            return
        t = self._resolve(tenant)
        with self._lock:
            ledger = self._totals.setdefault(t, {})
            for k, v in live.items():
                ledger[k] = ledger.get(k, 0.0) + float(v)
        for k, v in live.items():  # the registry has its own lock
            self.registry.inc(f"tenant.usage.{k}", v, labels={"tenant": t})

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant totals since the process started, rounded to 3
        places (kv_row_seconds is the one float-valued kind)."""
        with self._lock:
            return {t: {k: round(v, 3) for k, v in ledger.items()}
                    for t, ledger in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._seen = {DEFAULT_TENANT}


# the process-global meter, like the metrics registry
usage = UsageMeter()
