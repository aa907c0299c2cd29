"""Device-memory attribution: who holds the card's bytes, and OOM forensics.

The port's copy of `symbiont_tpu/obs/hbm.py`'s claim ledger and OOM guard:

- `HbmLedger`: each owner of device memory (the engine's parameters,
  `engine.params`; the store's padded corpus, `memory.corpus`) registers a
  claim bound to it by weakref; a dead owner's claim retires. `rows` lists
  the claims, `attributed_bytes` sums them (overlay claims excluded), and
  `reconcile` sets the sum against the allocator's bytes in use
  (`obs/device.py`, basis `memory_stats`) and reports the rest as
  unattributed. Without CUDA the basis is `none`.
- `guard_oom(site)` wraps a dispatch: a device OOM escaping it counts
  `engine.oom_total{site}`, leaves a postmortem (the reconcile and the
  engine timeline's tail) in a bounded directory, and is re-raised.

`configure`, `claim_value`, `register_gauges` and `register_zero` are the
JAX ledger's, for the runner's boot and `/metrics`
(`hbm.attributed_bytes{subsystem}`, `hbm.unattributed_bytes{device}`,
`engine.oom_total{site}`). The JAX ledger's live-array census and the
per-executable `peak_temp_bytes` have no torch counterpart yet (A7's
leftovers, ROADMAP): a `reconcile` without CUDA therefore has no softer
basis to fall back to, and `GET /api/memory/census` answers 501.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

log = logging.getLogger(__name__)


class HbmLedger:
    """Process-wide subsystem → device-bytes claim table. A claim is
    `(subsystem, owner, reader)`: the ledger keeps a weakref of the owner
    and calls `reader(owner)` at read time; several owners of one subsystem
    sum. Readers must read host-side metadata only (tensor sizes), never
    synchronise with the device."""

    def __init__(self, registry: Optional[Metrics] = None):
        self.registry = registry if registry is not None else _global_metrics
        self._lock = threading.Lock()
        # (subsystem, id(owner)) -> (weakref or None, reader, overlay)
        self._claims: Dict[Tuple[str, int], tuple] = {}
        self._enabled = True
        # bounded read-side cache for the scrape gauges: one reader pass
        # per max_age window
        self._cache: Optional[Tuple[float, List[dict]]] = None

    def configure(self, enabled: bool = True) -> None:
        with self._lock:
            self._enabled = bool(enabled)
            self._cache = None

    def clear(self) -> None:
        with self._lock:
            self._claims.clear()
            self._cache = None

    def claim(self, subsystem: str, owner, reader: Callable, overlay: bool = False) -> None:
        """Register (or replace) `owner`'s claim on `subsystem`. `reader(owner)`
        returns its bytes, or None to retire the claim. An overlay claim is
        listed but left out of the attributed sum (bytes another claim
        already holds)."""
        with self._lock:
            self._claims[(str(subsystem), id(owner))] = (weakref.ref(owner), reader,
                                                         bool(overlay))
            self._cache = None

    def claim_value(self, subsystem: str, nbytes: int, overlay: bool = False) -> None:
        """Ownerless static claim (boot-time constants); 0 removes it."""
        key = (str(subsystem), 0)
        with self._lock:
            if nbytes:
                self._claims[key] = (None, (lambda n=int(nbytes): n), bool(overlay))
            else:
                self._claims.pop(key, None)
            self._cache = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._claims)

    def rows(self, max_age_s: float = 0.0) -> List[dict]:
        """Per-subsystem rows `{subsystem, bytes, overlay}`, largest first.
        Readers run outside the ledger's lock; dead owners retire. With
        `max_age_s` a read that recent is served from the cache."""
        now = time.monotonic()
        with self._lock:
            if not self._enabled:
                return []
            if (max_age_s > 0.0 and self._cache is not None
                    and now - self._cache[0] <= max_age_s):
                return [dict(r) for r in self._cache[1]]
            claims = dict(self._claims)
        per: Dict[str, List] = {}
        dead = []
        for key, (ref, reader, overlay) in claims.items():
            try:
                if ref is None:
                    v = reader()
                else:
                    owner = ref()
                    v = None if owner is None else reader(owner)
            except Exception:
                log.debug("hbm claim %s failed this read", key[0], exc_info=True)
                continue  # a transient failure keeps the claim
            if v is None:
                dead.append(key)
                continue
            agg = per.setdefault(key[0], [0, overlay])
            agg[0] += int(v)
            agg[1] = agg[1] and overlay
        if dead:
            with self._lock:
                for key in dead:
                    self._claims.pop(key, None)
        rows = [{"subsystem": name, "bytes": int(v), "overlay": bool(ov)}
                for name, (v, ov) in per.items()]
        rows.sort(key=lambda r: (-r["bytes"], r["subsystem"]))
        with self._lock:
            self._cache = (now, [dict(r) for r in rows])
        return rows

    def attributed_bytes(self, rows: Optional[List[dict]] = None) -> int:
        """Sum of the non-overlay claims: the bytes the ledger explains."""
        if rows is None:
            rows = self.rows()
        return sum(r["bytes"] for r in rows if not r["overlay"])

    def reconcile(self) -> dict:
        """Claims against the allocator's bytes in use, per device; basis
        `memory_stats` with CUDA, `none` without."""
        from symbiont_tpu_torch.obs.device import local_device_stats

        rows = self.rows()
        attributed = self.attributed_bytes(rows)
        devices, total = [], 0
        for idx, platform, stats in local_device_stats():
            devices.append({"device": idx, "platform": platform, **stats})
            total += stats["bytes_in_use"]
        basis = "memory_stats" if devices else "none"
        unattributed = max(0, total - attributed)
        for d in devices:
            # claims are process-wide: apportion them by each device's share
            share = d["bytes_in_use"] / total if total else 0.0
            d["unattributed_bytes"] = max(0, int(d["bytes_in_use"] - attributed * share))
        return {
            "basis": basis,
            "bytes_in_use": total,
            "attributed_bytes": attributed,
            "unattributed_bytes": unattributed,
            "unattributed_pct": round(100.0 * unattributed / total, 2) if total else 0.0,
            "subsystems": rows,
            "devices": devices,
        }

    def register_gauges(self, registry: Optional[Metrics] = None) -> None:
        """One `hbm.attributed_bytes{subsystem}` gauge per subsystem claimed
        so far, and `hbm.unattributed_bytes{device}` per device that reports
        allocator statistics, all read at scrape time. The runner calls it
        once the engines have claimed."""
        registry = registry or self.registry

        def sub_reader(name: str):
            def fn():
                for r in self.rows(max_age_s=1.0):
                    if r["subsystem"] == name:
                        return r["bytes"]
                return 0
            return fn

        for r in self.rows():
            registry.register_gauge("hbm.attributed_bytes", sub_reader(r["subsystem"]),
                                    labels={"subsystem": r["subsystem"]})

        def unattributed():
            rec = self.reconcile()
            return rec["unattributed_bytes"] if rec["basis"] == "memory_stats" else None

        from symbiont_tpu_torch.obs.device import local_device_stats

        for idx, platform, _stats in local_device_stats():
            registry.register_gauge("hbm.unattributed_bytes", unattributed,
                                    labels={"device": str(idx), "platform": str(platform)})

    def register_zero(self, registry: Optional[Metrics] = None) -> None:
        """The hbm family at zero, so `/metrics` shows it before any
        subsystem claims bytes."""
        (registry or self.registry).gauge_set("hbm.attributed_bytes", 0,
                                              labels={"subsystem": "all"})


# ------------------------------------------------------------- OOM forensics


_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory",
                "RESOURCE_EXHAUSTED")


def is_oom(exc: BaseException) -> bool:
    """A device allocator failure: `torch.cuda.OutOfMemoryError`, or an
    error whose message says the memory ran out."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in _OOM_MARKERS)


class OomForensics:
    """Bounded postmortem writer for device OOMs. `record(site, exc)` counts
    `engine.oom_total{site}`, writes the reconcile and the engine timeline's
    tail to one JSON file (at most `max_files` kept, newest win) and keeps
    the verdict in `last`. It never raises: the OOM is already on its way."""

    def __init__(self, registry: Optional[Metrics] = None):
        self.registry = registry if registry is not None else _global_metrics
        self._lock = threading.Lock()
        self._dir = os.path.join(tempfile.gettempdir(), "symbiont_hbm")
        self._max_files = 4
        self._enabled = True
        self._seq = 0
        self._last: Optional[dict] = None

    def configure(self, postmortem_dir: Optional[str] = None,
                  max_files: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        """Write postmortems into `postmortem_dir`, keep at most
        `max_files`; `enabled=False` counts OOMs and writes nothing."""
        with self._lock:
            if postmortem_dir:
                self._dir = str(postmortem_dir)
            if max_files is not None:
                self._max_files = max(1, int(max_files))
            if enabled is not None:
                self._enabled = bool(enabled)

    def register_zero(self, registry: Optional[Metrics] = None) -> None:
        (registry or self.registry).inc("engine.oom_total", 0, labels={"site": "all"})

    @property
    def last(self) -> Optional[dict]:
        with self._lock:
            return dict(self._last) if self._last else None

    def _prune_locked(self) -> None:
        try:
            files = sorted(f for f in os.listdir(self._dir)
                           if f.startswith("oom_") and f.endswith(".json"))
        except OSError:
            return
        for f in files[:-self._max_files]:
            try:
                os.unlink(os.path.join(self._dir, f))
            except OSError:
                pass

    def record(self, site: str, exc: BaseException) -> Optional[str]:
        """One device OOM at `site` → the postmortem's path (None when the
        write failed; the counter counts either way)."""
        self.registry.inc("engine.oom_total", labels={"site": site})
        with self._lock:
            if not self._enabled:
                return None
            self._seq += 1
            seq = self._seq
        report = {"site": site, "ts": round(time.time(), 3),
                  "error": str(exc)[:2000], "error_type": type(exc).__name__}
        try:  # each section best-effort: a postmortem must not raise
            report["memory"] = hbm_ledger.reconcile()
        except Exception:
            log.debug("oom postmortem: reconcile failed", exc_info=True)
        try:
            from symbiont_tpu_torch.obs.engine_timeline import engine_timeline

            report["timeline_tail"] = engine_timeline.events()[-128:]
        except Exception:
            log.debug("oom postmortem: timeline failed", exc_info=True)
        try:
            with self._lock:
                os.makedirs(self._dir, exist_ok=True)
                path = os.path.join(self._dir, f"oom_{os.getpid()}_{seq:04d}.json")
                with open(path, "w") as fh:
                    json.dump(report, fh, default=str)
                self._prune_locked()
        except OSError:
            log.warning("oom postmortem write failed", exc_info=True)
            path = None
        with self._lock:
            self._last = {"site": site, "ts": report["ts"],
                          "error": report["error"][:200], "postmortem": path}
        log.error("device OOM at %s; postmortem %s", site, path)
        return path


@contextmanager
def guard_oom(site: str):
    """Record a device OOM escaping the body (`OomForensics.record`) and
    re-raise it unchanged; other exceptions pass through untouched."""
    try:
        yield
    except BaseException as e:
        if is_oom(e):
            oom_forensics.record(site, e)
        raise


# process-global instances
hbm_ledger = HbmLedger()
oom_forensics = OomForensics()
