"""Device-memory attribution: who holds the card's bytes, and OOM forensics.

The port's copy of `symbiont_tpu/obs/hbm.py`:

- `HbmLedger`: each owner of device memory (the engine's parameters,
  `engine.params`; the store's padded corpus, `memory.corpus`) registers a
  claim bound to it by weakref; a dead owner's claim retires. `rows` lists
  the claims, `attributed_bytes` sums them (overlay claims excluded), and
  `reconcile` sets the sum against the allocator's bytes in use
  (`obs/device.py`, basis `memory_stats`), or, without CUDA, against the
  live-tensor census (basis `live_arrays`), and reports the rest as
  unattributed; `reconcile(census_rows=n)` carries a census beside it.
- `census(top)`: the live tensors grouped by (shape, dtype, placement),
  the counterpart of JAX's `jax.live_arrays()` aggregate. It walks the
  garbage collector's objects for tensors, counts each storage once (in
  the group of the largest tensor over it) and reads metadata only, with
  no device sync; on the card one more group holds the bytes the CUDA
  graph pools reserve beyond the tensors that live in them
  (`graphs.graph_pool_bytes`), bytes no tensor names. Tensors only C++
  holds (autograd's saved tensors, library workspaces) are not seen: they
  stay in the unattributed rest. `census_diff` is JAX's copy.
- `peak_temp_bytes(prefix)`: the largest `temp_bytes` of the dispatch
  ledger's executables, the scratch term of the LM's admission forecast.
- `guard_oom(site)` wraps a dispatch: a device OOM escaping it counts
  `engine.oom_total{site}`, leaves a postmortem (the reconcile, a census
  and the engine timeline's tail) in a bounded directory, and is
  re-raised.

`configure`, `claim_value`, `register_gauges` and `register_zero` are the
JAX ledger's, for the runner's boot and `/metrics`
(`hbm.attributed_bytes{subsystem}`, `hbm.unattributed_bytes{device}`,
`engine.oom_total{site}`).
"""

from __future__ import annotations

import gc
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

# census groups carried in API responses and postmortems past which the
# tail is summed into one "(other)" row
DEFAULT_CENSUS_GROUPS = 64


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
        # the census row bound of API responses and postmortems
        # (ObsConfig.hbm_census_groups, set by the runner at boot)
        self.census_groups = DEFAULT_CENSUS_GROUPS
        # bounded read-side cache for the scrape gauges: one reader pass
        # per max_age window
        self._cache: Optional[Tuple[float, List[dict]]] = None

    def configure(self, enabled: bool = True, census_groups: Optional[int] = None) -> None:
        with self._lock:
            self._enabled = bool(enabled)
            if census_groups is not None:
                self.census_groups = max(1, int(census_groups))
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

    def reconcile(self, census_rows: int = 0) -> dict:
        """Claims against the allocator's bytes in use, per device (basis
        `memory_stats`); without CUDA against the live-tensor census's
        total (basis `live_arrays`, a softer denominator: it misses what
        only C++ holds). `census_rows` > 0 adds a census of that many
        groups."""
        from symbiont_tpu_torch.obs.device import local_device_stats

        rows = self.rows()
        attributed = self.attributed_bytes(rows)
        devices, stats_total = [], 0
        for idx, platform, stats in local_device_stats():
            devices.append({"device": idx, "platform": platform, **stats})
            stats_total += stats["bytes_in_use"]
        cen = None
        if not devices:
            cen = census(top=max(0, int(census_rows)))
        if devices:
            basis, total = "memory_stats", stats_total
        elif cen and cen.get("available"):
            basis, total = "live_arrays", int(cen["bytes_total"])
        else:
            basis, total = "none", 0
        unattributed = max(0, total - attributed)
        for d in devices:
            # claims are process-wide: apportion them by each device's share
            share = d["bytes_in_use"] / total if total else 0.0
            d["unattributed_bytes"] = max(0, int(d["bytes_in_use"] - attributed * share))
        out = {
            "basis": basis,
            "bytes_in_use": total,
            "attributed_bytes": attributed,
            "unattributed_bytes": unattributed,
            "unattributed_pct": round(100.0 * unattributed / total, 2) if total else 0.0,
            "subsystems": rows,
            "devices": devices,
        }
        if census_rows:
            out["census"] = cen if cen is not None else census(top=int(census_rows))
        return out

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


# --------------------------------------------------------------------- census


def _live_storages(device: Optional[torch.device]) -> Dict[tuple, tuple]:
    """(device, storage address) → (storage bytes, the largest tensor over
    it) for every tensor the garbage collector tracks on `device` (every
    CUDA device with None), metadata only."""
    out: Dict[tuple, tuple] = {}
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor):  # type(): no attribute lookup on obj
            continue
        try:
            if obj.is_meta or obj.layout != torch.strided:
                continue
            dev = obj.device
            if (dev.type != "cuda") if device is None else (dev != device):
                continue
            st = obj.untyped_storage()
            key = (str(dev), st.data_ptr())
            nbytes = int(st.nbytes())
        except Exception:
            continue  # a tensor subclass or a freed storage mid-walk
        have = out.get(key)
        if have is None or obj.numel() * obj.element_size() > (
                have[1].numel() * have[1].element_size()):
            out[key] = (nbytes, obj)
    return out


def census(top: int = DEFAULT_CENSUS_GROUPS, device=None) -> dict:
    """The live tensors grouped by (shape, dtype, placement), as JAX
    groups `jax.live_arrays()` by (shape, dtype, sharding): each storage
    counted once, in the group of the largest tensor over it. `device`:
    the tensors of that device; by default those of every CUDA device the
    process has initialised, else the CPU's. On the card one more group,
    dtype "(graph pools)", holds the bytes the CUDA graph pools reserve
    beyond the tensors that live in them. Metadata only, on demand only.
    `top` > 0 bounds the group rows; the tail folds into "(other)"."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    dev = None if device is None and cuda else torch.device(device or "cpu")
    try:
        storages = _live_storages(dev)
    except Exception as e:
        return {"available": False, "detail": str(e)}
    pool_segments = []
    if cuda and (dev is None or dev.type == "cuda"):
        pool_segments = [(seg["address"], seg["address"] + seg["total_size"])
                         for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)
                         and (dev is None or dev.index in (None, seg["device"]))]
    groups: Dict[Tuple, List[int]] = {}
    total = n = in_pools = 0
    for (_, ptr), (nbytes, t) in storages.items():
        key = (tuple(int(d) for d in t.shape), str(t.dtype).replace("torch.", ""),
               str(t.device))
        g = groups.setdefault(key, [0, 0])
        g[0] += 1
        g[1] += nbytes
        total += nbytes
        n += 1
        if any(lo <= ptr < hi for lo, hi in pool_segments):
            in_pools += nbytes
    if pool_segments:
        from symbiont_tpu_torch.graphs import graph_pool_bytes

        reserve = max(0, graph_pool_bytes(dev) - in_pools)
        groups[((), "(graph pools)", "cuda" if dev is None else str(dev))] = [
            len(pool_segments), reserve]
        total += reserve
    rows = [{"shape": list(k[0]), "dtype": k[1], "sharding": k[2], "count": c, "bytes": b}
            for k, (c, b) in groups.items()]
    rows.sort(key=lambda r: (-r["bytes"], r["dtype"], r["shape"]))
    out = {"available": True, "arrays": n, "bytes_total": total, "group_count": len(rows)}
    if top and len(rows) > int(top):
        head, tail = rows[:int(top)], rows[int(top):]
        head.append({"shape": [], "dtype": "(other)", "sharding": "",
                     "count": sum(r["count"] for r in tail),
                     "bytes": sum(r["bytes"] for r in tail)})
        rows = head
    out["groups"] = rows
    return out


def census_diff(before: dict, after: dict, top: int = DEFAULT_CENSUS_GROUPS) -> dict:
    """Copy of JAX's `census_diff`: what changed between two censuses,
    by (shape, dtype, placement) group, byte and count deltas, growth
    first; unchanged groups omitted."""
    def keyed(c: dict) -> Dict[Tuple, Tuple[int, int]]:
        return {(tuple(r["shape"]), r["dtype"], r["sharding"]): (r["count"], r["bytes"])
                for r in c.get("groups", []) if r["dtype"] != "(other)"}

    if not (before.get("available") and after.get("available")):
        return {"available": False}
    b, a = keyed(before), keyed(after)
    rows = []
    for key in set(b) | set(a):
        cb, bb = b.get(key, (0, 0))
        ca, ba = a.get(key, (0, 0))
        if ba == bb and ca == cb:
            continue
        rows.append({"shape": list(key[0]), "dtype": key[1], "sharding": key[2],
                     "count_delta": ca - cb, "bytes_delta": ba - bb})
    rows.sort(key=lambda r: -r["bytes_delta"])
    return {"available": True,
            "bytes_delta": after["bytes_total"] - before["bytes_total"],
            "array_delta": after["arrays"] - before["arrays"],
            "groups": rows[:int(top)] if top else rows}


def peak_temp_bytes(prefix: str = "") -> int:
    """The largest `temp_bytes` among the dispatch ledger's executables
    whose signature starts with `prefix` ("lm." → the decode plane's):
    the scratch half of `can_admit`'s bytes forecast."""
    from symbiont_tpu_torch.obs.xprof import dispatch_ledger

    best = 0
    for row in dispatch_ledger.snapshot():
        if prefix and not row["executable"].startswith(prefix):
            continue
        t = row.get("temp_bytes")
        if t:
            best = max(best, int(t))
    return best


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
    `engine.oom_total{site}`, writes the reconcile, a census and the engine
    timeline's tail to one JSON file (at most `max_files` kept, newest win) and keeps
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
            report["census"] = census(top=32)
        except Exception:
            log.debug("oom postmortem: census failed", exc_info=True)
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
