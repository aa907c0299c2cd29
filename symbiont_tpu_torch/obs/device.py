"""Device memory as the CUDA caching allocator reports it.

The port's counterpart of `symbiont_tpu/obs/device.py`'s
`local_device_stats` and `register_device_gauges`. Per CUDA device:

- `bytes_in_use`: `torch.cuda.memory_stats()["allocated_bytes.all.current"]`,
  the bytes of live tensors;
- `peak_bytes_in_use`: `allocated_bytes.all.peak`;
- `bytes_limit`: the device's total memory, from `torch.cuda.mem_get_info()`;

read through `_DeviceStatsCache`, JAX's short-lived cache, so a scrape of
many gauges reads the allocator once.

The CPU keeps no such statistics: without CUDA both functions return
nothing and register nothing. `register_process_gauges` is a copy of the
JAX module's: the standard `process_*` gauges read from `/proc/self`.

`record_compile_event` is a copy of the JAX function: every executable's
first call (a CUDA graph's capture, `graphs.py`) lands as a span on
the well-known trace `engine-compiles`, so a storm of captures shows on
the timeline (`GET /api/traces/engine-compiles/export?fmt=chrome`).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from symbiont_tpu_torch.obs.trace_store import SpanRecord, trace_store
from symbiont_tpu_torch.utils.ids import generate_uuid
from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

log = logging.getLogger(__name__)

# the well-known flight-recorder trace id of the compile (capture) events
COMPILE_TRACE_ID = "engine-compiles"

_DEVICE_SERIES = (
    ("device.bytes_in_use", "bytes_in_use"),
    ("device.peak_bytes_in_use", "peak_bytes_in_use"),
    ("device.bytes_limit", "bytes_limit"),
)


class _DeviceStatsCache:
    """One allocator read per device per scrape pass, as JAX's: the three
    `device.*` gauges of a device and the hbm ledger's reconcile are
    separate readers, so the first one inside a `max_age_s` window reads
    `torch.cuda.memory_stats` (and the device's total memory) and the rest
    share its figures. A raise propagates uncached."""

    def __init__(self, max_age_s: float = 0.25):
        self.max_age_s = max_age_s
        self._lock = threading.Lock()
        self._by_dev: Dict[int, Tuple[float, dict]] = {}

    def stats(self, index: int) -> dict:
        now = time.monotonic()
        with self._lock:
            hit = self._by_dev.get(index)
            if hit is not None and now - hit[0] <= self.max_age_s:
                return hit[1]
        s = torch.cuda.memory_stats(index)
        _free, total = torch.cuda.mem_get_info(index)
        out = {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
               "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
               "bytes_limit": int(total)}
        with self._lock:
            self._by_dev[index] = (now, out)
        return out


_stats_cache = _DeviceStatsCache()


def device_stats(index: int) -> dict:
    """The three memory figures of CUDA device `index`, read at most the
    cache's 0.25 s ago."""
    return dict(_stats_cache.stats(index))


def local_device_stats() -> List[Tuple[int, str, dict]]:
    """`[(index, "gpu", stats), ...]` for every CUDA device this process
    has initialised; `[]` without CUDA."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            out.append((i, "gpu", device_stats(i)))
        except RuntimeError:
            log.debug("memory stats of cuda:%d unavailable", i, exc_info=True)
    return out


def record_compile_event(name: str, duration_s: float,
                         start_s: Optional[float] = None, **fields) -> None:
    """Append one compile to the ``engine-compiles`` timeline trace."""
    start = start_s if start_s is not None else time.time() - duration_s
    trace_store.record(SpanRecord(
        trace_id=COMPILE_TRACE_ID, span_id=generate_uuid(), parent_id=None,
        name=name, start_s=start, duration_ms=duration_s * 1000.0,
        status="ok", fields={k: str(v) for k, v in fields.items()}))


def register_device_gauges(registry: Optional[Metrics] = None) -> int:
    """`device.bytes_in_use` / `peak_bytes_in_use` / `bytes_limit`
    callback gauges, labeled `{device, platform}`, for every CUDA device.
    Returns how many devices registered (0 without CUDA)."""
    registry = registry or _global_metrics
    n = 0
    for i, platform, _stats in local_device_stats():
        labels = {"device": str(i), "platform": platform}
        for series, key in _DEVICE_SERIES:
            registry.register_gauge(series, lambda i=i, key=key: device_stats(i)[key],
                                    labels=labels)
        n += 1
    return n


def register_process_gauges(registry: Optional[Metrics] = None) -> bool:
    """Standard ``process_*`` gauges from ``/proc/self``. Platform-guarded:
    returns False (registering nothing) where /proc is absent."""
    registry = registry or _global_metrics
    if not (os.path.isdir("/proc/self") and os.path.exists("/proc/stat")):
        return False
    page = os.sysconf("SC_PAGE_SIZE")
    ticks = os.sysconf("SC_CLK_TCK")

    def _statm_field(idx: int) -> Optional[float]:
        try:
            with open("/proc/self/statm") as fh:
                return float(fh.read().split()[idx]) * page
        except (OSError, ValueError, IndexError):
            return None

    def open_fds() -> Optional[float]:
        try:
            return float(len(os.listdir("/proc/self/fd")))
        except OSError:
            return None

    def start_time_s() -> Optional[float]:
        """Process start as epoch seconds: kernel boot time (btime) plus
        the start offset from /proc/self/stat (field 22, counted after the
        parenthesised comm field — comm may itself contain spaces)."""
        try:
            with open("/proc/stat") as fh:
                btime = next(float(ln.split()[1]) for ln in fh
                             if ln.startswith("btime"))
            with open("/proc/self/stat") as fh:
                after_comm = fh.read().rsplit(")", 1)[1].split()
            return btime + float(after_comm[19]) / ticks
        except (OSError, ValueError, IndexError, StopIteration):
            return None

    start = start_time_s()
    registry.register_gauge("process.resident_memory_bytes",
                            lambda: _statm_field(1))
    registry.register_gauge("process.virtual_memory_bytes",
                            lambda: _statm_field(0))
    registry.register_gauge("process.open_fds", open_fds)
    if start is not None:
        registry.register_gauge("process.start_time_seconds",
                                lambda: start)
        registry.register_gauge("process.uptime_seconds",
                                lambda: time.time() - start)
    return True
