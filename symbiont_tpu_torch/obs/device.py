"""Device memory as the CUDA caching allocator reports it.

The port's counterpart of `symbiont_tpu/obs/device.py`'s
`local_device_stats` and `register_device_gauges`. Per CUDA device:

- `bytes_in_use`: `torch.cuda.memory_stats()["allocated_bytes.all.current"]`,
  the bytes of live tensors;
- `peak_bytes_in_use`: `allocated_bytes.all.peak`;
- `bytes_limit`: the device's total memory, from `torch.cuda.mem_get_info()`.

The CPU keeps no such statistics: without CUDA both functions return
nothing and register nothing. `register_process_gauges` is a copy of the
JAX module's: the standard `process_*` gauges read from `/proc/self`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

import torch

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

log = logging.getLogger(__name__)

_DEVICE_SERIES = (
    ("device.bytes_in_use", "bytes_in_use"),
    ("device.peak_bytes_in_use", "peak_bytes_in_use"),
    ("device.bytes_limit", "bytes_limit"),
)


def device_stats(index: int) -> dict:
    """The three memory figures of CUDA device `index`."""
    s = torch.cuda.memory_stats(index)
    _free, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}


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
