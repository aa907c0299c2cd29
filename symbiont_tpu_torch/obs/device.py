"""Device memory as the CUDA caching allocator reports it.

The port's counterpart of `symbiont_tpu/obs/device.py`'s
`local_device_stats` and `register_device_gauges`. Per CUDA device:

- `bytes_in_use`: `torch.cuda.memory_stats()["allocated_bytes.all.current"]`,
  the bytes of live tensors;
- `peak_bytes_in_use`: `allocated_bytes.all.peak`;
- `bytes_limit`: the device's total memory, from `torch.cuda.mem_get_info()`.

The CPU keeps no such statistics: without CUDA both functions return
nothing and register nothing.
"""

from __future__ import annotations

import logging
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
