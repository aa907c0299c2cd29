"""PagePool: the host-side allocator over one preallocated device page pool.

The port's copy of `symbiont_tpu/kv/pool.py`. The pool owns the device
tensors a `PagedKVCache` references (written in place by the decode and
the admission scatter, so, unlike JAX's, they are never reassigned) and
all host bookkeeping:

- a free list of page ids (page 0 is the scratch sink, never allocated);
- per-page refcounts: the live session rows mapping the page;
- the committed set: pages the radix prefix cache (`kv/radix.py`) retains
  after their refcount drops to 0, so the next admission with the same
  prompt prefix reuses them instead of prefilling again;
- LRU eviction of committed refcount-0 pages back to the free list when an
  allocation would otherwise fail (`kv.radix_evictions` counts them).

It exports the `kv.*` gauges, labelled by KV dtype as the `lm.kv_*` ones
are, and claims its bytes in the device-memory ledger (`kv.page_pool`,
with the retained share as the `kv.radix_retained` overlay).
`register_zero_gauges` registers the same families at 0.

Thread-safety: one RLock shared with the radix cache (the engine mutates
both under it); gauge readers take it briefly.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

GAUGES = ("kv.pages_free", "kv.pages_live", "kv.page_fragmentation_pct")
COUNTERS = ("kv.radix_hit_tokens_total", "kv.radix_evictions")


def kv_dtype_label(dtype: str, kv_quant: str) -> str:
    """One labelling rule for every kv.* and lm.kv_* family."""
    return "int8" if kv_quant == "int8" else dtype


def register_zero_gauges(dtype: str, kv_quant: str, registry: Optional[Metrics] = None) -> None:
    """Register the kv.* families at 0, as callbacks, so a later pool or
    engine registering its real readers under the same labels replaces
    them."""
    reg = registry if registry is not None else _global_metrics
    labels = {"service": "lm", "kv_dtype": kv_dtype_label(dtype, kv_quant)}
    for name in GAUGES:
        reg.register_gauge(name, lambda: 0.0, labels=labels)
    for name in COUNTERS:
        reg.inc(name, 0, labels=labels)


class PoolExhausted(RuntimeError):
    """An allocation failed after every evictable page was evicted; the
    engine's admission quote (`LmEngine.can_admit`) exists to keep sessions
    from reaching this."""


class PagePool:
    def __init__(self, num_layers: int, n_pages: int, page_tokens: int, kv_heads: int,
                 head_dim: int, dtype: torch.dtype, quantized: bool, dtype_label: str,
                 registry: Optional[Metrics] = None, device=None):
        from symbiont_tpu_torch.kv import paged

        if n_pages < 2:
            raise ValueError("kv pool needs >= 2 pages (scratch + one)")
        self.registry = registry if registry is not None else _global_metrics
        self.labels = {"service": "lm", "kv_dtype": dtype_label}
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self.k, self.v, self.k_scale, self.v_scale = paged.init_pool_arrays(
            num_layers, n_pages, page_tokens, kv_heads, head_dim, dtype, quantized, device)
        self.lock = threading.RLock()
        # page 0 is scratch: never on the free list, never refcounted
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._refcount = [0] * n_pages
        self._committed = [False] * n_pages
        # LRU clock over committed refcount-0 pages: page id -> last touch
        self._retained: Dict[int, int] = {}
        self._touch_seq = 0
        # the radix cache drops the trie path of an evicted page
        # (RadixCache sets it)
        self._on_evict: Optional[Callable[[int], None]] = None
        self._register_gauges()

    # --------------------------------------------------------------- gauges

    def _register_gauges(self) -> None:
        reg = self.registry
        reg.register_weakref_gauge("kv.pages_free", self, lambda p: p.pages_free,
                                   labels=self.labels)
        reg.register_weakref_gauge("kv.pages_live", self, lambda p: p.pages_live,
                                   labels=self.labels)
        # fragmentation needs per-session token counts only the engine has:
        # a placeholder its reader replaces
        reg.register_weakref_gauge("kv.page_fragmentation_pct", self, lambda p: 0.0,
                                   labels=self.labels)
        for name in COUNTERS:
            reg.inc(name, 0, labels=self.labels)
        from symbiont_tpu_torch.obs.hbm import hbm_ledger

        # the whole pool, and the retained share as an overlay inside it
        hbm_ledger.claim("kv.page_pool", self, lambda p: p.device_bytes)
        hbm_ledger.claim("kv.radix_retained", self,
                         lambda p: int(p.pages_retained * p.device_bytes / p.n_pages),
                         overlay=True)

    @property
    def pages_free(self) -> int:
        with self.lock:
            return len(self._free)

    @property
    def pages_live(self) -> int:
        with self.lock:
            return sum(1 for c in self._refcount if c > 0)

    @property
    def pages_retained(self) -> int:
        with self.lock:
            return len(self._retained)

    @property
    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale))

    # ------------------------------------------------------------ host side

    def can_alloc(self, n: int) -> bool:
        with self.lock:
            return len(self._free) + len(self._retained) >= n

    def alloc(self, n: int = 1) -> List[int]:
        """n fresh pages (refcount 1 each), evicting LRU retained pages if
        the free list runs short."""
        with self.lock:
            while len(self._free) < n and self._retained:
                self._evict_lru_locked()
            if len(self._free) < n:
                raise PoolExhausted(f"KV page pool exhausted: need {n}, "
                                    f"free {len(self._free)} of {self.n_pages}")
            out = [self._free.pop() for _ in range(n)]
            for pid in out:
                self._refcount[pid] = 1
                self._committed[pid] = False
            return out

    def retain(self, pid: int) -> None:
        """One more row maps an already written (radix-shared) page."""
        with self.lock:
            self._refcount[pid] += 1
            self._retained.pop(pid, None)

    def release(self, pid: int) -> None:
        """A row unmapped the page (finish, cancel). A committed page is
        retained for radix reuse; an uncommitted one is free at once."""
        with self.lock:
            self._refcount[pid] -= 1
            assert self._refcount[pid] >= 0, f"double release of page {pid}"
            if self._refcount[pid] == 0:
                if self._committed[pid]:
                    self._touch_seq += 1
                    self._retained[pid] = self._touch_seq
                else:
                    self._free.append(pid)

    def commit(self, pid: int) -> None:
        """The radix cache adopted this page (it backs a trie node)."""
        with self.lock:
            self._committed[pid] = True

    def decommit(self, pid: int) -> None:
        """The radix cache dropped this page (eviction, clear)."""
        with self.lock:
            self._committed[pid] = False
            if pid in self._retained:
                del self._retained[pid]
                self._free.append(pid)

    def touch(self, pid: int) -> None:
        """LRU bump on a radix match (before the admission retains it)."""
        with self.lock:
            if pid in self._retained:
                self._touch_seq += 1
                self._retained[pid] = self._touch_seq

    def _evict_lru_locked(self) -> None:
        pid = min(self._retained, key=self._retained.get)
        if self._on_evict is not None:
            # the radix cache decommits the page's whole trie subtree
            # (which frees pid itself)
            self._on_evict(pid)
        else:
            self.decommit(pid)
        self.registry.inc("kv.radix_evictions", 1, labels=self.labels)

    def note_hit_tokens(self, n: int) -> None:
        if n > 0:
            self.registry.inc("kv.radix_hit_tokens_total", n, labels=self.labels)
