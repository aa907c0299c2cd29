"""The compute plane's dispatch ledger.

The port's copy of `symbiont_tpu/obs/xprof.py`'s `DispatchLedger`: one row
per call signature (`embed[L=..,B=..]`, `qsearch[...]`, `rerank[...]`) with
its dispatch count and the host wall spent enqueuing it, plus
`engine.host_syncs_total{site}`, the device → host fetches per call site.
The counter families keep the JAX package's names
(`xla.dispatches_total{executable}`), so one dashboard reads both.

`note_compile` counts each capture of an engine's CUDA graph (the port's
executables, `graphs.py`) as the JAX ledger counts a compile; the
cost and memory analysis the JAX ledger takes from XLA is not read, so
those fields stay unset (A7's rest). The on-demand
`DeviceTraceCapture` is one of A7's leftovers (ROADMAP); the gateway's
`POST /api/profile/device` answers 501 until it lands.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from symbiont_tpu_torch.utils.telemetry import metrics


# the host-sync sites the port's engines count at, each exported at zero
# by `register_zero` so a site that never fires still shows (the JAX
# package reads its list from the lint allowlist)
KNOWN_SYNC_SITES = (
    "LmEngine._generate_stream_impl",
    "TorchEngine.embed_and_search",
    "TorchEngine.embed_texts",
    "TorchEngine.rerank",
    "TorchEngine.warmup",
)


class _SigStats:
    __slots__ = ("dispatches", "wall_s", "compiles")

    def __init__(self) -> None:
        self.dispatches = 0
        self.wall_s = 0.0
        self.compiles = 0


class DispatchLedger:
    """Bounded per-signature dispatch table (least recently used rows go
    past `max_executables`)."""

    def __init__(self, max_executables: int = 256, registry=None) -> None:
        self.registry = registry if registry is not None else metrics
        self._lock = threading.Lock()
        self._rows: "OrderedDict[str, _SigStats]" = OrderedDict()
        self._max = max(1, int(max_executables))
        self._enabled = True

    def configure(self, enabled: bool = True,
                  max_executables: Optional[int] = None) -> None:
        with self._lock:
            self._enabled = bool(enabled)
            if max_executables is not None:
                self._max = max(1, int(max_executables))
                while len(self._rows) > self._max:
                    self._rows.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

    def _entry(self, signature: str) -> _SigStats:
        # caller holds self._lock
        st = self._rows.get(signature)
        if st is None:
            st = self._rows[signature] = _SigStats()
            while len(self._rows) > self._max:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(signature)
        return st

    def note_dispatch(self, signature: str, wall_s: float) -> None:
        """One call of `signature` and the host wall around its enqueue."""
        if not self._enabled:
            return
        with self._lock:
            st = self._entry(signature)
            st.dispatches += 1
            st.wall_s += wall_s
        self.registry.inc("xla.dispatches_total", labels={"executable": signature})

    def note_compile(self, signature: str, cost: Optional[dict],
                     memory: Optional[dict] = None) -> None:
        """First call of an executable: its capture. `cost` and `memory`
        keep the JAX signature; the port passes None (not analysed)."""
        del cost, memory
        if not self._enabled:
            return
        with self._lock:
            self._entry(signature).compiles += 1

    def note_host_sync(self, site: str, n: int = 1) -> None:
        """`n` device → host fetches at `site`."""
        if not self._enabled:
            return
        self.registry.inc("engine.host_syncs_total", n, labels={"site": site})

    def register_zero(self) -> None:
        """The ledger's counter families at zero, one host-sync series per
        known site, so `/metrics` shows them before any traffic."""
        self.registry.inc("xla.dispatches_total", 0, labels={"executable": "all"})
        for site in KNOWN_SYNC_SITES:
            self.registry.inc("engine.host_syncs_total", 0, labels={"site": site})

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def snapshot(self) -> list:
        """Per-signature rows, most dispatches first."""
        with self._lock:
            rows = [(sig, st.dispatches, st.wall_s, st.compiles)
                    for sig, st in self._rows.items()]
        out = [{"executable": sig, "dispatches": n, "compiles": compiles,
                "host_wall_ms": round(wall * 1000.0, 3),
                "mean_dispatch_us": round(wall / n * 1e6, 1) if n else 0.0}
               for sig, n, wall, compiles in rows]
        out.sort(key=lambda r: -r["dispatches"])
        return out


dispatch_ledger = DispatchLedger()
