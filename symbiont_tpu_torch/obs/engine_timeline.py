"""The engine's flush timeline, embed half.

The port's copy of the embed side of `symbiont_tpu/obs/engine_timeline.py`:
a bounded ring of one event per dispatched embed or rerank batch (bucket,
rows, real and padded token slots), recorded by `TorchEngine._note_padding`
from host numbers already in hand, and the windowed packing-opportunity
estimate `engine.packing_opportunity_pct`: the share of dispatched token
slots that carried padding, which perfect sequence packing would reclaim.
`summary` gives the embed fields of the JAX summary.

The decode half (steps, admits, KV occupancy, the prefix probe) comes with
the LM engine (ROADMAP Queue A, item 11).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

FLUSH = "flush"


class EngineTimeline:
    """Thread-safe bounded ring of flush events with a windowed packing
    estimate."""

    def __init__(self, capacity: int = 2048, registry: Optional[Metrics] = None):
        self.registry = registry if registry is not None else _global_metrics
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        # packing-opportunity window over recent flushes
        self._flushes: deque = deque(maxlen=128)
        self._flush_real = 0
        self._flush_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def note_embed_flush(self, bucket: int, batch_rows: int, n_real: int,
                         real_tokens: int, total_tokens: int) -> None:
        """One dispatched embed/rerank batch."""
        with self._lock:
            self._ring.append({"kind": FLUSH, "t": time.time(), "bucket": int(bucket),
                               "batch_rows": int(batch_rows), "n_real": int(n_real),
                               "real_tokens": int(real_tokens),
                               "total_tokens": int(total_tokens)})
            if len(self._flushes) == self._flushes.maxlen:
                old_real, old_total = self._flushes[0]
                self._flush_real -= old_real
                self._flush_total -= old_total
            self._flushes.append((int(real_tokens), int(total_tokens)))
            self._flush_real += int(real_tokens)
            self._flush_total += int(total_tokens)
            total, real = self._flush_total, self._flush_real
        if total > 0:  # the registry has its own lock
            self.registry.gauge_set("engine.packing_opportunity_pct",
                                    round(100.0 * (1.0 - real / total), 2),
                                    labels={"service": "engine"})

    def summary(self) -> dict:
        """The embed fields of the JAX timeline's summary, over the ring."""
        flushes = [e for e in self.events() if e["kind"] == FLUSH]
        real = sum(e["real_tokens"] for e in flushes)
        total = sum(e["total_tokens"] for e in flushes)
        padding_pct = round(100.0 * (total - real) / total, 2) if total else 0.0
        if not flushes:
            stall = "no engine traffic recorded"
        elif padding_pct < 10.0:
            stall = "none dominant (all measured waste < 10%)"
        else:
            stall = f"embed padding (packing opportunity {padding_pct}%)"
        return {"embed_flushes": len(flushes), "embed_padding_pct": padding_pct,
                "packing_opportunity_pct": padding_pct, "dominant_stall": stall}


engine_timeline = EngineTimeline()
