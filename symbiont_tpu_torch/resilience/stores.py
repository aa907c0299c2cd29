"""Breaker + spill wrappers for the store backends (graceful degradation).

Copy of the JAX package's `symbiont_tpu/resilience/stores.py`.

`utils/retry.py` retries the STARTUP connect; these wrappers own the MID-RUN
outage. Policy per the resilience plan (docs/RESILIENCE.md):

- writes: tried through the circuit breaker; on failure (or an already-open
  breaker failing fast) the batch is SPILLED to a local JSONL WAL and the
  call reports success — the bus handler acks, the ingest pipeline keeps
  flowing, nothing is lost. The next write that gets through the breaker
  (typically the half-open probe) REPLAYS the spill first, preserving rough
  arrival order. Spill survives a process restart (the file is reloaded at
  construction). Safe because both backends take idempotent writes:
  deterministic vector point ids overwrite, graph MERGE re-merges.
- reads: tried through the breaker; when it is open, an optional embedded
  fallback store serves (stale but available) results, else the caller gets
  a fast CircuitOpenError instead of a hung HTTP timeout.
- config errors (ValueError — e.g. a dim mismatch) propagate immediately
  and never count as breaker failures: retrying cannot fix them.

Wrappers are duck-typed passthroughs (`__getattr__` delegates anything not
overridden), so the engine plane and health paths see the inner surface.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from symbiont_tpu_torch.resilience import faults
from symbiont_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)


class _SpillJournal:
    """Append-only JSONL spill with an in-memory mirror. File-backed when a
    path is given (entries survive a crash during the outage), purely
    in-memory otherwise (tests, ephemeral deployments)."""

    def __init__(self, path: Optional[str], what: str):
        self.what = what
        self.path = Path(path) if path else None
        self._entries: List[dict] = []
        self._lock = threading.Lock()
        if self.path is not None and self.path.exists():
            with open(self.path, encoding="utf-8") as f:
                for ln, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._entries.append(json.loads(line))
                    except ValueError:
                        log.warning("%s spill %s: skipping corrupt line %d",
                                    what, self.path, ln)
            if self._entries:
                log.warning("%s: %d spilled entries recovered from %s — "
                            "will replay on backend recovery",
                            what, len(self._entries), self.path)

    def append(self, entries: Sequence[dict]) -> None:
        with self._lock:
            if self.path is not None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.path, "a", encoding="utf-8") as f:
                    for e in entries:
                        f.write(json.dumps(e) + "\n")
                    f.flush()
                    import os
                    os.fsync(f.fileno())
            self._entries.extend(entries)
        metrics.gauge_set(f"{self.what}.spill_pending", len(self._entries))

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            if self.path is not None and self.path.exists():
                self.path.unlink()
        metrics.gauge_set(f"{self.what}.spill_pending", 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ResilientVectorStore:
    """Vector-store surface (ensure_collection/upsert/search/count) through
    a circuit breaker, with WAL spill for writes and an optional embedded
    read fallback for searches while the breaker is open."""

    def __init__(self, inner, breaker: Optional[CircuitBreaker] = None,
                 spill_path: Optional[str] = None, fallback=None):
        self.inner = inner
        self.breaker = breaker or CircuitBreaker("vector_store")
        self.fallback = fallback
        self._spill = _SpillJournal(spill_path, "vector_store")
        self._lock = threading.RLock()

    @property
    def supports_fused(self) -> bool:
        return getattr(self.inner, "supports_fused", False)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ------------------------------------------------------------- internal

    def _inner_upsert(self, points):
        plan = faults.active_plan()
        if plan is not None:
            plan.sync_fault("store.upsert", self.breaker.name)
        return self.inner.upsert(points)

    def _inner_upsert_rows(self, ids, rows, payloads):
        plan = faults.active_plan()
        if plan is not None:
            plan.sync_fault("store.upsert", self.breaker.name)
        if hasattr(self.inner, "upsert_rows"):
            return self.inner.upsert_rows(ids, rows, payloads)
        # backends without the tensor-frame fast path (external Qdrant):
        # hand the row views through the point-tuple surface
        return self.inner.upsert(list(zip(ids, rows, payloads)))

    def _inner_search(self, query, top_k):
        plan = faults.active_plan()
        if plan is not None:
            plan.sync_fault("store.search", self.breaker.name)
        return self.inner.search(query, top_k)

    def _replay_pending(self) -> None:
        """Push the spill through the breaker (caller holds the lock).
        Raises on failure — the caller's batch then spills behind it."""
        pending = self._spill.snapshot()
        if not pending:
            return
        points = [(e["id"], e["vector"], e["payload"]) for e in pending]
        self.breaker.call(self._inner_upsert, points, fatal=(ValueError,))
        self._spill.clear()
        metrics.inc("store.replayed_points", len(points),
                    labels={"store": self.breaker.name})
        log.info("%s: replayed %d spilled points after recovery",
                 self.breaker.name, len(points))

    # -------------------------------------------------------------- surface

    def ensure_collection(self, dim: Optional[int] = None) -> None:
        # startup path: connect_retry inside the backend already owns this
        self.inner.ensure_collection(dim)

    def upsert(self, points: Sequence[Tuple[str, Sequence[float], dict]]) -> int:
        if not points:
            return 0
        with self._lock:
            try:
                self._replay_pending()
                return self.breaker.call(self._inner_upsert, list(points),
                                         fatal=(ValueError,))
            except ValueError:
                raise  # config error: spilling it would replay forever
            except Exception as e:
                self._spill.append([
                    {"id": pid, "vector": [float(x) for x in vec],
                     "payload": payload}
                    for pid, vec, payload in points])
                metrics.inc("store.spilled_points", len(points),
                            labels={"store": self.breaker.name})
                log.warning(
                    "%s: upsert failed (%s: %s) — %d points spilled to WAL "
                    "(%d pending) for replay on recovery", self.breaker.name,
                    type(e).__name__, e, len(points), len(self._spill))
                return len(points)

    def upsert_rows(self, ids, rows, payloads=None) -> int:
        """Tensor-frame ingest under the same breaker/spill policy as
        upsert(): the packed block stays intact on the happy path and
        degrades to per-point spill entries only when the backend is down
        (the spill is JSONL — float lists are its durable format)."""
        ids = list(ids)
        if not ids:
            return 0
        payloads = ([{}] * len(ids) if payloads is None else list(payloads))
        with self._lock:
            try:
                self._replay_pending()
                return self.breaker.call(self._inner_upsert_rows, ids, rows,
                                         payloads, fatal=(ValueError,))
            except ValueError:
                raise  # config error: spilling it would replay forever
            except Exception as e:
                import numpy as np

                vec_lists = np.asarray(rows, np.float32).tolist()
                self._spill.append([
                    {"id": pid, "vector": vec, "payload": payload}
                    for pid, vec, payload in zip(ids, vec_lists, payloads)])
                metrics.inc("store.spilled_points", len(ids),
                            labels={"store": self.breaker.name})
                log.warning(
                    "%s: upsert_rows failed (%s: %s) — %d points spilled to "
                    "WAL (%d pending) for replay on recovery",
                    self.breaker.name, type(e).__name__, e, len(ids),
                    len(self._spill))
                return len(ids)

    def search(self, query: Sequence[float], top_k: int):
        try:
            return self.breaker.call(self._inner_search, query, top_k,
                                     fatal=(ValueError,))
        except CircuitOpenError:
            if self.fallback is not None:
                metrics.inc("store.fallback_searches",
                            labels={"store": self.breaker.name})
                return self.fallback.search(query, top_k)
            raise

    def count(self) -> int:
        return self.inner.count()

    def spill_pending(self) -> int:
        return len(self._spill)

    def replay_spill(self) -> int:
        """Operator surface: force a replay attempt now (also exercised by
        the chaos suite). Returns points replayed; raises if the backend is
        still down."""
        with self._lock:
            n = len(self._spill)
            self._replay_pending()
            return n


class ResilientGraphStore:
    """Graph-store surface (ensure_schema/save_tokenized/counts/close)
    through a circuit breaker with document spill."""

    def __init__(self, inner, breaker: Optional[CircuitBreaker] = None,
                 spill_path: Optional[str] = None):
        self.inner = inner
        self.breaker = breaker or CircuitBreaker("graph_store")
        self._spill = _SpillJournal(spill_path, "graph_store")
        self._lock = threading.RLock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _inner_save(self, msg) -> int:
        plan = faults.active_plan()
        if plan is not None:
            plan.sync_fault("graph.save", self.breaker.name)
        return self.inner.save_tokenized(msg)

    def _replay_pending(self) -> None:
        from symbiont_tpu_torch.schema import TokenizedTextMessage, from_dict

        pending = self._spill.snapshot()
        if not pending:
            return
        for entry in pending:
            self.breaker.call(self._inner_save,
                              from_dict(TokenizedTextMessage, entry),
                              fatal=(ValueError,))
        self._spill.clear()
        metrics.inc("store.replayed_docs", len(pending),
                    labels={"store": self.breaker.name})
        log.info("%s: replayed %d spilled documents after recovery",
                 self.breaker.name, len(pending))

    def ensure_schema(self) -> None:
        self.inner.ensure_schema()

    def save_tokenized(self, msg) -> int:
        import dataclasses

        with self._lock:
            try:
                self._replay_pending()
                return self.breaker.call(self._inner_save, msg,
                                         fatal=(ValueError,))
            except ValueError:
                raise
            except Exception as e:
                self._spill.append([dataclasses.asdict(msg)])
                metrics.inc("store.spilled_docs",
                            labels={"store": self.breaker.name})
                log.warning(
                    "%s: save failed (%s: %s) — document spilled to WAL "
                    "(%d pending) for replay on recovery", self.breaker.name,
                    type(e).__name__, e, len(self._spill))
                return -1

    def counts(self):
        return self.inner.counts()

    def close(self) -> None:
        self.inner.close()

    def spill_pending(self) -> int:
        return len(self._spill)

    def replay_spill(self) -> int:
        with self._lock:
            n = len(self._spill)
            self._replay_pending()
            return n
