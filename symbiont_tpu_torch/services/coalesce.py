"""Cross-message upsert coalescing — the ingest write path off lockstep.

Copy of the JAX package's `symbiont_tpu/services/coalesce.py`.

ROADMAP item 3 (the 5× host gap): after the tensor-frame plane removed
per-float serialization, the Python ingest path still paid one
`upsert_rows` store call — a WAL fsync + lock round-trip — per
`data.text.with_embeddings` message (~25 rows). The bulk-ingest tier
amortizes that cost over 10k rows in one call; the live pipeline should
too. `UpsertCoalescer` accumulates the rows of MANY messages and lands
them as one store call, flushing when `max_rows` is reached, when the
oldest pending row has waited `max_age_ms`, or at shutdown.

The ack contract (docs/RESILIENCE.md failure-mode matrix): each message's
`add()` future resolves only when the flush carrying ITS rows has
committed — the service handler awaits it, so the durable delivery is
acked strictly AFTER the store write (or its breaker/WAL spill, which
`ResilientVectorStore` reports as success by design: the spill IS durable).
A crashed flush sets the exception on every waiter in that flush; their
handlers fail, their deliveries stay unacked, and redelivery re-coalesces
them — the deterministic point ids make the retry idempotent, so at-least
-once coalescing never duplicates points (proven by tests/test_coalesce.py
and the chaos suite).

Entries are grouped by embedding dim at flush time: a poison message whose
frame dim mismatches the store fails alone instead of dead-lettering the
healthy messages batched with it (same stance as the native vector_memory
shell's solo-retry).

`store_executor()` is the module's second export: a small dedicated
ThreadPoolExecutor for blocking store calls. Upserts/searches used to ride
the event loop's DEFAULT executor, where a slow WAL fsync competed with
embed forwards and tokenization for the same threads — the ingest stages
serialized on the pool exactly when the pipeline was busiest.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from symbiont_tpu_torch.utils.telemetry import metrics, span

log = logging.getLogger(__name__)

_store_pool: Optional[ThreadPoolExecutor] = None
_store_pool_lock = threading.Lock()


def store_executor() -> ThreadPoolExecutor:
    """Process-shared bounded pool for blocking store WRITES (coalesced
    flushes, upserts). Separate from the default loop executor so a
    blocking WAL fsync can never starve the embed/tokenize stages of
    threads. Reads (search/count) deliberately stay on the default pool —
    they are the latency path and must not queue behind a bulk flush
    holding one of these two workers."""
    global _store_pool
    with _store_pool_lock:
        if _store_pool is None:
            _store_pool = ThreadPoolExecutor(max_workers=2,
                                             thread_name_prefix="store")
        return _store_pool


def upsert_rows_or_points(store, ids, rows, payloads) -> int:
    """One packed block into the store: the fast `upsert_rows` surface when
    the backend has it (embedded store, resilient wrapper), the point-tuple
    surface otherwise (bare external Qdrant) — the zero-copy row views pass
    through either way. Shared by every coalescer flush_fn so both
    coalescer users keep identical store semantics."""
    if hasattr(store, "upsert_rows"):
        return store.upsert_rows(ids, rows, payloads)
    return store.upsert(list(zip(ids, rows, payloads)))


@dataclass
class _PendingUpsert:
    ids: List[str]
    rows: np.ndarray  # [n, dim] f32 (zero-copy frame view or converted)
    payloads: List[dict]
    headers: Optional[dict]
    future: asyncio.Future = field(repr=False)


class UpsertCoalescer:
    """Accumulate (ids, rows, payloads) from many messages into one store
    call. `flush_fn(ids, rows, payloads) -> int` runs on the store
    executor; one flush is in flight at a time (the store serializes writes
    under its own lock anyway, and a single-writer flush keeps the ack
    bookkeeping exact)."""

    def __init__(self, flush_fn: Callable, *, max_rows: int = 512,
                 max_age_ms: float = 25.0, name: str = "vector_memory"):
        if max_rows < 1:
            raise ValueError("coalesce max_rows must be >= 1")
        if max_age_ms <= 0:
            raise ValueError("coalesce max_age_ms must be positive")
        self._flush_fn = flush_fn
        self.max_rows = max_rows
        self.max_age_s = max_age_ms / 1000.0
        self.name = name
        self._pending: List[_PendingUpsert] = []
        self._pending_rows = 0
        self._oldest_t = 0.0
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._draining = False
        self._labels = {"service": name}

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(),
                                             name=f"{self.name}-coalescer")
            metrics.register_weakref_gauge(
                "coalesce.pending_rows", self,
                lambda c: None if c._closed else c._pending_rows,
                labels=self._labels)

    def drain_mode(self) -> None:
        """Drain protocol (resilience/autoscale.py scale-in): from now on
        every pending batch flushes IMMEDIATELY — the age window is
        skipped, so in-flight handlers' ack-waits resolve without waiting
        out `max_age_ms`, and `Service.drain()`'s wait-for-handlers can
        never deadlock behind a long window. New `add()`s still work (a
        handler mid-flight may add after this flips); they flush on the
        next cycle."""
        self._draining = True
        self._wake.set()

    async def stop(self) -> None:
        """Flush-on-stop: everything pending lands (and its acks release)
        before the loop dies — shutdown is a flush trigger, never a drop."""
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self._pending:  # the loop exited before a late add (tests)
            await self._flush("stop")

    async def add(self, ids: Sequence[str], rows, payloads: Sequence[dict],
                  headers: Optional[dict] = None) -> int:
        """Queue one message's rows; resolves with its row count once the
        flush carrying them has committed. Raises what the flush raised —
        the caller's handler then fails and the delivery stays unacked."""
        if self._closed:
            raise RuntimeError("coalescer closed")
        arr = np.asarray(rows, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[0] != len(ids):
            raise ValueError(
                f"rows shape {arr.shape} does not match {len(ids)} ids")
        if len(payloads) != len(ids):
            raise ValueError(f"{len(payloads)} payloads for {len(ids)} ids")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if not self._pending:
            self._oldest_t = time.monotonic()
        self._pending.append(_PendingUpsert(list(ids), arr, list(payloads),
                                            headers, fut))
        self._pending_rows += arr.shape[0]
        metrics.inc("coalesce.messages", labels=self._labels)
        metrics.inc("coalesce.rows", arr.shape[0], labels=self._labels)
        self._wake.set()
        return await fut

    # ------------------------------------------------------------ internals

    async def _run(self) -> None:
        while True:
            if not self._pending:
                if self._closed:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            if (self._pending_rows < self.max_rows and not self._closed
                    and not self._draining):
                # age window: give the next messages a chance to batch up
                wait = self._oldest_t + self.max_age_s - time.monotonic()
                if wait > 0:
                    try:
                        await asyncio.wait_for(self._sleep_until_full(), wait)
                    except asyncio.TimeoutError:
                        pass
            trigger = ("stop" if self._closed
                       else "drain" if self._draining
                       else "rows" if self._pending_rows >= self.max_rows
                       else "age")
            await self._flush(trigger)

    async def _sleep_until_full(self) -> None:
        while (self._pending_rows < self.max_rows and not self._closed
               and not self._draining):
            self._wake.clear()
            await self._wake.wait()

    async def _flush(self, trigger: str) -> None:
        batch, self._pending = self._pending, []
        self._pending_rows = 0
        if not batch:
            return
        # dim groups flush separately: a poison dim fails only its own group
        groups: Dict[int, List[_PendingUpsert]] = {}
        for p in batch:
            groups.setdefault(int(p.rows.shape[1]), []).append(p)
        loop = asyncio.get_running_loop()
        for group in groups.values():
            ids: List[str] = []
            payloads: List[dict] = []
            for p in group:
                ids.extend(p.ids)
                payloads.extend(p.payloads)
            # per GROUP, not per cycle: each group is its own store call,
            # so `coalesce.flushes` counts store calls and `flush_rows` is
            # the real rows-per-call amortization factor
            metrics.inc("coalesce.flushes", labels={**self._labels,
                                                    "trigger": trigger})
            metrics.observe("coalesce.flush_rows", len(ids),
                            labels=self._labels)
            rows = (group[0].rows if len(group) == 1
                    else np.concatenate([p.rows for p in group], axis=0))
            try:
                # the span rides the FIRST message's trace context: one
                # ingest trace per flush shows the real store write it
                # shared (the other messages' handler spans cover their
                # ack-wait on this same flush)
                with span(f"{self.name}.flush", group[0].headers,
                          rows=len(ids), messages=len(group)):
                    await loop.run_in_executor(
                        store_executor(), self._flush_fn, ids, rows, payloads)
            except Exception as e:
                log.exception("%s: coalesced flush of %d rows from %d "
                              "messages failed", self.name, len(ids),
                              len(group))
                metrics.inc("coalesce.flush_failures", labels=self._labels)
                for p in group:
                    if not p.future.done():
                        p.future.set_exception(e)
                continue
            for p in group:
                if not p.future.done():
                    p.future.set_result(len(p.ids))
