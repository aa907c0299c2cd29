"""Async micro-batching queues in front of the engines.

The port's copy of `symbiont_tpu/engine/batcher.py`. Two policies over one
loop (`_BatcherBase`: wake on a submission, wait up to the flush deadline
for the batch to fill, then flush at most `max_batch` items, with up to
`max_inflight_flushes` flushes in the air):

- `MicroBatcher` (embedding): aggregates submissions and embeds them in
  one `TorchEngine.embed_texts` call on an executor thread, so two flushes
  can be in flight on one engine (`EngineConfig.max_inflight_flushes`).
- `GenBatcher` (generation): requests that arrive within one flush window
  start a decode session together (`LmEngine.start_session`), and at every
  chunk boundary queued requests join it in free rows
  (`BatchSession.can_admit`, `prepare_admit` on an executor thread
  overlapped with the next chunk, then `splice`). It serves one flush at a
  time and drives the engine by duck type.

`TenantLanes` keeps per-tenant bounded FIFO lanes drained in stride-fair
order (`resilience/admission.py`'s `StrideClock`), so a tenant with 80
queued requests interleaves 1:1 with one holding 2.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.obs.usage import usage
from symbiont_tpu_torch.resilience.admission import (
    DEFAULT_TENANT,
    OVERFLOW_TENANT,
    AdmissionReject,
    StrideClock,
)
from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

# distinct tenant lanes a batcher keeps before new identities share the
# overflow lane (tenant names come from clients)
MAX_TENANT_LANES = 256

# a tenant's interactive work (a query embed) rides the lane "<tenant>#q",
# which the stride clock interleaves with the same tenant's bulk lane, so
# a query never waits out its own tenant's ingest backlog
INTERACTIVE_LANE_SUFFIX = "#q"


def interactive_lane(tenant: str) -> str:
    """The fairness-lane identity for one tenant's interactive work."""
    return f"{tenant}{INTERACTIVE_LANE_SUFFIX}"


class TenantLanes:
    """Per-tenant FIFO lanes drained in stride-fair order. One tenant
    behaves exactly as one FIFO deque. A full lane refuses with
    `AdmissionReject`: memory stays bounded behind the device.

    It has the deque surface the batcher uses (`len`, truth, iteration in
    drain order without consuming) and the fair
    `append/peek/popleft/requeue_front/drain_fair` cycle. Items without a
    `.tenant` ride the default lane. Every tenant weighs the same here, as
    in the JAX batchers, which pass their lanes no weights."""

    def __init__(self, kind: str = "batcher", max_per_tenant: int = 0):
        self.kind = kind
        self.max_per_tenant = int(max_per_tenant)
        self._clock = StrideClock()
        self._lanes: "dict[str, deque]" = {}
        # the bound counts identities ever seen, so a client cycling fresh
        # names one request at a time grows no clock state either
        self._seen: set = {DEFAULT_TENANT}
        self._n = 0

    def _lane_key(self, item) -> str:
        tenant = getattr(item, "tenant", None) or DEFAULT_TENANT
        if tenant in self._seen:
            return tenant
        if len(self._seen) >= MAX_TENANT_LANES:
            return OVERFLOW_TENANT
        self._seen.add(tenant)
        return tenant

    def _gauge(self, tenant: str) -> None:
        metrics.gauge_set("batcher.tenant_depth", len(self._lanes.get(tenant, ())),
                          labels={"batcher": self.kind, "tenant": tenant})

    def _drop_if_empty(self, tenant: str) -> None:
        lane = self._lanes.get(tenant)
        if lane is not None and not lane:
            del self._lanes[tenant]
            self._clock.forget(tenant)

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        return iter(self.fair_order())

    def fair_order(self) -> List:
        """Every queued item in the order popleft() would serve it,
        computed on copies."""
        clock = self._clock.snapshot()
        lanes = {t: list(q) for t, q in self._lanes.items() if q}
        out: List = []
        while lanes:
            tenant = clock.pick(lanes)
            lane = lanes[tenant]
            out.append(lane.pop(0))
            clock.charge(tenant)
            if not lane:
                del lanes[tenant]
        return out

    def append(self, item) -> None:
        tenant = self._lane_key(item)
        lane = self._lanes.setdefault(tenant, deque())
        if self.max_per_tenant and len(lane) >= self.max_per_tenant:
            self._drop_if_empty(tenant)
            metrics.inc("batcher.lane_rejected", labels={"batcher": self.kind, "tenant": tenant})
            raise AdmissionReject(
                "engine_lane_full", retry_after_s=1.0,
                message=f"tenant {tenant!r} {self.kind} lane is full "
                        f"({self.max_per_tenant} queued at the engine)")
        lane.append(item)
        self._n += 1
        self._gauge(tenant)

    def peek(self):
        """The item the next popleft() returns; None when empty."""
        tenant = self._clock.pick(t for t, q in self._lanes.items() if q)
        return None if tenant is None else self._lanes[tenant][0]

    def popleft(self):
        tenant = self._clock.pick(t for t, q in self._lanes.items() if q)
        if tenant is None:
            raise IndexError("pop from empty TenantLanes")
        item = self._lanes[tenant].popleft()
        self._clock.charge(tenant)
        self._n -= 1
        self._gauge(tenant)
        self._drop_if_empty(tenant)
        return item

    def requeue_front(self, items: List) -> None:
        """Taken but unserved items go back to the front of their own
        lanes in their original order."""
        per_lane: "dict[str, List]" = {}
        for item in items:
            per_lane.setdefault(self._lane_key(item), []).append(item)
        for tenant, block in per_lane.items():
            lane = self._lanes.setdefault(tenant, deque())
            lane.extendleft(reversed(block))  # extendleft reverses its argument
            self._n += len(block)
            self._gauge(tenant)

    def drain_fair(self) -> List:
        """Pop everything in fair order."""
        out: List = []
        while self._n:
            out.append(self.popleft())
        return out

    def oldest_submit(self) -> Optional[float]:
        """The earliest `_t_submit` of the lane heads (each lane is FIFO)."""
        times = [getattr(q[0], "_t_submit", None) for q in self._lanes.values() if q]
        times = [t for t in times if t is not None]
        return min(times) if times else None


class _BatcherBase:
    """Queue + wake + deadline-flush loop shared by the embed and generation
    batchers. Subclasses define `_size(item)` (how much of max_batch an item
    consumes) and `_flush(batch)` (resolve every item's future).

    `max_inflight_flushes` > 1 lets the loop start flush N+1 while flush N's
    results are still materializing — on a network-attached device a flush
    tail is ~an RTT of pure waiting, so overlapping flushes keeps the chip
    fed (the engine's entry points are thread-safe by design; see
    engine.py's concurrency contract): batch N+1 tokenizes/pads/dispatches
    on its own executor thread while batch N's forward runs. Generation
    keeps it at 1: decode sessions admit newcomers at chunk boundaries
    instead, and two sessions would only contend on the LM lock.

    Result-order contract under overlap: each submission's future is bound
    to its exact slice of its OWN flush, so flush N+1 completing before
    flush N (a short batch overtaking a long one) resolves the later
    submitters first but can never mis-route rows — per-submission results
    are positionally exact regardless of flush completion order (pinned by
    tests/test_coalesce.py's slow-forward ordering test).

    Live accounting for the double-buffering (engine-plane gauges):
    `batcher.inflight` is the flush count currently in the air and
    `batcher.overlap_ratio` is the fraction of cumulative flush seconds
    that ran concurrently with another flush — 0.0 means lockstep (no
    overlap won), approaching 1-1/k means the window of k stayed full."""

    # metric label distinguishing the two policies over one registry
    kind = "batcher"

    def __init__(self, max_batch: int, deadline_s: float,
                 max_inflight_flushes: int = 1, lane_depth: int = 0):
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        # per-tenant bounded lanes drained stride-fair (TenantLanes): the
        # single-tenant case degenerates to the old FIFO deque; under a
        # multi-tenant backlog the chunk composition interleaves tenants so
        # an edge-bypassing hot tenant cannot starve the rest at the device
        self._queue: TenantLanes = TenantLanes(kind=self.kind,
                                               max_per_tenant=lane_depth)
        self._queued = 0
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._inflight = asyncio.Semaphore(max_inflight_flushes)
        self._flushes: set = set()
        # overlap accounting (all touched on the event-loop thread only):
        # span = Σ individual flush durations; busy = wall seconds with ≥1
        # flush in flight. span - busy is flush time that OVERLAPPED another
        # flush — overlap_ratio = 1 - busy/span.
        self._inflight_n = 0
        self._busy_since = 0.0
        self._flush_busy_s = 0.0
        self._flush_span_s = 0.0

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(
                self._run(), name=type(self).__name__)
            self._register_gauges()

    def _register_gauges(self) -> None:
        """Engine-plane queue gauges, read at scrape time. Weakref-bound
        (register_weakref_gauge): a dead or closed batcher's gauges retire
        themselves — tests churn through batchers and the registry must not
        pin them."""
        labels = {"service": "engine", "batcher": self.kind}

        def depth(b):
            return None if b._closed else b._queued

        def oldest_wait_s(b):
            if b._closed:
                return None
            if not b._queue:
                return 0.0
            # per-lane FIFO (requeues go to the FRONT), so the oldest item
            # is the earliest lane head
            t = b._queue.oldest_submit()
            return 0.0 if t is None else max(0.0, time.monotonic() - t)

        def inflight(b):
            return None if b._closed else b._inflight_n

        def overlap_ratio(b):
            if b._closed:
                return None
            span = b._flush_span_s
            if span <= 0.0:
                return 0.0
            return round(max(0.0, 1.0 - b._flush_busy_s / span), 4)

        metrics.register_weakref_gauge("batcher.queue_depth", self, depth,
                                       labels=labels)
        metrics.register_weakref_gauge("batcher.oldest_wait_s", self,
                                       oldest_wait_s, labels=labels)
        metrics.register_weakref_gauge("batcher.inflight", self, inflight,
                                       labels=labels)
        metrics.register_weakref_gauge("batcher.overlap_ratio", self,
                                       overlap_ratio, labels=labels)

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self._flushes:
            await asyncio.gather(*self._flushes, return_exceptions=True)
        # a flush can re-queue items (splice rejection, unadmittable keep)
        # after _run has already exited — with no loop left to serve them,
        # their futures would hang forever. All flushes are done now, so the
        # queue is final: fail what's left.
        leftovers = self._queue.drain_fair()
        self._queued = 0
        for item in leftovers:
            if not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))

    def _submit(self, item) -> None:
        if self._closed:
            raise RuntimeError("batcher closed")
        item._t_submit = time.monotonic()  # queue-age gauge reads this
        self._queue.append(item)
        self._queued += self._size(item)
        self._wake.set()

    def _requeue(self, items: List) -> None:
        """Put stolen-but-unserved items back, ahead of anything submitted
        meanwhile (preserve per-lane arrival order), and wake the run loop —
        it may have parked on a cleared _wake after the steal emptied the
        queue; without a wake the re-queued items sit unserved until an
        unrelated submission arrives."""
        if not items:
            return
        self._queue.requeue_front(items)
        self._queued += sum(self._size(k) for k in items)
        self._wake.set()

    def _take_chunk(self) -> List:
        """Pop up to max_batch's worth of items (always at least one),
        composed across tenant lanes in stride-fair order."""
        taken: List = []
        size = 0
        while self._queue and (not taken
                               or size + self._size(self._queue.peek()) <= self.max_batch):
            item = self._queue.popleft()
            size += self._size(item)
            taken.append(item)
        self._queued -= size
        if taken:
            labels = {"service": "engine", "batcher": self.kind}
            fill = size / self.max_batch if self.max_batch else 0.0
            metrics.observe("batcher.flush_fill_ratio", fill, labels=labels)
            metrics.gauge_set("batcher.last_flush_fill_ratio", round(fill, 4),
                              labels=labels)
            # decode-plane flight recorder: queue depth AFTER the take —
            # the backlog a flush boundary leaves behind, on the same time
            # axis as the step/flush counters (obs/engine_timeline.py)
            engine_timeline.note_queue_depth(self.kind, self._queued)
        return taken

    async def _run(self) -> None:
        while True:
            if not self._queue:
                if self._closed:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            if self._queued < self.max_batch and not self._closed:
                # deadline flush: give late arrivals a short window to batch up
                try:
                    await asyncio.wait_for(self._sleep_until_full(),
                                           self.deadline_s)
                except asyncio.TimeoutError:
                    pass
            await self._inflight.acquire()
            chunk = self._take_chunk()
            if not chunk:
                # an in-flight session's chunk-boundary admission can drain
                # the queue while we waited on the semaphore
                self._inflight.release()
                continue
            t = asyncio.create_task(self._flush_release(chunk))
            self._flushes.add(t)
            t.add_done_callback(self._flushes.discard)

    async def _flush_release(self, batch: List) -> None:
        t0 = time.monotonic()
        self._inflight_n += 1
        if self._inflight_n == 1:
            self._busy_since = t0
        try:
            await self._flush(batch)
        finally:
            self._inflight.release()
            t1 = time.monotonic()
            self._flush_span_s += t1 - t0
            self._inflight_n -= 1
            if self._inflight_n == 0:
                self._flush_busy_s += t1 - self._busy_since

    async def _sleep_until_full(self) -> None:
        while self._queued < self.max_batch and not self._closed:
            self._wake.clear()
            await self._wake.wait()

    # subclass interface -----------------------------------------------------

    def _size(self, item) -> int:
        raise NotImplementedError

    async def _flush(self, batch: List) -> None:
        raise NotImplementedError


@dataclass
class _Pending:
    texts: List[str]
    future: asyncio.Future
    # engine-plane fairness: the lane this item queues in (bus-header tenant
    # threaded down by the calling service; default lane otherwise)
    tenant: str = DEFAULT_TENANT


class MicroBatcher(_BatcherBase):
    kind = "embed"

    def __init__(self, engine: TorchEngine, max_batch: Optional[int] = None,
                 flush_deadline_ms: Optional[float] = None,
                 max_inflight_flushes: Optional[int] = None,
                 lane_depth: Optional[int] = None):
        deadline = (flush_deadline_ms if flush_deadline_ms is not None
                    else engine.config.flush_deadline_ms) / 1000.0
        from symbiont_tpu_torch.config import EngineConfig

        mb = max_batch or engine.config.max_batch
        # mesh-aware flush sizing (docs/SCALING.md): round the flush cap up
        # to a multiple of the mesh 'data' axis so a full flush splits into
        # EVEN replica shards — a cap of, say, 100 over 8 replicas would
        # batch-bucket to 104 and ship 4 permanent pad rows per full flush.
        # Stub engines without DP accounting (tests) default to 1.
        nd = getattr(engine, "_n_data", 1)
        if nd > 1:
            mb = ((mb + nd - 1) // nd) * nd
        super().__init__(mb, deadline,
                         max_inflight_flushes=(
                             max_inflight_flushes
                             if max_inflight_flushes is not None
                             # duck-typed test configs may predate the
                             # field; fall back to the REAL dataclass
                             # default so a future tuning there is never
                             # shadowed by a stale literal here
                             else getattr(
                                 engine.config, "max_inflight_flushes",
                                 EngineConfig.max_inflight_flushes)),
                         lane_depth=(
                             lane_depth if lane_depth is not None
                             else getattr(engine.config, "tenant_lane_depth",
                                          EngineConfig.tenant_lane_depth)))
        self.engine = engine

    async def embed(self, texts: Sequence[str],
                    tenant: Optional[str] = None) -> np.ndarray:
        """Submit texts; resolves with [n, dim] when their batch flushes.
        `tenant` picks the fairness lane (engine-plane fairness survives
        edge bypass — docs/RESILIENCE.md); None rides the default lane."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._submit(_Pending(list(texts), fut,
                              tenant=tenant or DEFAULT_TENANT))
        return await fut

    def _size(self, item: _Pending) -> int:
        return len(item.texts)

    @staticmethod
    def _usage_tenant(lane: str) -> str:
        """The BILLING identity behind a fairness lane: interactive lanes
        ('<tenant>#q') charge the tenant itself — the lane split is a
        scheduling detail, not a second customer."""
        if lane.endswith(INTERACTIVE_LANE_SUFFIX):
            return lane[: -len(INTERACTIVE_LANE_SUFFIX)] or DEFAULT_TENANT
        return lane

    async def _flush(self, batch: List) -> None:
        texts: List[str] = []
        for p in batch:
            texts.extend(p.texts)
            # usage ledger (obs/usage.py): embed rows billed per tenant at
            # the flush that carries them
            usage.note(self._usage_tenant(p.tenant), embed_rows=len(p.texts))
        try:
            # off the event loop: the forward is host- and device-bound
            vecs = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.embed_texts, texts)
            offset = 0
            for p in batch:
                n = len(p.texts)
                if not p.future.cancelled():
                    p.future.set_result(vecs[offset:offset + n])
                offset += n
        except Exception as e:  # propagate to every waiter
            log.exception("batch embed failed")
            for p in batch:
                if not p.future.cancelled():
                    p.future.set_exception(e)


@dataclass
class _PendingGen:
    prompt: str
    max_new: int
    temperature: float
    top_k: int
    future: asyncio.Future
    # anything with .is_set() (an asyncio.Event): checked at every chunk
    # boundary; a cancelled request's row frees and its future gets None
    cancel: Optional[object] = None
    tenant: str = DEFAULT_TENANT  # the fairness lane
    task_id: Optional[str] = None

    def cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.is_set()


class GenBatcher(_BatcherBase):
    """Continuous batching for generation. Requests that arrive within one
    flush window start a session together; at every chunk boundary queued
    requests join it in free rows when their budget fits the steps left
    and their prompt fits the session's prompt bucket, and otherwise wait
    for the next session. Per-request temperature and top_k ride as per-row
    values; requests group by new-token bucket. One flush is served at a
    time: sessions take newcomers at chunk boundaries instead, and two
    sessions would only contend on the LM lock."""

    kind = "generate"

    def __init__(self, lm, max_batch: Optional[int] = None,
                 flush_deadline_ms: Optional[float] = None, lane_depth: Optional[int] = None):
        from symbiont_tpu_torch.config import LmConfig

        cfg = lm.config
        deadline = (flush_deadline_ms if flush_deadline_ms is not None
                    else cfg.gen_flush_deadline_ms) / 1000.0
        if lane_depth is None:
            lane_depth = getattr(cfg, "gen_tenant_lane_depth", LmConfig.gen_tenant_lane_depth)
        super().__init__(max_batch or cfg.gen_max_batch, deadline, lane_depth=lane_depth)
        self.lm = lm
        self.stats = {"sessions": 0, "admitted_midflight": 0}

    async def generate(self, prompt: str, max_new_tokens: int,
                       temperature: Optional[float] = None, top_k: Optional[int] = None,
                       cancel: Optional[object] = None, tenant: Optional[str] = None,
                       task_id: Optional[str] = None) -> Optional[str]:
        """The generated text, or None when `cancel` was set while the
        request decoded (its row freed at a chunk boundary). `tenant` picks
        the fairness lane."""
        cfg = self.lm.config
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._submit(_PendingGen(prompt, int(max_new_tokens), float(temperature), int(top_k),
                                 fut, cancel=cancel, tenant=tenant or DEFAULT_TENANT,
                                 task_id=task_id))
        return await fut

    def _size(self, item: _PendingGen) -> int:
        return 1

    def _bucket(self, max_new: int) -> int:
        for b in self.lm.config.new_token_buckets:
            if max_new <= b:
                return b
        return self.lm.config.new_token_buckets[-1]

    async def _flush(self, batch: List) -> None:
        loop = asyncio.get_running_loop()
        groups: dict = {}
        for p in batch:
            groups.setdefault(self._bucket(p.max_new), []).append(p)
        for group in groups.values():
            # requests cancelled in the flush window never enter a session
            for p in group:
                if p.cancelled() and not p.future.done():
                    p.future.set_result(None)
            group = [p for p in group if not p.cancelled()]
            if group:
                await self._serve_session(loop, group)

    async def _serve_session(self, loop, group: List) -> None:
        """One session from start to its last row: harvest a finished
        prepare and splice it, sweep cancellations, take the queue and
        start preparing newcomers, then decode one chunk (the prepare runs
        on another executor thread meanwhile)."""
        # everyone who ever joins: on a session failure each unresolved
        # future gets the exception, none is left hanging
        participants: List = list(group)
        by_tag: dict = {}
        prep_fut = None  # a running prepare: (future, items)
        # requests this session can never admit (prompt over its bucket,
        # budget over its shrinking steps): parked until it ends, not
        # queued again, or every boundary would take and tokenize them anew
        deferred: List = []
        sess = None
        try:
            sess = await loop.run_in_executor(None, lambda: self.lm.start_session(
                [p.prompt for p in group], [p.max_new for p in group],
                temperature=[p.temperature for p in group], top_k=[p.top_k for p in group],
                tenants=[p.tenant for p in group], task_ids=[p.task_id for p in group]))
            self.stats["sessions"] += 1
            for tag, p in zip((r.tag for r in sess.rows if r is not None), group):
                by_tag[tag] = p
            while True:
                # 1) a finished prepare: splice its rows in at this boundary;
                #    wait for one only when the session has nothing to decode
                if prep_fut is not None and (prep_fut[0].done() or (sess.done() and not by_tag)):
                    fut, take = prep_fut
                    prep_fut = None
                    tags = await self._harvest(loop, sess, fut, take)
                    for tag, p in zip(tags or (), take):
                        if tag is None:
                            deferred.append(p)  # its budget no longer fits this session
                        else:
                            by_tag[tag] = p
                            participants.append(p)
                            self.stats["admitted_midflight"] += 1
                # 2) cancellations: a vanished client's row frees now
                swept = [(tag, p) for tag, p in by_tag.items() if p.cancelled()]
                if swept:
                    # cancel_tag takes the engine lock, which an executor
                    # thread may hold through a chunk: never on the loop
                    await loop.run_in_executor(None, lambda: [sess.cancel_tag(t)
                                                              for t, _ in swept])
                for tag, p in swept:
                    by_tag.pop(tag)
                    if not p.future.done():
                        p.future.set_result(None)
                    self.stats["cancelled"] = self.stats.get("cancelled", 0) + 1
                if sess.done() and not by_tag and prep_fut is None:
                    # a pending prepare is never abandoned: the next pass
                    # waits for it and splices or defers its rows
                    break
                # 3) take the queue and start preparing newcomers
                if prep_fut is None and self._queue and sess.capacity() > 0:
                    prep_fut = await self._start_prepare(loop, sess, deferred)
                # 4) one chunk; the turnaround includes the hops between the
                #    loop and the executor
                t_hop = time.monotonic()
                finished = await loop.run_in_executor(None, sess.step)
                metrics.observe("batcher.step_turnaround_ms",
                                (time.monotonic() - t_hop) * 1000.0, labels={"service": "lm"})
                for tag, text in finished:
                    p = by_tag.pop(tag)
                    if not p.future.cancelled():
                        p.future.set_result(text)
        except Exception as e:
            log.exception("batch generate session failed")
            if prep_fut is not None:
                prep_fut[0].cancel()
                participants.extend(prep_fut[1])
            for p in participants:
                if not p.future.done():
                    p.future.set_exception(e)
        finally:
            # the session is stepped and spliced no more: its cache goes
            # back to the engine (a done session may still take a splice)
            if sess is not None:
                sess.close()
            # deferred items never joined: the next session takes them, at
            # the front of the queue
            self._requeue(deferred)

    async def _harvest(self, loop, sess, fut, take: List) -> Optional[list]:
        """The prepared state's splice → tags, or None when the prefill or
        the splice failed: then only the newcomers fail, and the session's
        rows decode on."""
        try:
            prep = await fut
            return await loop.run_in_executor(None, sess.splice, prep)
        except Exception as e:
            log.exception("newcomer admission failed")
            for p in take:
                if not p.future.done():
                    p.future.set_exception(e)
            return None

    async def _start_prepare(self, loop, sess, deferred: List):
        """Take the whole queue in stride-fair order, sort it into rows
        to admit now, items to retry at the next boundary (no free row) and
        items this session can never take (`deferred`), and start the
        prepare of those admitted → (future, items) or None."""
        candidates = self._queue.drain_fair()
        self._queued -= sum(self._size(c) for c in candidates)
        try:
            take, retry, defer = await loop.run_in_executor(
                None, self._filter_candidates, sess, candidates)
        except Exception as e:
            # taken items are in nobody's hands now: fail them
            log.exception("admission filter failed")
            for p in candidates:
                if not p.future.done():
                    p.future.set_exception(e)
            return None
        self._requeue(retry)
        deferred.extend(defer)
        if not take:
            return None
        return loop.run_in_executor(None, self._do_prepare, sess, take), take

    def _filter_candidates(self, sess, candidates: List):
        """On an executor thread (can_admit tokenizes): split candidates
        into (take, retry, defer). The budget margin covers the chunks that
        decode while the prepare runs: one when the prefill shape has run
        before; else up to 8 (never more than half the session's remaining
        chunks), since a refused splice throws the whole prefill away."""
        guess = min(len(candidates), sess.capacity())
        if sess.prefill_warm(guess):
            margin = 1
        else:
            margin = min(8, max(1, sess.remaining_steps() // (2 * sess.round_slots())))
        take: List = []
        retry: List = []  # no free row right now
        defer: List = []  # never in this session: budget or prompt
        for item in candidates:
            if len(take) >= sess.capacity():
                retry.append(item)
            elif sess.can_admit(item.prompt, item.max_new, lookahead_chunks=margin):
                take.append(item)
            else:
                defer.append(item)
        return take, retry, defer

    def _do_prepare(self, sess, take: List):
        """On an executor thread: the newcomers' prefill, without the engine
        lock (`BatchSession.prepare_admit`), overlapped with the running
        chunk."""
        return sess.prepare_admit([p.prompt for p in take], [p.max_new for p in take],
                                  temperature=[p.temperature for p in take],
                                  top_k=[p.top_k for p in take],
                                  tenants=[p.tenant for p in take],
                                  task_ids=[p.task_id for p in take])
