"""Continuous batching of generation requests in front of the LM engine.

The port's copy of `symbiont_tpu/engine/batcher.py`'s generation half:

- `TenantLanes`: per-tenant bounded FIFO lanes drained in stride-fair
  order (`resilience/admission.py`'s `StrideClock`), so a tenant with 80
  queued requests interleaves 1:1 with one holding 2;
- `GenBatcher`: its run loop wakes on a submission, waits up to the
  flush deadline for the batch to fill and takes at most `max_batch`
  requests; those start a decode session together (`LmEngine.start_session`), and at every chunk
  boundary queued requests join it in free rows (`BatchSession.can_admit`,
  `prepare_admit` on an executor thread overlapped with the next chunk,
  then `splice`). It drives the engine by duck type.

The embedding `MicroBatcher` comes with the stack (ROADMAP A8), and with
it the loop base the two batchers share in JAX (`_BatcherBase`), its
overlapped flushes (`max_inflight_flushes` > 1) and their
`batcher.overlap_ratio` gauge: generation serves one flush at a time,
since sessions take newcomers at chunk boundaries instead and two
sessions would only contend on the LM lock.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
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


class TenantLanes:
    """Per-tenant FIFO lanes drained in stride-fair order. One tenant
    behaves exactly as one FIFO deque. A full lane refuses with
    `AdmissionReject`: memory stays bounded behind the device.

    It has the deque surface the batcher uses (`len`, truth, iteration in
    drain order without consuming) and the fair
    `append/peek/popleft/requeue_front/drain_fair` cycle. Items without a
    `.tenant` ride the default lane. Every tenant weighs the same here;
    per-tenant weights come with the admission plane's configuration
    (ROADMAP A8)."""

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


class GenBatcher:
    """Continuous batching for generation. Requests that arrive within one
    flush window start a session together; at every chunk boundary queued
    requests join it in free rows when their budget fits the steps left
    and their prompt fits the session's prompt bucket, and otherwise wait
    for the next session. Per-request temperature and top_k ride as per-row
    values; requests group by new-token bucket.

    The run loop wakes on a submission, waits up to the flush deadline for
    `max_batch` requests, then takes at most that many and serves them
    before it takes more. `batcher.inflight` is 1 while it serves."""

    kind = "generate"

    def __init__(self, lm, max_batch: Optional[int] = None,
                 flush_deadline_ms: Optional[float] = None, lane_depth: Optional[int] = None):
        from symbiont_tpu_torch.config import LmConfig

        cfg = lm.config
        self.lm = lm
        self.max_batch = max_batch or cfg.gen_max_batch
        self.deadline_s = (flush_deadline_ms if flush_deadline_ms is not None
                           else cfg.gen_flush_deadline_ms) / 1000.0
        if lane_depth is None:
            lane_depth = getattr(cfg, "gen_tenant_lane_depth", LmConfig.gen_tenant_lane_depth)
        self._queue: TenantLanes = TenantLanes(kind=self.kind, max_per_tenant=lane_depth)
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._serving = False
        self.stats = {"sessions": 0, "admitted_midflight": 0}

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(), name=type(self).__name__)
            self._register_gauges()

    def _register_gauges(self) -> None:
        """Queue gauges read at scrape time, weakref-bound: a dead or
        closed batcher's gauges retire."""
        labels = {"service": "engine", "batcher": self.kind}

        def depth(b):
            return None if b._closed else len(b._queue)

        def oldest_wait_s(b):
            if b._closed:
                return None
            t = b._queue.oldest_submit() if b._queue else None
            return 0.0 if t is None else max(0.0, time.monotonic() - t)

        def inflight(b):
            return None if b._closed else int(b._serving)

        for name, reader in (("batcher.queue_depth", depth),
                             ("batcher.oldest_wait_s", oldest_wait_s),
                             ("batcher.inflight", inflight)):
            metrics.register_weakref_gauge(name, self, reader, labels=labels)

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        # a session's deferred requests go back to the queue as it ends;
        # with no loop left to serve them their futures would hang
        for item in self._queue.drain_fair():
            if not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))

    def _submit(self, item) -> None:
        if self._closed:
            raise RuntimeError("batcher closed")
        item._t_submit = time.monotonic()  # the queue-age gauge reads it
        self._queue.append(item)
        self._wake.set()

    def _requeue(self, items: List) -> None:
        """Put taken but unserved items back ahead of later submissions and
        wake the run loop, which would otherwise wait for an unrelated
        submission."""
        if not items:
            return
        self._queue.requeue_front(items)
        self._wake.set()

    def _take_chunk(self) -> List:
        """Pop up to max_batch items, composed across tenant lanes in
        stride-fair order."""
        taken = [self._queue.popleft() for _ in range(min(len(self._queue), self.max_batch))]
        if taken:
            labels = {"service": "engine", "batcher": self.kind}
            fill = len(taken) / self.max_batch
            metrics.observe("batcher.flush_fill_ratio", fill, labels=labels)
            metrics.gauge_set("batcher.last_flush_fill_ratio", round(fill, 4), labels=labels)
            # the backlog a flush leaves behind, on the timeline's time axis
            engine_timeline.note_queue_depth(self.kind, len(self._queue))
        return taken

    async def _run(self) -> None:
        while True:
            if not self._queue:
                if self._closed:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            if len(self._queue) < self.max_batch and not self._closed:
                # deadline flush: late arrivals get a short window to join
                try:
                    await asyncio.wait_for(self._sleep_until_full(), self.deadline_s)
                except asyncio.TimeoutError:
                    pass
            self._serving = True
            try:
                await self._flush(self._take_chunk())
            finally:
                self._serving = False

    async def _sleep_until_full(self) -> None:
        while len(self._queue) < self.max_batch and not self._closed:
            self._wake.clear()
            await self._wake.wait()

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
