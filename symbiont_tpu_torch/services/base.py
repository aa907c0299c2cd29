"""Service skeleton: the subscribe-dispatch loop every worker shares.

Copy of the JAX package's `symbiont_tpu/services/base.py`.

Mirrors the reference's per-service main-loop shape (subscribe →
`while let Some(msg) = sub.next().await` → spawn handler; e.g. reference:
services/perception_service/src/main.rs:172-247) with the flaws fixed that
SURVEY.md §5.2/§5.3 documents:

- bounded concurrency (semaphore) instead of unbounded tokio::spawn;
- queue-group subscriptions so replicas shard work instead of duplicating it;
- handler failures are counted + logged with trace context, never kill the
  loop;
- (resilience plane) per-handler TIMEOUT — a hung handler is cancelled, so
  it can never pin a semaphore slot, and its durable delivery stays unacked
  for redelivery — plus in-process RETRY with jittered exponential backoff
  for transient failures, both configurable via ResilienceConfig /
  `apply_resilience()`;
- dispatch loops are SUPERVISED (resilience/supervisor.py): a crashed loop
  restarts with backoff instead of dying unlogged.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
from typing import Awaitable, Callable, Optional

from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.resilience import admission, faults
from symbiont_tpu_torch.resilience.supervisor import supervise
from symbiont_tpu_torch.utils.retry import jittered
from symbiont_tpu_torch.utils.telemetry import metrics, span

log = logging.getLogger(__name__)

Handler = Callable[[Msg], Awaitable[None]]


class HandlerTimeout(Exception):
    """The handler-deadline sentinel: raised by _attempt ONLY when OUR
    wait_for cancelled the handler. A TimeoutError raised by the handler's
    own code (a bus request timeout, a socket read timeout — and on 3.11+
    asyncio.TimeoutError IS builtin TimeoutError) is an ordinary failure:
    it must hit the retry/accounting path, not masquerade as the
    deadline."""


class Service:
    name = "service"

    def __init__(self, bus, max_concurrency: int = 32):
        self.bus = bus
        self._sem = asyncio.Semaphore(max_concurrency)
        self._tasks: set = set()
        self._subs: list = []
        self._loops: list = []
        self._running = False
        # resilience knobs (ResilienceConfig defaults; see apply_resilience)
        self.handler_timeout_s = 0.0  # 0 disables the timeout
        self.handler_retries = 0
        self.handler_backoff_base_s = 0.05
        self.handler_backoff_max_s = 2.0
        self.supervisor_backoff_base_s = 0.5
        self.supervisor_backoff_max_s = 30.0
        self._rng = random.Random()  # jitter source; seedable in tests

    def apply_resilience(self, cfg) -> None:
        """Adopt a ResilienceConfig (config.py). Called by the runner on
        every hosted service; individual services may override fields after
        (per-service tuning)."""
        self.handler_timeout_s = cfg.handler_timeout_s
        self.handler_retries = cfg.handler_retries
        self.handler_backoff_base_s = cfg.handler_backoff_base_s
        self.handler_backoff_max_s = cfg.handler_backoff_max_s
        self.supervisor_backoff_base_s = cfg.supervisor_backoff_base_s
        self.supervisor_backoff_max_s = cfg.supervisor_backoff_max_s

    async def start(self) -> None:
        self._running = True
        await self._setup()

    async def _setup(self) -> None:  # override: create subscriptions
        raise NotImplementedError

    async def _subscribe_loop(self, subject: str, handler: Handler,
                              queue: Optional[str] = None,
                              durable_stream: Optional[str] = None) -> None:
        """Dispatch loop. With `durable_stream` (and a bus that supports it),
        consumption is at-least-once: the delivery is acked only after the
        handler returns, so a crash mid-handler redelivers (SURVEY.md §5.3 —
        ack-after-durable, the stance the reference's wait=true upserts take
        at the storage layer but its bus never did)."""
        durable = (durable_stream is not None and queue is not None
                   and hasattr(self.bus, "durable_subscribe"))
        if durable:
            sub = await self.bus.durable_subscribe(durable_stream, queue,
                                                   filter_subject=subject)
        else:
            sub = await self.bus.subscribe(subject, queue=queue)
        self._subs.append(sub)

        async def loop() -> None:
            async for msg in sub:
                await self._sem.acquire()
                task = asyncio.create_task(
                    self._run_handler(subject, handler, msg, ack=durable))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)

        # supervised: an exception escaping the loop body restarts it with
        # backoff (same still-open subscription) instead of silently ending
        # consumption for the life of the process
        t = asyncio.create_task(
            supervise(loop, name=f"{self.name}:{subject}",
                      backoff_base_s=self.supervisor_backoff_base_s,
                      backoff_max_s=self.supervisor_backoff_max_s,
                      labels={"service": self.name},
                      still_wanted=lambda: self._running,
                      rng=self._rng),
            name=f"{self.name}:{subject}")
        self._loops.append(t)

    async def _drop_expired(self, subject: str, msg: Msg,
                            ack: bool) -> bool:
        """Deadline propagation (overload-protection plane): a message whose
        X-Symbiont-Deadline has passed is dropped BEFORE the handler runs —
        the caller already gave up, so doing the work only adds load at the
        worst time. Counted as `admission.expired{service}`; the durable
        delivery is ACKED (expiry is not a handler failure: it must not
        redeliver and must never quarantine as poison)."""
        if not admission.expired(msg.headers):
            return False
        metrics.inc("admission.expired",
                    labels={"service": self.name, "subject": subject})
        log.info("%s: dropping expired work on %s (deadline passed "
                 "%.0fms ago)", self.name, subject,
                 -(admission.remaining_ms(msg.headers) or 0.0))
        if ack:
            await self.bus.ack(msg)
        return True

    async def _run_handler(self, subject: str, handler: Handler, msg: Msg,
                           ack: bool = False) -> None:
        try:
            metrics.inc("bus.consumed",
                        labels={"service": self.name, "subject": subject})
            if await self._drop_expired(subject, msg, ack):
                return
            attempts = 1 + max(0, self.handler_retries)
            delay = self.handler_backoff_base_s
            for attempt in range(attempts):
                try:
                    await self._attempt(subject, handler, msg)
                except HandlerTimeout:
                    # the handler was CANCELLED at the deadline: the slot is
                    # free again, and (durable) the unacked delivery will
                    # redeliver after ack_wait — no in-process retry of a
                    # side effect whose state is unknown
                    metrics.inc("bus.handler_timeout",
                                labels={"service": self.name,
                                        "subject": subject})
                    log.warning(
                        "%s: handler for %s timed out after %.1fs and was "
                        "cancelled%s", self.name, subject,
                        self.handler_timeout_s,
                        " (unacked: will redeliver)" if ack else "")
                    return
                except asyncio.CancelledError:
                    raise
                except Exception:
                    metrics.inc("bus.failed",
                                labels={"service": self.name,
                                        "subject": subject})
                    log.exception("%s: handler failed for %s (attempt %d/%d)",
                                  self.name, subject, attempt + 1, attempts)
                    if attempt + 1 >= attempts:
                        return  # durable: stays unacked -> redelivery/DLQ
                    metrics.inc("bus.handler_retries",
                                labels={"service": self.name,
                                        "subject": subject})
                    # full-jitter exponential backoff between attempts
                    await asyncio.sleep(jittered(delay, self._rng))
                    delay = min(delay * 2, self.handler_backoff_max_s)
                    # the deadline may have passed during the backoff: a
                    # retry of expired work is load with no beneficiary
                    if await self._drop_expired(subject, msg, ack):
                        return
                    continue
                if ack:
                    # ack-after-success: a failed handler leaves the message
                    # unacked for redelivery
                    await self.bus.ack(msg)
                return
        finally:
            self._sem.release()

    async def _attempt(self, subject: str, handler: Handler, msg: Msg) -> None:
        """One handler invocation under its span, bounded by the handler
        timeout (the fault seam and any injected hang live INSIDE the
        timeout window, so chaos can prove the cancellation)."""
        with span(f"{self.name}.handle", msg.headers, subject=subject) as sp:
            # hand the handler a PRIVATE message bound to this handler
            # span's context: the inproc bus shares one Msg (and one
            # headers dict) across all subscribers, so rebinding a copy
            # — never mutating the original — is what lets every
            # downstream publish link to this span without racing a
            # sibling subscriber's handler (obs trace model; the ack
            # in _run_handler still uses the ORIGINAL msg, whose transport
            # headers the copy merge also preserves)
            hmsg = dataclasses.replace(
                msg, headers={**(msg.headers or {}), **sp.headers})

            async def invoke() -> None:
                plan = faults.active_plan()
                if plan is not None:
                    await plan.async_fault("handler",
                                           f"{self.name}:{subject}")
                await handler(hmsg)

            if self.handler_timeout_s > 0:
                fut = asyncio.ensure_future(invoke())
                try:
                    await asyncio.wait_for(fut, self.handler_timeout_s)
                except asyncio.TimeoutError:
                    if fut.cancelled():
                        # OUR deadline fired (wait_for cancelled the
                        # handler) — not a TimeoutError the handler raised
                        raise HandlerTimeout() from None
                    raise  # the handler's own timeout: a normal failure
            else:
                await invoke()

    async def drain(self) -> None:
        """Stop pulling NEW work, let everything already here land — the
        scale-in half of the drain protocol (resilience/autoscale.py).

        Closing a durable subscription DETACHES the consumer (TcpBus sends
        UNSUB and forgets it, so a reconnect never re-attaches): deliveries
        this worker pulled but never acked redeliver after `ack_wait` to
        the surviving queue-group members. The close sentinel lands BEHIND
        any locally-queued deliveries, so the dispatch loop runs the
        backlog to completion before exiting — those handlers' acks
        (including coalesced ack-after-flush waits, which the subclass
        drain() overrides switch to immediate-flush first) release
        normally.

        Request-reply subscriptions close the same way: they are
        at-most-once hops with no redelivery, so the loss window must be
        the one UNSUB round-trip (deliveries racing the close), never the
        locally-queued backlog — a storm's worth of requests already
        routed to this member is dispatched and ANSWERED below before the
        loops end, instead of being dropped into caller timeouts the way
        a plain stop()'s loop-cancel would. The supervisor-side deadline,
        not this method, is the bound on a drain that hangs."""
        self._running = False
        for s in self._subs:
            s.close()
        if self._loops:
            # NO cancel: each loop dispatches its queued backlog, then
            # ends on the close sentinel (which close() enqueues BEHIND
            # the backlog); supervise exits on the clean return
            done, pending = await asyncio.wait(self._loops, timeout=30.0)
            for t in pending:
                t.cancel()
            await asyncio.gather(*self._loops, return_exceptions=True)
        if self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
        self._loops.clear()
        self._subs.clear()

    async def stop(self) -> None:
        self._running = False
        for s in self._subs:
            s.close()
        for t in self._loops:
            t.cancel()
        if self._loops:
            # await the cancellations: a fire-and-forget cancel leaves
            # "Task was destroyed but it is pending" warnings (and live
            # supervisor sleeps) behind on interpreter shutdown
            await asyncio.gather(*self._loops, return_exceptions=True)
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._loops.clear()
        self._subs.clear()
