"""In-process asyncio bus.

Copy of the JAX package's `symbiont_tpu/bus/inproc.py`.

Semantics match core NATS as the reference uses it (SURVEY.md §1-L3):
- publish is fire-and-forget, at-most-once, no persistence;
- plain subscriptions each get every matching message;
- queue-group subscriptions share: one member per group per message
  (round-robin) — the scale-out mechanism the reference lacks;
- request() publishes with a unique inbox reply subject and awaits the first
  response (the api_service pattern, reference:
  services/api_service/src/main.rs:309-316).

Plus (resilience plane): the same durable-streams contract the native
broker exposes — `add_stream` / `durable_subscribe` / `ack` with
`X-Symbus-*` headers — so the DEFAULT single-process stack is at-least-once
too, not just symbus:// deployments. A stream captures matching publishes
regardless of live consumers; deliveries redeliver after `ack_wait_s`
without an ack; a delivery exhausting `max_deliver` is dead-lettered:
published to `dlq.<original-subject>` with failure headers and parked in
the bounded `bus.dlq` quarantine store (resilience/dlq.py, surfaced at
`GET /api/dlq`).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import defaultdict
from typing import Dict, List, Optional

from symbiont_tpu_torch.bus.core import Msg, Subscription, subject_matches
from symbiont_tpu_torch.resilience import dlq as dlq_mod
from symbiont_tpu_torch.resilience import faults
from symbiont_tpu_torch.resilience.dlq import DeadLetterStore
from symbiont_tpu_torch.utils.ids import generate_uuid
from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

# retained messages per stream: bounded so a consumer-less stream cannot
# grow without limit (oldest dropped with a counter — loud, not silent)
MAX_RETAINED = 16384


class _DurableGroup:
    """One consumer group on a stream: members share deliveries
    (queue-group), unacked deliveries redeliver, max_deliver dead-letters."""

    def __init__(self, name: str, filter_subject: Optional[str]):
        self.name = name
        self.filter_subject = filter_subject
        self.members: List[Subscription] = []
        self.rr = 0
        # settled = acked OR auto-acked OR dead-lettered. Kept as a
        # contiguous floor + sparse set above it, so memory stays bounded
        # by the in-flight window, not by stream history
        self.floor = 0
        self.acked: set = set()
        self.state: Dict[int, list] = {}  # seq -> [deliveries, deadline]
        self.wake = asyncio.Event()
        self.task: Optional[asyncio.Task] = None
        self.dead_lettered = 0

    def is_settled(self, seq: int) -> bool:
        return seq <= self.floor or seq in self.acked

    def settle(self, seq: int) -> None:
        if seq <= self.floor:
            return
        self.acked.add(seq)
        while self.floor + 1 in self.acked:
            self.floor += 1
            self.acked.discard(self.floor)

    def live_members(self) -> List[Subscription]:
        self.members = [m for m in self.members if not m._closed]
        return self.members


class _DurableStream:
    def __init__(self, name: str, subjects: List[str], ack_wait_s: float,
                 max_deliver: int):
        self.name = name
        self.subjects = list(subjects)
        self.ack_wait_s = ack_wait_s
        self.max_deliver = max_deliver
        # seq -> (subject, data, headers); insertion order == seq order
        self.messages: Dict[int, tuple] = {}
        self.last_seq = 0
        self.groups: Dict[str, _DurableGroup] = {}

    def captures(self, subject: str) -> bool:
        # dlq.* and control subjects never re-enter a stream: a `>` pattern
        # capturing its own dead letters would loop forever
        if subject.startswith(("dlq.", "_")):
            return False
        return any(subject_matches(p, subject) for p in self.subjects)


class InprocBus:
    def __init__(self, dlq_capacity: int = 256) -> None:
        self._subs: List[Subscription] = []
        self._rr: Dict[tuple, itertools.count] = defaultdict(itertools.count)
        self._closed = False
        self._streams: Dict[str, _DurableStream] = {}
        self.dlq = DeadLetterStore(dlq_capacity)
        self.stats = {"published": 0, "delivered": 0, "dropped": 0,
                      "dead_lettered": 0, "redelivered": 0}

    # ------------------------------------------------------------------ pub

    async def publish(self, subject: str, data: bytes,
                      reply: Optional[str] = None,
                      headers: Optional[Dict[str, str]] = None) -> None:
        if self._closed:
            raise RuntimeError("bus closed")
        plan = faults.active_plan()
        if plan is not None:
            rule = await plan.async_fault("bus.publish", subject)
            if rule is not None and rule.kind == "drop":
                self.stats["dropped"] += 1
                return  # the message never happened (lost datagram)
        msg = Msg(subject=subject, data=bytes(data), reply=reply,
                  headers=dict(headers or {}))
        self.stats["published"] += 1
        # durable capture BEFORE fan-out: a crash mid-delivery must not
        # lose a captured message (the at-least-once contract)
        for stream in self._streams.values():
            if stream.captures(subject):
                stream.last_seq += 1
                stream.messages[stream.last_seq] = (
                    subject, msg.data, dict(msg.headers))
                if len(stream.messages) > MAX_RETAINED:
                    old = next(iter(stream.messages))
                    del stream.messages[old]
                    # settle the evicted seq for every group: an unsettled
                    # hole below the floor would pin group.acked/state
                    # forever and freeze the ack floor
                    for group in stream.groups.values():
                        group.settle(old)
                        group.state.pop(old, None)
                    metrics.inc("bus.stream_evicted",
                                labels={"stream": stream.name})
                for group in stream.groups.values():
                    group.wake.set()
        matching = [s for s in self._subs if subject_matches(s.subject, subject)]
        # queue groups: pick one member per (pattern, queue) group round-robin
        groups: Dict[tuple, List[Subscription]] = defaultdict(list)
        for s in matching:
            if s.queue:
                groups[(s.subject, s.queue)].append(s)
        chosen = set()
        for gkey, members in groups.items():
            i = next(self._rr[gkey]) % len(members)
            chosen.add(id(members[i]))
        for s in matching:
            if s.queue and id(s) not in chosen:
                continue
            if s._deliver(msg):
                self.stats["delivered"] += 1
            else:
                self.stats["dropped"] += 1

    # ------------------------------------------------------------------ sub

    async def subscribe(self, subject: str, queue: Optional[str] = None,
                        maxsize: int = 1024) -> Subscription:
        if self._closed:
            raise RuntimeError("bus closed")
        sub = Subscription(subject, queue=queue, maxsize=maxsize)
        self._subs.append(sub)
        _orig_close = sub.close

        def close_and_remove() -> None:
            _orig_close()
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

        sub.close = close_and_remove  # type: ignore[method-assign]
        return sub

    # -------------------------------------------------------------- request

    async def request(self, subject: str, data: bytes, timeout: float,
                      headers: Optional[Dict[str, str]] = None) -> Msg:
        """Inbox request-reply; raises TimeoutError like the reference's
        tokio timeouts (api_service/src/main.rs:309-349)."""
        inbox = f"_INBOX.{generate_uuid()}"
        sub = await self.subscribe(inbox)
        try:
            await self.publish(subject, data, reply=inbox, headers=headers)
            msg = await sub.next(timeout)
            if msg is None:
                raise TimeoutError(f"request on {subject!r} timed out after {timeout}s")
            return msg
        finally:
            sub.close()

    # ----------------------------------------------------- durable streams
    # Same surface as TcpBus (bus/tcp.py) / the native broker
    # (native/symbus/streams.hpp), so services/base.py and the runner are
    # transport-agnostic: `bus.durable` works on the default in-proc stack.

    async def add_stream(self, name: str, subjects: list,
                         ack_wait_s: float = 30.0, max_deliver: int = 5,
                         timeout: float = 10.0) -> dict:
        """Create/refresh a durable stream capturing `subjects` patterns.
        Idempotent: re-adding updates the knobs and unions the patterns."""
        if self._closed:
            raise RuntimeError("bus closed")
        if ack_wait_s <= 0 or max_deliver < 1:
            raise ValueError("ack_wait_s must be > 0 and max_deliver >= 1")
        stream = self._streams.get(name)
        if stream is None:
            stream = self._streams[name] = _DurableStream(
                name, list(subjects), ack_wait_s, max_deliver)
        else:
            stream.ack_wait_s = ack_wait_s
            stream.max_deliver = max_deliver
            for p in subjects:
                if p not in stream.subjects:
                    stream.subjects.append(p)
        return {"ok": True, "stream": name}

    async def durable_subscribe(self, stream: str, group: str,
                                filter_subject: Optional[str] = None,
                                maxsize: int = 1024,
                                timeout: float = 10.0) -> Subscription:
        """Join durable consumer group `group` on `stream` (contract of
        TcpBus.durable_subscribe: redeliverable messages with X-Symbus-*
        headers; `bus.ack(msg)` settles a delivery; same-group members
        share; `filter_subject` narrows the group, non-matching messages
        auto-acked for it)."""
        if self._closed:
            raise RuntimeError("bus closed")
        st = self._streams.get(stream)
        if st is None:
            raise RuntimeError(f"consumer create failed: no stream {stream!r}")
        g = st.groups.get(group)
        if g is None:
            g = st.groups[group] = _DurableGroup(group, filter_subject)
            g.task = asyncio.create_task(self._pump(st, g),
                                         name=f"durable:{stream}:{group}")
        elif filter_subject != g.filter_subject:
            raise RuntimeError(
                f"consumer group {group!r} already exists with filter "
                f"{g.filter_subject!r}, requested {filter_subject!r}")
        sub = Subscription(filter_subject or stream, queue=group,
                           maxsize=maxsize)
        g.members.append(sub)
        _orig_close = sub.close

        def close_and_leave() -> None:
            _orig_close()
            try:
                g.members.remove(sub)
            except ValueError:
                pass
            g.wake.set()

        sub.close = close_and_leave  # type: ignore[method-assign]
        g.wake.set()
        return sub

    async def ack(self, msg: Msg) -> None:
        """Acknowledge a durable delivery (ack-after-durable — SURVEY.md
        §5.4). Unknown/stale acks are ignored, like the broker's."""
        try:
            stream = self._streams[msg.headers["X-Symbus-Stream"]]
            group = stream.groups[msg.headers["X-Symbus-Group"]]
            seq = int(msg.headers["X-Symbus-Seq"])
        except (KeyError, ValueError):
            return
        group.settle(seq)
        group.state.pop(seq, None)
        group.wake.set()

    async def _pump(self, stream: _DurableStream, group: _DurableGroup) -> None:
        """Per-group delivery loop: push unsettled messages to members
        round-robin, redeliver after ack_wait, dead-letter past max_deliver.
        Event-driven — sleeps until the next deadline or a wake (publish,
        ack, member join/leave)."""
        loop = asyncio.get_running_loop()
        while not self._closed:
            now = loop.time()
            next_due: Optional[float] = None

            def track(t: float) -> None:
                nonlocal next_due
                next_due = t if next_due is None else min(next_due, t)

            for seq in list(stream.messages):
                if group.is_settled(seq):
                    continue
                subject, data, headers = stream.messages[seq]
                if (group.filter_subject is not None
                        and not subject_matches(group.filter_subject,
                                                subject)):
                    group.settle(seq)  # auto-ack outside the filter
                    continue
                st = group.state.setdefault(seq, [0, 0.0])
                if st[1] > now:
                    track(st[1])  # in-flight, ack_wait not yet expired
                    continue
                if st[0] >= stream.max_deliver:
                    await self._dead_letter(stream, group, seq, subject,
                                            data, headers, st[0])
                    group.settle(seq)
                    group.state.pop(seq, None)
                    group.dead_lettered += 1
                    continue
                members = group.live_members()
                if not members:
                    track(now + 0.25)  # no consumers yet; park
                    break
                member = members[group.rr % len(members)]
                group.rr += 1
                st[0] += 1
                if st[0] > 1:
                    self.stats["redelivered"] += 1
                    metrics.inc("bus.redelivered",
                                labels={"stream": stream.name,
                                        "group": group.name})
                st[1] = now + stream.ack_wait_s
                out = Msg(subject=subject, data=data, headers={
                    **headers,
                    "X-Symbus-Stream": stream.name,
                    "X-Symbus-Group": group.name,
                    "X-Symbus-Subject": subject,
                    "X-Symbus-Seq": str(seq),
                    "X-Symbus-Deliveries": str(st[0]),
                })
                plan = faults.active_plan()
                dropped = False
                if plan is not None:
                    rule = plan.check("bus.deliver", subject)
                    if rule is not None and rule.kind == "drop":
                        dropped = True  # delivery lost in flight: the
                        # delivery attempt counts, redelivery recovers it
                if not dropped and not member._deliver(out):
                    # member queue overflow: not a real delivery attempt —
                    # retry shortly without burning max_deliver budget
                    st[0] -= 1
                    st[1] = now + min(stream.ack_wait_s, 0.05)
                track(st[1])
            # GC: a message settled by EVERY group is done — drop it so
            # retention tracks the in-flight window, not stream history
            if stream.groups:
                for seq in list(stream.messages):
                    if all(g.is_settled(seq)
                           for g in stream.groups.values()):
                        del stream.messages[seq]
            try:
                if next_due is None:
                    await group.wake.wait()
                else:
                    await asyncio.wait_for(group.wake.wait(),
                                           max(0.0, next_due - loop.time()))
            except asyncio.TimeoutError:
                pass
            group.wake.clear()

    async def _dead_letter(self, stream: _DurableStream,
                           group: _DurableGroup, seq: int, subject: str,
                           data: bytes, headers: Dict[str, str],
                           deliveries: int) -> None:
        """Quarantine a poison message: park it in the DLQ store and
        publish a copy to dlq.<subject> for any live DLQ consumers.
        Published inline (the pump is a coroutine) — a fire-and-forget
        create_task holds only a weak reference and could be collected
        before running."""
        reason = f"max_deliver exhausted ({deliveries} deliveries unacked)"
        self.stats["dead_lettered"] += 1
        entry = self.dlq.quarantine(subject, data, headers, reason=reason,
                                    stream=stream.name, group=group.name,
                                    deliveries=deliveries)
        log.error("dead-letter: %s seq=%d (stream=%s group=%s) after %d "
                  "deliveries -> dlq entry %d", subject, seq, stream.name,
                  group.name, deliveries, entry.id)
        dlq_headers = {
            **headers,
            dlq_mod.REASON_HEADER: reason,
            dlq_mod.STREAM_HEADER: stream.name,
            dlq_mod.GROUP_HEADER: group.name,
            dlq_mod.DELIVERIES_HEADER: str(deliveries),
        }
        try:
            await self.publish(f"dlq.{subject}", data, headers=dlq_headers)
        except RuntimeError:
            pass  # bus closed between quarantine and publish: the DLQ
            # store entry is the durable record either way

    async def stream_stats(self, timeout: float = 10.0) -> dict:
        out: dict = {}
        for name, stream in self._streams.items():
            groups = {}
            for gname, g in stream.groups.items():
                groups[gname] = {
                    "ack_floor": g.floor,
                    "inflight": sum(1 for st in g.state.values() if st[0]),
                    "dead_lettered": g.dead_lettered,
                }
            out[name] = {"last_seq": stream.last_seq,
                         "messages": len(stream.messages),
                         "groups": groups}
        return out

    # ------------------------------------------------------------ lifecycle

    async def flush(self) -> None:
        # give queued deliveries a tick (in-proc delivery is synchronous, so
        # this is just a scheduling yield for handlers)
        await asyncio.sleep(0)

    async def close(self) -> None:
        self._closed = True
        for stream in self._streams.values():
            for g in stream.groups.values():
                if g.task is not None:
                    g.task.cancel()
                for m in list(g.members):
                    m.close()
        for s in list(self._subs):
            s.close()
        self._subs.clear()
        tasks = [g.task for st in self._streams.values()
                 for g in st.groups.values() if g.task is not None]
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._streams.clear()


_shared: Optional[InprocBus] = None


def connect_inproc(shared: bool = True) -> InprocBus:
    """Shared singleton (one process = one bus, like one NATS server) or a
    fresh private bus for tests."""
    global _shared
    if not shared:
        return InprocBus()
    if _shared is None or _shared._closed:
        _shared = InprocBus()
    return _shared
