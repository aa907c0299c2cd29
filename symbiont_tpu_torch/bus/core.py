"""Bus core types shared by the inproc and TCP transports.

Copy of the JAX package's `symbiont_tpu/bus/core.py`.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, Optional


@dataclass
class Msg:
    subject: str
    data: bytes
    reply: Optional[str] = None
    headers: Dict[str, str] = field(default_factory=dict)


class Subscription:
    """Async-iterable message stream (the `subscriber.next().await` loop shape
    every reference service uses, e.g. perception_service/src/main.rs:217)."""

    def __init__(self, subject: str, queue: Optional[str] = None, maxsize: int = 1024):
        self.subject = subject
        self.queue = queue
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._closed = False

    def _deliver(self, msg: Msg) -> bool:
        if self._closed:
            return False
        try:
            self._q.put_nowait(msg)
            return True
        except asyncio.QueueFull:
            # drop-on-overflow like a core-NATS slow consumer; callers that
            # need at-least-once use the durable layer. Counted — a silent
            # drop is the reference's failure policy, not ours
            from symbiont_tpu_torch.utils.telemetry import metrics

            metrics.inc("bus.dropped", labels={"subject": self.subject})
            return False

    async def next(self, timeout: Optional[float] = None) -> Optional[Msg]:
        try:
            if timeout is None:
                item = await self._q.get()
            else:
                item = await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return None
        return item  # None is the close sentinel

    def __aiter__(self) -> AsyncIterator[Msg]:
        return self

    async def __anext__(self) -> Msg:
        msg = await self.next()
        if msg is None:
            raise StopAsyncIteration
        return msg

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._q.put_nowait(None)  # wake iterators
            except asyncio.QueueFull:
                # full backlog: sacrifice the oldest message so the close
                # sentinel always lands — otherwise a drained iterator would
                # block forever on a closed subscription
                try:
                    self._q.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                try:
                    self._q.put_nowait(None)
                except asyncio.QueueFull:
                    pass


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: '.'-separated tokens, '*' = one token,
    '>' = one-or-more trailing tokens."""
    pt = pattern.split(".")
    st = subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return len(st) >= i + 1
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)
