"""TCP client for the native symbus broker (native/symbus).

Copy of the JAX package's `symbiont_tpu/bus/tcp.py`.

Same interface as InprocBus: publish / subscribe(queue=) / request / close.
Wire protocol is defined in native/symbus/protocol.hpp (length-prefixed
frames, little-endian).

Resilience plane: the client AUTO-RECONNECTS. The pre-resilience client
died permanently on one disconnect (the read loop closed every subscription
and the process limped on, deaf, forever). Now a lost connection starts a
jittered-exponential reconnect loop that, on success, re-sends every live
SUB, re-issues every `add_stream` (idempotent on the broker), and
re-attaches every durable consumer — so a broker restart is a pause, not an
outage. Sends during the gap wait up to `send_wait_s` for the reconnect
before failing with ConnectionError (callers on the durable path simply
leave their delivery unacked and the broker redelivers).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import struct
from typing import Dict, List, Optional, Tuple

from symbiont_tpu_torch.bus.core import Msg, Subscription
from symbiont_tpu_torch.resilience import faults
from symbiont_tpu_torch.utils.ids import generate_uuid
from symbiont_tpu_torch.utils.retry import jittered
from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

OP_SUB, OP_UNSUB, OP_PUB, OP_PING, OP_MSG, OP_PONG, OP_ERR = range(1, 8)
MAX_FRAME = 64 * 1024 * 1024


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<H", len(b)) + b


class _FrameReader:
    def __init__(self, payload: bytes):
        self.b = payload
        self.off = 0

    def u8(self) -> int:
        v = self.b[self.off]
        self.off += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from("<H", self.b, self.off)
        self.off += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.b, self.off)
        self.off += 4
        return v

    def s(self) -> str:
        n = self.u16()
        v = self.b[self.off:self.off + n].decode("utf-8")
        self.off += n
        return v

    def data(self) -> bytes:
        n = self.u32()
        v = self.b[self.off:self.off + n]
        self.off += n
        return v


class TcpBus:
    def __init__(self, host: str = "127.0.0.1", port: int = 4233,
                 reconnect: bool = True, reconnect_base_s: float = 0.25,
                 reconnect_max_s: float = 15.0, send_wait_s: float = 10.0):
        self.host = host
        self.port = port
        self.reconnect = reconnect
        self.reconnect_base_s = reconnect_base_s
        self.reconnect_max_s = reconnect_max_s
        self.send_wait_s = send_wait_s
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._subs: Dict[int, Subscription] = {}
        # sid -> (subject, queue): the re-SUB book for reconnect
        self._sub_meta: Dict[int, Tuple[str, Optional[str]]] = {}
        # durable state to re-establish after a reconnect
        self._streams: List[dict] = []  # add_stream requests issued
        self._consumers: List[dict] = []  # consumer.create requests issued
        self._next_sid = 1
        self._read_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._closed = False
        self._write_lock = asyncio.Lock()
        self._connected = asyncio.Event()
        self._rng = random.Random()
        self.stats = {"published": 0, "received": 0, "reconnects": 0,
                      "disconnects": 0}

    async def connect(self) -> None:
        await self._open_connection()
        self._connected.set()

    async def _open_connection(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        # request-reply latency rides small writes: without TCP_NODELAY,
        # Nagle + delayed ACK stacks ~40ms per reply hop (the native broker
        # and C++ clients already set it — client.hpp:71, broker.cpp:398)
        import socket as _socket

        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._read_task = asyncio.create_task(self._read_loop(),
                                              name="symbus-read")

    async def _send_frame(self, body: bytes) -> None:
        if self._closed:
            raise RuntimeError("bus closed")
        if not self._connected.is_set():
            # disconnected: give the reconnect loop a bounded chance
            try:
                await asyncio.wait_for(self._connected.wait(),
                                       self.send_wait_s)
            except asyncio.TimeoutError:
                raise ConnectionError(
                    f"symbus at {self.host}:{self.port} disconnected "
                    f"(no reconnect within {self.send_wait_s}s)")
            if self._closed:
                raise RuntimeError("bus closed")
        plan = faults.active_plan()
        if plan is not None:
            rule = plan.check("tcp.send", "frame")
            if rule is not None and rule.kind == "reset":
                raise ConnectionResetError("injected reset at tcp.send")
        await self._send_frame_raw(body)

    async def _send_frame_raw(self, body: bytes) -> None:
        """Write on the CURRENT connection, no reconnect gating — the
        reconnect handshake itself sends through here."""
        async with self._write_lock:
            if self._writer is None:
                raise ConnectionError("symbus not connected")
            self._writer.write(struct.pack("<I", len(body)) + body)
            await self._writer.drain()

    async def _read_loop(self) -> None:
        lost = False
        try:
            while True:
                head = await self._reader.readexactly(4)
                (n,) = struct.unpack("<I", head)
                if n == 0 or n > MAX_FRAME:
                    raise ConnectionError(f"bad frame length {n}")
                payload = await self._reader.readexactly(n)
                r = _FrameReader(payload)
                op = r.u8()
                if op == OP_MSG:
                    sid = r.u32()
                    subject = r.s()
                    reply = r.s()
                    nh = r.u16()
                    headers = {r.s(): r.s() for _ in range(nh)}
                    data = r.data()
                    self.stats["received"] += 1
                    sub = self._subs.get(sid)
                    if sub is not None:
                        sub._deliver(Msg(subject=subject, data=data,
                                         reply=reply or None, headers=headers))
                elif op == OP_ERR:
                    log.error("broker error: %s", r.s())
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            lost = not self._closed
            if lost:
                log.warning("symbus connection lost")
        except asyncio.CancelledError:
            raise
        finally:
            if lost and self.reconnect:
                self._connected.clear()
                self.stats["disconnects"] += 1
                metrics.inc("bus.tcp.disconnects")
                if self._reconnect_task is None or self._reconnect_task.done():
                    self._reconnect_task = asyncio.create_task(
                        self._reconnect_loop(), name="symbus-reconnect")
            elif not self._closed:
                # reconnect disabled: terminal, close everything (loud)
                for sub in list(self._subs.values()):
                    sub.close()
                self._subs.clear()

    async def _reconnect_loop(self) -> None:
        """Re-dial with jittered exponential backoff; on success restore the
        session: re-SUB every live subscription, re-issue add_stream
        (idempotent), re-attach durable consumers. Runs until it wins or the
        bus is closed."""
        delay = self.reconnect_base_s
        while not self._closed:
            try:
                await self._open_connection()
            except OSError as e:
                log.info("symbus reconnect to %s:%s failed (%s); retry in "
                         "%.2fs", self.host, self.port, e, delay)
                await asyncio.sleep(jittered(delay, self._rng))
                delay = min(delay * 2, self.reconnect_max_s)
                continue
            try:
                for sid, (subject, queue) in list(self._sub_meta.items()):
                    body = (struct.pack("<BI", OP_SUB, sid) + _str(subject)
                            + _str(queue or ""))
                    await self._send_frame_raw(body)
                # inboxes and plain subs are live again: unblock senders
                # before the durable re-attach (which uses request-reply)
                self._connected.set()
                for req in list(self._streams):
                    await self._request_json("_SYMBUS.stream.create", req,
                                             timeout=10.0)
                for req in list(self._consumers):
                    await self._request_json("_SYMBUS.consumer.create", req,
                                             timeout=10.0)
            except (ConnectionError, OSError, TimeoutError) as e:
                # restore failed. The connection may still be ALIVE (e.g. a
                # consumer.create timeout against a slow broker) — a bare
                # return would leave a half-restored session with no durable
                # deliveries and nothing scheduled to fix it. Tear the
                # connection down (the read-loop's respawn guard sees THIS
                # task as active, so no duplicate loop) and redial.
                log.warning("symbus session restore failed (%s); retrying "
                            "in %.2fs", e, delay)
                self._connected.clear()
                if self._writer is not None:
                    try:
                        self._writer.close()
                    except (ConnectionError, OSError):
                        pass
                await asyncio.sleep(jittered(delay, self._rng))
                delay = min(delay * 2, self.reconnect_max_s)
                continue
            self.stats["reconnects"] += 1
            metrics.inc("bus.tcp.reconnects")
            log.info("symbus reconnected to %s:%s (%d subs, %d streams, "
                     "%d consumers restored)", self.host, self.port,
                     len(self._sub_meta), len(self._streams),
                     len(self._consumers))
            return

    # ------------------------------------------------------------------ api

    async def publish(self, subject: str, data: bytes,
                      reply: Optional[str] = None,
                      headers: Optional[Dict[str, str]] = None) -> None:
        if self._closed:
            raise RuntimeError("bus closed")
        headers = headers or {}
        body = bytearray()
        body.append(OP_PUB)
        body += _str(subject)
        body += _str(reply or "")
        body += struct.pack("<H", len(headers))
        for k, v in headers.items():
            body += _str(k)
            body += _str(v)
        body += struct.pack("<I", len(data)) + bytes(data)
        await self._send_frame(bytes(body))
        self.stats["published"] += 1

    async def subscribe(self, subject: str, queue: Optional[str] = None,
                        maxsize: int = 1024) -> Subscription:
        if self._closed:
            raise RuntimeError("bus closed")
        sid = self._next_sid
        self._next_sid += 1
        sub = Subscription(subject, queue=queue, maxsize=maxsize)
        self._subs[sid] = sub
        self._sub_meta[sid] = (subject, queue)
        _orig_close = sub.close

        def close_and_unsub() -> None:
            _orig_close()
            self._subs.pop(sid, None)
            self._sub_meta.pop(sid, None)
            if not self._closed and self._writer is not None:
                body = struct.pack("<BI", OP_UNSUB, sid)

                async def send_unsub() -> None:
                    # benign if the connection drops before the UNSUB flushes
                    # (e.g. bus.close() right after a request completes)
                    try:
                        await self._send_frame(body)
                    except (ConnectionError, OSError, RuntimeError):
                        pass

                try:
                    asyncio.get_running_loop().create_task(send_unsub())
                except RuntimeError:
                    pass  # no loop (interpreter teardown)

        sub.close = close_and_unsub  # type: ignore[method-assign]
        body = struct.pack("<BI", OP_SUB, sid) + _str(subject) + _str(queue or "")
        await self._send_frame(body)
        return sub

    async def request(self, subject: str, data: bytes, timeout: float,
                      headers: Optional[Dict[str, str]] = None) -> Msg:
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

    async def _request_json(self, subject: str, req: dict,
                            timeout: float) -> dict:
        msg = await self.request(subject, json.dumps(req).encode(), timeout)
        return json.loads(msg.data)

    # -------------------------------------------------- durable streams
    # The broker-side JetStream equivalent (native/symbus/streams.hpp): the
    # control surface is three reserved request-reply subjects, so no new
    # opcodes. See SURVEY.md §5.3 for why the reference's core-NATS
    # at-most-once stance loses in-flight work.

    async def add_stream(self, name: str, subjects: list,
                         ack_wait_s: float = 30.0, max_deliver: int = 5,
                         timeout: float = 10.0) -> dict:
        """Create/refresh a durable stream capturing `subjects` patterns."""
        req = {"stream": name, "subjects": list(subjects),
               "ack_wait_ms": int(ack_wait_s * 1000),
               "max_deliver": int(max_deliver)}
        out = await self._request_json("_SYMBUS.stream.create", req, timeout)
        if not out.get("ok"):
            raise RuntimeError(f"stream create failed: {out.get('error')}")
        # remember for reconnect (idempotent re-issue); replace a stale
        # request for the same stream name
        self._streams = [s for s in self._streams if s["stream"] != name]
        self._streams.append(req)
        return out

    async def durable_subscribe(self, stream: str, group: str,
                                filter_subject: Optional[str] = None,
                                maxsize: int = 1024,
                                timeout: float = 10.0) -> Subscription:
        """Join durable consumer group `group` on `stream`.

        Returns a Subscription of redeliverable messages (headers carry
        X-Symbus-Seq etc.); the consumer must call `bus.ack(msg)` after the
        side effect is durable, or the message redelivers after ack_wait.
        Replicas calling this with the same group share the stream
        (queue-group delivery). `filter_subject` narrows the group to one
        subject pattern of a multi-subject stream (non-matching messages are
        auto-acked for this group)."""
        sub = await self.subscribe(f"_SYMBUS.deliver.{stream}.{group}",
                                   queue=group, maxsize=maxsize)
        req = {"stream": stream, "group": group,
               "filter_subject": filter_subject}
        out = await self._request_json("_SYMBUS.consumer.create", req, timeout)
        if not out.get("ok"):
            sub.close()
            raise RuntimeError(f"consumer create failed: {out.get('error')}")
        self._consumers.append(req)
        _orig_close = sub.close

        def close_and_forget() -> None:
            _orig_close()
            try:
                self._consumers.remove(req)
            except ValueError:
                pass

        sub.close = close_and_forget  # type: ignore[method-assign]
        return sub

    async def ack(self, msg: Msg) -> None:
        """Acknowledge a durable delivery (ack-after-durable, the reference's
        Qdrant wait=true stance — SURVEY.md §5.4)."""
        payload = {"stream": msg.headers["X-Symbus-Stream"],
                   "group": msg.headers["X-Symbus-Group"],
                   "seq": int(msg.headers["X-Symbus-Seq"])}
        await self.publish("_SYMBUS.ack", json.dumps(payload).encode())

    async def stream_stats(self, timeout: float = 10.0) -> dict:
        msg = await self.request("_SYMBUS.stats", b"{}", timeout)
        return json.loads(msg.data)

    async def flush(self) -> None:
        """Round-trip PING — guarantees prior publishes were processed."""
        # PONG arrives on the read loop; emulate a synchronous barrier with a
        # tiny sleep-poll on the write drain (broker handles frames in order).
        body = struct.pack("<B", OP_PING)
        await self._send_frame(body)
        await asyncio.sleep(0)

    async def close(self) -> None:
        self._closed = True
        self._connected.set()  # wake senders blocked on reconnect -> closed
        if self._reconnect_task:
            self._reconnect_task.cancel()
        for sub in list(self._subs.values()):
            sub.close()
        if self._read_task:
            self._read_task.cancel()
        if self._writer:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
