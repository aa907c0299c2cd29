"""Pure-Python symbus broker — wire- and log-compatible with native/symbus.

Copy of the JAX package's `symbiont_tpu/bus/pybroker.py`.

The process-failure plane (resilience/procsup.py, PR 10) supervises a REAL
multi-process deployment: every worker is its own OS process over a
`symbus://` broker. The C++ broker (native/symbus/broker.cpp) is the
production artifact, but it needs a C++17 toolchain with float
`std::to_chars` — which CI boxes (including this sandbox, GCC 10) may not
have. This module is the same broker in Python:

- identical WIRE protocol (native/symbus/protocol.hpp: length-prefixed
  frames, SUB/UNSUB/PUB/PING → MSG/PONG/ERR), so `bus/tcp.py` clients AND
  the native C++ shells connect to either broker unchanged;
- identical DURABLE-STREAM contract (native/symbus/streams.hpp): streams
  capture matching publishes, consumer groups get pushes on
  `_SYMBUS.deliver.<stream>.<group>`, acks ride `_SYMBUS.ack`, unacked
  deliveries redeliver after ack_wait up to max_deliver (then counted
  dead-lettered), control surface on the three reserved request-reply
  subjects plus `_SYMBUS.stats`;
- identical ON-DISK `.symlog` format (REC_META/REC_MSG/REC_ACK/REC_GROUP,
  same framing), replayed on boot with torn-tail tolerance and compacted to
  a snapshot — a SIGKILLed broker restarted over the same `--data-dir`
  loses nothing that was captured, and either broker can replay the other's
  log.

Usage:
    python -m symbiont_tpu_torch.bus.pybroker --port 4233 --data-dir data/symbus

This module imports nothing heavy (no jax, no numpy): broker boot is
fast enough for the process supervisor to restart it inside a chaos window.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import struct
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from symbiont_tpu_torch.bus.core import subject_matches

log = logging.getLogger(__name__)

OP_SUB, OP_UNSUB, OP_PUB, OP_PING, OP_MSG, OP_PONG, OP_ERR = range(1, 8)
MAX_FRAME = 64 * 1024 * 1024

# streams.hpp parity
REC_META, REC_MSG, REC_ACK, REC_GROUP = 0, 1, 2, 3
MAX_INFLIGHT = 64  # kMaxInFlight
PUMP_INTERVAL_S = 0.02
# per-connection outbound frame queue (broker.cpp keeps a bounded queue per
# Conn so routing never blocks on one slow socket); overflow drops the frame
CLIENT_QUEUE_MAX = 4096


# --------------------------------------------------------------- wire codec


class _Writer:
    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def u16(self, v: int) -> None:
        self.buf += struct.pack("<H", v)

    def u32(self, v: int) -> None:
        self.buf += struct.pack("<I", v)

    def u64(self, v: int) -> None:
        self.buf += struct.pack("<Q", v)

    def s(self, text: str) -> None:
        b = text.encode("utf-8")
        if len(b) > 0xFFFF:
            raise ValueError("string too long")
        self.u16(len(b))
        self.buf += b

    def data(self, d: bytes) -> None:
        self.u32(len(d))
        self.buf += d

    def frame(self) -> bytes:
        return struct.pack("<I", len(self.buf)) + bytes(self.buf)


class _Reader:
    __slots__ = ("b", "off")

    def __init__(self, payload: bytes):
        self.b = payload
        self.off = 0

    def _need(self, k: int) -> None:
        if self.off + k > len(self.b):
            raise ValueError("truncated frame")

    def u8(self) -> int:
        self._need(1)
        v = self.b[self.off]
        self.off += 1
        return v

    def u16(self) -> int:
        self._need(2)
        (v,) = struct.unpack_from("<H", self.b, self.off)
        self.off += 2
        return v

    def u32(self) -> int:
        self._need(4)
        (v,) = struct.unpack_from("<I", self.b, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        self._need(8)
        (v,) = struct.unpack_from("<Q", self.b, self.off)
        self.off += 8
        return v

    def s(self) -> str:
        n = self.u16()
        self._need(n)
        v = self.b[self.off:self.off + n].decode("utf-8")
        self.off += n
        return v

    def data(self) -> bytes:
        n = self.u32()
        self._need(n)
        v = bytes(self.b[self.off:self.off + n])
        self.off += n
        return v


def _msg_frame(sid: int, subject: str, reply: str,
               headers: List[Tuple[str, str]], data: bytes) -> bytes:
    w = _Writer()
    w.u8(OP_MSG)
    w.u32(sid)
    w.s(subject)
    w.s(reply)
    w.u16(len(headers))
    for k, v in headers:
        w.s(k)
        w.s(v)
    w.data(data)
    return w.frame()


# ----------------------------------------------------------- durable streams


class _Group:
    """ConsumerGroup (streams.hpp parity): ack floor + sparse acked set,
    in-flight window with deadlines, redelivery backlog."""

    def __init__(self, name: str, filter_subject: str = ""):
        self.name = name
        self.filter = filter_subject
        self.ack_floor = 0
        self.acked: set = set()
        self.inflight: Dict[int, Tuple[float, int]] = {}  # seq -> (deadline, deliveries)
        self.redeliveries: Dict[int, int] = {}            # seq -> past count
        self.next_seq = 1
        self.dead_lettered = 0

    def is_acked(self, seq: int) -> bool:
        return seq <= self.ack_floor or seq in self.acked

    def ack(self, seq: int) -> None:
        self.inflight.pop(seq, None)
        self.redeliveries.pop(seq, None)
        if seq <= self.ack_floor:
            return
        self.acked.add(seq)
        while self.ack_floor + 1 in self.acked:
            self.ack_floor += 1
            self.acked.discard(self.ack_floor)


class _Stream:
    def __init__(self, name: str):
        self.name = name
        self.subjects: List[str] = []
        self.ack_wait_ms = 30000
        self.max_deliver = 5
        self.last_seq = 0
        # seq -> (subject, headers list, data); insertion order == seq order
        self.msgs: Dict[int, Tuple[str, List[Tuple[str, str]], bytes]] = {}
        self.groups: Dict[str, _Group] = {}
        self.log = None  # open file handle when persisted

    def captures(self, subject: str) -> bool:
        return any(subject_matches(p, subject) for p in self.subjects)


class StreamEngine:
    """Durable-stream state machine + `.symlog` persistence, a line-for-line
    port of native/symbus/streams.hpp (same record types, same framing, same
    replay/compaction semantics) so the two brokers are interchangeable over
    one data directory."""

    def __init__(self, data_dir: Optional[str], deliver) -> None:
        # deliver(subject, headers_list, data) -> target count
        self.data_dir = data_dir
        self.deliver = deliver
        self.streams: Dict[str, _Stream] = {}
        if data_dir:
            Path(data_dir).mkdir(parents=True, exist_ok=True)
            self._replay_all()

    # ---- control handlers (reply JSON strings) ---------------------------

    def handle_stream_create(self, body: bytes) -> str:
        try:
            j = json.loads(body)
            name = j["stream"]
        except (ValueError, KeyError, TypeError):
            return json.dumps({"ok": False, "error": "bad request"})
        if (not name or "/" in name or ".." in name
                or not isinstance(name, str)):
            return json.dumps({"ok": False, "error": "bad stream name"})
        s = self.streams.get(name)
        fresh = s is None
        if fresh:
            s = self.streams[name] = _Stream(name)
        s.subjects = [str(p) for p in j.get("subjects", [])]
        if "ack_wait_ms" in j:
            s.ack_wait_ms = int(j["ack_wait_ms"])
        if "max_deliver" in j:
            s.max_deliver = int(j["max_deliver"])
        if fresh and self.data_dir:
            self._open_log(s)
            if s.log is None:
                # refuse to pretend durability we can't provide
                del self.streams[name]
                return json.dumps({"ok": False,
                                   "error": f"cannot persist stream {name}"})
        if s.log:
            self._append_meta(s)
        return json.dumps({"ok": True, "last_seq": s.last_seq})

    def handle_consumer_create(self, body: bytes) -> str:
        try:
            j = json.loads(body)
            sname, gname = j["stream"], j["group"]
        except (ValueError, KeyError, TypeError):
            return json.dumps({"ok": False, "error": "bad request"})
        s = self.streams.get(sname)
        if s is None:
            return json.dumps({"ok": False,
                               "error": f"unknown stream {sname}"})
        g = s.groups.get(gname)
        if g is None:
            g = s.groups[gname] = _Group(gname)
            g.next_seq = g.ack_floor + 1
        if j.get("filter_subject"):
            g.filter = str(j["filter_subject"])
        return json.dumps({"ok": True, "ack_floor": g.ack_floor})

    def handle_ack(self, body: bytes) -> str:
        try:
            j = json.loads(body)
            sname, gname, seq = j["stream"], j["group"], int(j["seq"])
        except (ValueError, KeyError, TypeError):
            return json.dumps({"ok": False, "error": "bad request"})
        s = self.streams.get(sname)
        if s is None:
            return json.dumps({"ok": False,
                               "error": f"unknown stream {sname}"})
        g = s.groups.get(gname)
        if g is None:
            return json.dumps({"ok": False,
                               "error": f"unknown group {gname}"})
        g.ack(seq)
        if s.log:
            self._append_ack(s, gname, seq)
        self._maybe_gc(s)
        return json.dumps({"ok": True})

    # ---- capture on publish ----------------------------------------------

    def capture(self, subject: str, headers: List[Tuple[str, str]],
                data: bytes) -> None:
        for s in self.streams.values():
            if not s.captures(subject):
                continue
            s.last_seq += 1
            s.msgs[s.last_seq] = (subject, list(headers), data)
            if s.log:
                self._append_msg(s, s.last_seq)

    # ---- delivery pump ----------------------------------------------------

    def pump(self) -> None:
        now = time.monotonic()
        for s in self.streams.values():
            for gname, g in s.groups.items():
                # redeliver expired in-flight
                for seq in [q for q, (dl, _) in g.inflight.items()
                            if dl <= now]:
                    deliveries = g.inflight.pop(seq)[1]
                    if deliveries >= s.max_deliver:
                        g.dead_lettered += 1
                        g.ack(seq)  # drop: counted, no longer retried
                        # persist like a client ack, else the poison message
                        # comes back with fresh budget after every restart
                        if s.log:
                            self._append_ack(s, gname, seq)
                        self._maybe_gc(s)
                        continue
                    g.redeliveries[seq] = deliveries
                # (re)deliver up to the in-flight window
                while len(g.inflight) < MAX_INFLIGHT:
                    past = 0
                    if g.redeliveries:
                        seq = min(g.redeliveries)
                        past = g.redeliveries.pop(seq)
                    else:
                        # advance past acked seqs AND seqs outside the
                        # group's filter (auto-acked so gc keeps moving)
                        while True:
                            while (g.next_seq <= s.last_seq
                                   and g.is_acked(g.next_seq)):
                                g.next_seq += 1
                            if g.next_seq > s.last_seq:
                                break
                            if g.filter:
                                m = s.msgs.get(g.next_seq)
                                if m is not None and not subject_matches(
                                        g.filter, m[0]):
                                    g.ack(g.next_seq)
                                    continue
                            break
                        if g.next_seq > s.last_seq:
                            break
                        seq = g.next_seq
                        g.next_seq += 1
                    m = s.msgs.get(seq)
                    if m is None:
                        continue  # gc'd (already acked)
                    subject, headers, data = m
                    h = list(headers) + [
                        ("X-Symbus-Stream", s.name),
                        ("X-Symbus-Group", gname),
                        ("X-Symbus-Seq", str(seq)),
                        ("X-Symbus-Subject", subject),
                        ("X-Symbus-Deliveries", str(past + 1)),
                    ]
                    targets = self.deliver(
                        f"_SYMBUS.deliver.{s.name}.{gname}", h, data)
                    if targets == 0:
                        # nobody listening: put it back, stop pushing
                        g.redeliveries[seq] = past
                        break
                    g.inflight[seq] = (now + s.ack_wait_ms / 1000.0, past + 1)

    def stats_json(self) -> str:
        out: Dict[str, dict] = {}
        for name, s in self.streams.items():
            out[name] = {
                "last_seq": s.last_seq,
                "stored": len(s.msgs),
                "groups": {g.name: {"ack_floor": g.ack_floor,
                                    "inflight": len(g.inflight),
                                    "dead_lettered": g.dead_lettered}
                           for g in s.groups.values()},
            }
        return json.dumps(out)

    # ---- gc ---------------------------------------------------------------

    def _maybe_gc(self, s: _Stream) -> None:
        if not s.groups:
            return
        floor = min(g.ack_floor for g in s.groups.values())
        for seq in [q for q in s.msgs if q <= floor]:
            del s.msgs[seq]

    # ---- persistence (byte-compatible with streams.hpp) -------------------

    def _log_path(self, name: str) -> Path:
        return Path(self.data_dir) / f"{name}.symlog"

    def _open_log(self, s: _Stream, truncate: bool = False) -> None:
        try:
            s.log = open(self._log_path(s.name), "wb" if truncate else "ab")
        except OSError as e:
            log.error("cannot open stream log %s: %s",
                      self._log_path(s.name), e)
            s.log = None

    def _write(self, s: _Stream, w: _Writer) -> None:
        s.log.write(w.frame())
        s.log.flush()

    def _append_meta(self, s: _Stream) -> None:
        w = _Writer()
        w.u8(REC_META)
        # last_seq must survive a snapshot with zero live messages (see
        # streams.hpp append_meta)
        w.data(json.dumps({"subjects": s.subjects,
                           "ack_wait_ms": s.ack_wait_ms,
                           "max_deliver": s.max_deliver,
                           "last_seq": s.last_seq}).encode())
        self._write(s, w)

    def _append_msg(self, s: _Stream, seq: int) -> None:
        subject, headers, data = s.msgs[seq]
        w = _Writer()
        w.u8(REC_MSG)
        w.u64(seq)
        w.s(subject)
        w.u16(len(headers))
        for k, v in headers:
            w.s(k)
            w.s(v)
        w.data(data)
        self._write(s, w)

    def _append_ack(self, s: _Stream, group: str, seq: int) -> None:
        w = _Writer()
        w.u8(REC_ACK)
        w.s(group)
        w.u64(seq)
        self._write(s, w)

    def _append_group(self, s: _Stream, g: _Group) -> None:
        w = _Writer()
        w.u8(REC_GROUP)
        w.s(g.name)
        w.u64(g.ack_floor)
        w.u32(len(g.acked))
        for seq in sorted(g.acked):
            w.u64(seq)
        self._write(s, w)

    def _compact(self, s: _Stream) -> None:
        """Rewrite the log as a live-state snapshot (meta + group floors +
        unacked messages) via temp-file + rename — a crash mid-compaction
        leaves the previous log intact."""
        tmp = self._log_path(s.name).with_suffix(".symlog.tmp")
        try:
            f = open(tmp, "wb")
        except OSError as e:
            log.error("cannot write %s: %s", tmp, e)
            self._open_log(s)
            return
        prev, s.log = s.log, f
        self._append_meta(s)
        for g in s.groups.values():
            self._append_group(s, g)
        for seq in s.msgs:
            self._append_msg(s, seq)
        f.close()
        s.log = prev
        try:
            tmp.replace(self._log_path(s.name))
        except OSError as e:
            log.error("rename %s failed: %s", tmp, e)
            tmp.unlink(missing_ok=True)
        self._open_log(s)

    def _replay_all(self) -> None:
        for p in sorted(Path(self.data_dir).glob("*.symlog")):
            self._replay_one(p.stem)

    def _replay_one(self, name: str) -> None:
        try:
            buf = self._log_path(name).read_bytes()
        except OSError:
            return
        s = self.streams.setdefault(name, _Stream(name))
        off = 0
        while off + 4 <= len(buf):
            (n,) = struct.unpack_from("<I", buf, off)
            if n == 0 or off + 4 + n > len(buf):
                break  # torn tail: stop at the last good frame
            try:
                r = _Reader(buf[off + 4:off + 4 + n])
                rec = r.u8()
                if rec == REC_META:
                    m = json.loads(r.data())
                    s.subjects = [str(x) for x in m["subjects"]]
                    s.ack_wait_ms = int(m["ack_wait_ms"])
                    s.max_deliver = int(m["max_deliver"])
                    if "last_seq" in m:
                        s.last_seq = max(s.last_seq, int(m["last_seq"]))
                elif rec == REC_MSG:
                    seq = r.u64()
                    subject = r.s()
                    headers = [(r.s(), r.s()) for _ in range(r.u16())]
                    data = r.data()
                    s.last_seq = max(s.last_seq, seq)
                    s.msgs[seq] = (subject, headers, data)
                elif rec == REC_ACK:
                    group = r.s()
                    seq = r.u64()
                    s.groups.setdefault(group, _Group(group)).ack(seq)
                elif rec == REC_GROUP:
                    group = r.s()
                    g = s.groups.setdefault(group, _Group(group))
                    g.ack_floor = r.u64()
                    for _ in range(r.u32()):
                        g.acked.add(r.u64())
            except (ValueError, KeyError, struct.error):
                break  # corrupt record: stop replay at last good frame
            off += 4 + n
        # consumers resume after the acked prefix
        for g in s.groups.values():
            g.next_seq = g.ack_floor + 1
        self._maybe_gc(s)
        self._compact(s)
        log.info("stream %s replayed: last_seq=%d stored=%d groups=%s",
                 name, s.last_seq, len(s.msgs), sorted(s.groups))

    def close(self) -> None:
        for s in self.streams.values():
            if s.log:
                try:
                    s.log.close()
                except OSError:
                    pass
                s.log = None


# ------------------------------------------------------------------- broker


class _Client:
    def __init__(self, cid: int, writer: asyncio.StreamWriter):
        self.cid = cid
        self.writer = writer
        self.subs: Dict[int, Tuple[str, str]] = {}  # sid -> (pattern, queue)
        self.outq: deque = deque()
        self.wake = asyncio.Event()
        self.closed = False
        self.dropped = 0

    def enqueue(self, frame: bytes) -> bool:
        """Bounded per-connection queue (broker.cpp parity): routing never
        blocks on one slow socket; overflow drops the frame, counted."""
        if self.closed:
            return False
        if len(self.outq) >= CLIENT_QUEUE_MAX:
            self.dropped += 1
            return False
        self.outq.append(frame)
        self.wake.set()
        return True


class PyBroker:
    """The broker itself: asyncio TCP server + stream engine + pump task."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4233,
                 data_dir: Optional[str] = None):
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._clients: Dict[int, _Client] = {}
        self._next_cid = 1
        self._rr: Dict[Tuple[str, str], int] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._writer_tasks: List[asyncio.Task] = []
        self.streams = StreamEngine(data_dir, self._route)
        self.stats = {"published": 0, "delivered": 0, "dropped": 0}

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self._pump_task = asyncio.create_task(self._pump_loop(),
                                              name="symbus-pump")
        log.info("pybroker listening on %s:%d", self.host, self.bound_port)

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._pump_task:
            self._pump_task.cancel()
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for c in list(self._clients.values()):
            c.closed = True
            c.wake.set()
            try:
                c.writer.close()
            except (ConnectionError, OSError):
                pass
        for t in self._writer_tasks:
            t.cancel()
        if self._writer_tasks:
            await asyncio.gather(*self._writer_tasks, return_exceptions=True)
        self.streams.close()

    async def _pump_loop(self) -> None:
        while True:
            try:
                self.streams.pump()
            except Exception:
                log.exception("stream pump failed (continuing)")
            await asyncio.sleep(PUMP_INTERVAL_S)

    # ------------------------------------------------------------- routing

    def _route(self, subject: str, headers: List[Tuple[str, str]],
               data: bytes, reply: str = "") -> int:
        """Deliver to every matching plain sub + one member per queue
        group (round-robin). Returns the number of targets reached."""
        plain: List[Tuple[_Client, int]] = []
        groups: Dict[Tuple[str, str], List[Tuple[_Client, int]]] = {}
        for c in self._clients.values():
            if c.closed:
                continue
            for sid, (pattern, queue) in c.subs.items():
                if not subject_matches(pattern, subject):
                    continue
                if queue:
                    groups.setdefault((pattern, queue), []).append((c, sid))
                else:
                    plain.append((c, sid))
        targets = list(plain)
        for key, members in groups.items():
            i = self._rr.get(key, 0) % len(members)
            self._rr[key] = i + 1
            targets.append(members[i])
        n = 0
        for c, sid in targets:
            if c.enqueue(_msg_frame(sid, subject, reply, headers, data)):
                self.stats["delivered"] += 1
                n += 1
            else:
                self.stats["dropped"] += 1
        return n

    # ---------------------------------------------------------- connection

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        import socket as _socket

        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        cid = self._next_cid
        self._next_cid += 1
        client = _Client(cid, writer)
        self._clients[cid] = client
        wt = asyncio.create_task(self._writer_loop(client),
                                 name=f"symbus-writer-{cid}")
        self._writer_tasks.append(wt)
        wt.add_done_callback(lambda t: self._writer_tasks.remove(t)
                             if t in self._writer_tasks else None)
        try:
            while True:
                head = await reader.readexactly(4)
                (n,) = struct.unpack("<I", head)
                if n == 0 or n > MAX_FRAME:
                    raise ConnectionError(f"bad frame length {n}")
                payload = await reader.readexactly(n)
                self._handle_frame(client, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("client %d frame handling failed", cid)
        finally:
            client.closed = True
            client.wake.set()
            self._clients.pop(cid, None)
            try:
                writer.close()
            except (ConnectionError, OSError):
                pass

    async def _writer_loop(self, client: _Client) -> None:
        try:
            while True:
                while client.outq:
                    frame = client.outq.popleft()
                    client.writer.write(frame)
                await client.writer.drain()
                if client.closed and not client.outq:
                    return
                client.wake.clear()
                if not client.outq:
                    await client.wake.wait()
        except (ConnectionError, OSError, asyncio.CancelledError):
            client.closed = True

    def _handle_frame(self, client: _Client, payload: bytes) -> None:
        r = _Reader(payload)
        op = r.u8()
        if op == OP_SUB:
            sid = r.u32()
            subject = r.s()
            queue = r.s()
            client.subs[sid] = (subject, queue)
        elif op == OP_UNSUB:
            client.subs.pop(r.u32(), None)
        elif op == OP_PING:
            w = _Writer()
            w.u8(OP_PONG)
            client.enqueue(w.frame())
        elif op == OP_PUB:
            subject = r.s()
            reply = r.s()
            headers = [(r.s(), r.s()) for _ in range(r.u16())]
            data = r.data()
            self.stats["published"] += 1
            if subject.startswith("_SYMBUS."):
                self._handle_control(subject, reply, data)
                return
            # durable capture BEFORE fan-out (at-least-once), _INBOX
            # excluded by convention (broker.cpp:310)
            if not subject.startswith("_INBOX."):
                self.streams.capture(subject, headers, data)
            self._route(subject, headers, data, reply=reply)

    def _handle_control(self, subject: str, reply: str,
                        data: bytes) -> None:
        if subject == "_SYMBUS.stream.create":
            out = self.streams.handle_stream_create(data)
        elif subject == "_SYMBUS.consumer.create":
            out = self.streams.handle_consumer_create(data)
        elif subject == "_SYMBUS.ack":
            out = self.streams.handle_ack(data)
        elif subject == "_SYMBUS.stats":
            out = self.streams.stats_json()
        else:
            out = json.dumps({"ok": False,
                              "error": f"unknown control subject {subject}"})
        if reply:
            self._route(reply, [], out.encode())


async def _amain(args) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    broker = PyBroker(args.host, args.port, data_dir=args.data_dir)
    await broker.start()
    stop = asyncio.Event()
    import signal

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    await broker.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="pure-Python symbus broker (wire/log-compatible with "
                    "native/symbus)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=4233)
    ap.add_argument("--data-dir", default=None,
                    help="persist durable streams as .symlog files here "
                         "(same format as the native broker)")
    args = ap.parse_args(argv)
    asyncio.run(_amain(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
