"""The port's in-process bus and embed batcher, case for case with the JAX
package's: pub/sub with wildcards, queue groups, request-reply and its
timeout, headers, drop-on-overflow, durable capture with ack, redelivery
and max_deliver to the dead-letter store and its replay, and the
`MicroBatcher` flushing by size and by deadline over a stub engine, with
two flushes in flight. Every case runs on both packages (`pkg`), so one
behaviour is checked once and counts for each."""

import asyncio
import time
import types

import numpy as np
import pytest

import symbiont_tpu.bus.core as jcore
import symbiont_tpu.bus.inproc as jinproc
import symbiont_tpu.config as jconfig
import symbiont_tpu.engine.batcher as jbatcher
import symbiont_tpu.utils.telemetry as jtelemetry
import symbiont_tpu_torch.bus.core as tcore
import symbiont_tpu_torch.bus.inproc as tinproc
import symbiont_tpu_torch.config as tconfig
import symbiont_tpu_torch.engine.batcher as tbatcher
import symbiont_tpu_torch.utils.telemetry as ttelemetry

PACKAGES = {
    "jax": types.SimpleNamespace(core=jcore, inproc=jinproc, config=jconfig,
                                 batcher=jbatcher, metrics=jtelemetry.metrics),
    "port": types.SimpleNamespace(core=tcore, inproc=tinproc, config=tconfig,
                                  batcher=tbatcher, metrics=ttelemetry.metrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _run(coro):
    return asyncio.run(coro)


@pytest.mark.parametrize("pattern,subject,match", [
    ("a.b.c", "a.b.c", True), ("a.b.c", "a.b", False), ("a.b", "a.b.c", False),
    ("a.*.c", "a.x.c", True), ("a.*.c", "a.x.y", False), ("a.>", "a.b.c", True),
    ("a.>", "a.b", True), ("a.>", "a", False), ("x.>", "a.b", False)])
def test_subject_matching(pkg, pattern, subject, match):
    assert pkg.core.subject_matches(pattern, subject) is match


def test_pub_sub_fanout_and_wildcards(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        s1 = await bus.subscribe("t.x")
        s2 = await bus.subscribe("t.*")
        s3 = await bus.subscribe("t.>")
        await bus.publish("t.x", b"hello")
        for s in (s1, s2, s3):
            assert (await s.next(1)).data == b"hello"
        await bus.publish("t.x.y", b"deep")
        assert (await s3.next(1)).data == b"deep"
        assert await s2.next(0.05) is None
        await bus.close()

    _run(main())


def test_queue_group_delivers_to_one_member(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        a = await bus.subscribe("work", queue="g")
        b = await bus.subscribe("work", queue="g")
        plain = await bus.subscribe("work")
        for i in range(10):
            await bus.publish("work", str(i).encode())
        got_a = got_b = got_plain = 0
        while await a.next(0.01):
            got_a += 1
        while await b.next(0.01):
            got_b += 1
        while await plain.next(0.01):
            got_plain += 1
        assert (got_a, got_b, got_plain) == (5, 5, 10)  # round-robin, plain sees all
        await bus.close()

    _run(main())


def test_request_reply_and_timeout(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        sub = await bus.subscribe("svc.echo")

        async def responder():
            msg = await sub.next(2)
            await bus.publish(msg.reply, b"pong:" + msg.data)

        task = asyncio.create_task(responder())
        reply = await bus.request("svc.echo", b"ping", timeout=2)
        assert reply.data == b"pong:ping"
        await task
        with pytest.raises(TimeoutError):
            await bus.request("svc.nobody", b"x", timeout=0.05)
        await bus.close()

    _run(main())


def test_headers_propagate_and_overflow_drops_are_counted(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        sub = await bus.subscribe("h.test")
        await bus.publish("h.test", b"x", headers={"X-Trace-Id": "t-123"})
        assert (await sub.next(1)).headers["X-Trace-Id"] == "t-123"
        flood = await bus.subscribe("flood.bus", maxsize=2)
        before = pkg.metrics.get("bus.dropped", labels={"subject": "flood.bus"})
        for i in range(7):
            await bus.publish("flood.bus", str(i).encode())
        assert pkg.metrics.get("bus.dropped", labels={"subject": "flood.bus"}) - before == 5
        got = 0
        while await flood.next(0.01):
            got += 1
        assert got == 2
        await bus.close()
        with pytest.raises(RuntimeError):
            await bus.publish("x", b"y")

    _run(main())


def test_durable_capture_ack_redeliver(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        await bus.add_stream("ingest", ["data.raw_text.>"], ack_wait_s=0.15, max_deliver=3)
        await bus.publish("data.raw_text.discovered", b"one")  # no consumer yet
        await bus.publish("data.other", b"not captured")
        sub = await bus.durable_subscribe("ingest", "workers")
        m = await sub.next(2.0)
        assert m.data == b"one" and m.headers["X-Symbus-Deliveries"] == "1"
        r = await sub.next(2.0)  # unacked: redelivered after ack_wait
        assert int(r.headers["X-Symbus-Deliveries"]) == 2
        await bus.ack(r)
        assert await sub.next(0.4) is None
        g = (await bus.stream_stats())["ingest"]["groups"]["workers"]
        assert g["ack_floor"] == 1 and g["inflight"] == 0
        await bus.close()

    _run(main())


def test_durable_max_deliver_dead_letters_and_replays(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        await bus.add_stream("p", ["a.>"], ack_wait_s=0.05, max_deliver=2)
        dlq_sub = await bus.subscribe("dlq.a.poison")
        sub = await bus.durable_subscribe("p", "g")
        await bus.publish("a.poison", b"bad")
        seen = 0
        while seen < 2:  # never acked: delivered max_deliver times
            if await sub.next(1.0) is not None:
                seen += 1
        dead = await dlq_sub.next(2.0)
        assert dead is not None and dead.data == b"bad"
        assert bus.stats["dead_lettered"] == 1 and len(bus.dlq) == 1
        entry = bus.dlq.list()[0]
        assert entry.subject == "a.poison" and entry.deliveries == 2
        assert await bus.dlq.replay(bus, entry.id) == 1
        again = await sub.next(2.0)  # back in the stream, a fresh budget
        assert again.data == b"bad" and again.headers["X-Symbus-Deliveries"] == "1"
        await bus.ack(again)
        await bus.close()

    _run(main())


def test_durable_groups_share_and_filters_auto_ack(pkg):
    async def main():
        bus = pkg.inproc.InprocBus()
        await bus.add_stream("p", ["a.x", "a.y"], ack_wait_s=5.0)
        sub_x = await bus.durable_subscribe("p", "gx", filter_subject="a.x")
        sub_y = await bus.durable_subscribe("p", "gy", filter_subject="a.y")
        for i in range(4):
            await bus.publish("a.x" if i % 2 == 0 else "a.y", str(i).encode())
        for _ in range(2):
            mx, my = await sub_x.next(2.0), await sub_y.next(2.0)
            assert (mx.subject, my.subject) == ("a.x", "a.y")
            await bus.ack(mx)
            await bus.ack(my)
        stats = await bus.stream_stats()
        assert stats["p"]["groups"]["gx"]["ack_floor"] == 4
        assert stats["p"]["groups"]["gy"]["ack_floor"] == 4
        with pytest.raises(RuntimeError):
            await bus.durable_subscribe("p", "gx", filter_subject="a.y")
        with pytest.raises(RuntimeError):
            await bus.durable_subscribe("nope", "g")
        await bus.close()

    _run(main())


# ---------------------------------------------------------------- batcher

class _StubEngine:
    """Each row encodes its text's number, so a row routed to the wrong
    submitter shows; `delays` slows the forwards in call order."""

    def __init__(self, config, delays=()):
        self.config = config
        self.calls = []
        self._delays = list(delays)

    def embed_texts(self, texts):
        self.calls.append(list(texts))
        if self._delays:
            time.sleep(self._delays.pop(0))
        return np.asarray([[float(t.split("-")[1])] * 4 for t in texts], np.float32)


def _cfg(pkg, **kw):
    return pkg.config.EngineConfig(embedding_dim=4, **kw)


def test_micro_batcher_flushes_when_full(pkg):
    eng = _StubEngine(_cfg(pkg, max_batch=4, flush_deadline_ms=10_000.0))

    async def main():
        b = pkg.batcher.MicroBatcher(eng)
        await b.start()
        t0 = time.monotonic()
        r1, r2 = await asyncio.gather(b.embed(["t-1", "t-2"]), b.embed(["t-3", "t-4"]))
        waited = time.monotonic() - t0
        await b.close()
        return r1, r2, waited

    r1, r2, waited = _run(main())
    assert waited < 5.0  # the size filled before the 10 s deadline
    assert eng.calls == [["t-1", "t-2", "t-3", "t-4"]]
    np.testing.assert_array_equal(r1[:, 0], [1, 2])
    np.testing.assert_array_equal(r2[:, 0], [3, 4])


def test_micro_batcher_flushes_at_the_deadline(pkg):
    eng = _StubEngine(_cfg(pkg, max_batch=64, flush_deadline_ms=30.0))

    async def main():
        b = pkg.batcher.MicroBatcher(eng)
        await b.start()
        t0 = time.monotonic()
        r = await b.embed(["t-7"])
        waited = time.monotonic() - t0
        await b.close()
        return r, waited

    r, waited = _run(main())
    assert 0.025 <= waited < 2.0 and eng.calls == [["t-7"]]
    np.testing.assert_array_equal(r[:, 0], [7])


def test_micro_batcher_keeps_two_flushes_in_flight_and_routes_rows(pkg):
    eng = _StubEngine(_cfg(pkg, max_batch=2, flush_deadline_ms=1.0, max_inflight_flushes=2),
                      delays=[0.4, 0.1])
    labels = {"service": "engine", "batcher": "embed"}

    async def main():
        b = pkg.batcher.MicroBatcher(eng)
        await b.start()
        order = []
        a = asyncio.create_task(b.embed(["t-0", "t-1"]))
        a.add_done_callback(lambda _: order.append("a"))
        await asyncio.sleep(0.05)
        c = asyncio.create_task(b.embed(["t-10", "t-11"]))
        c.add_done_callback(lambda _: order.append("c"))
        await asyncio.sleep(0.05)
        inflight = pkg.metrics.gauge_get("batcher.inflight", labels=labels)
        va, vc = await asyncio.gather(a, c)
        await b.close()
        return order, inflight, va, vc

    order, inflight, va, vc = _run(main())
    assert inflight == 2 and order == ["c", "a"]  # the second flush overtook the first
    np.testing.assert_array_equal(va[:, 0], [0, 1])
    np.testing.assert_array_equal(vc[:, 0], [10, 11])


def test_micro_batcher_propagates_errors(pkg):
    eng = _StubEngine(_cfg(pkg, max_batch=2, flush_deadline_ms=5.0))

    def boom(texts):
        raise ValueError("device on fire")

    eng.embed_texts = boom

    async def main():
        b = pkg.batcher.MicroBatcher(eng)
        await b.start()
        with pytest.raises(ValueError, match="device on fire"):
            await b.embed(["t-1"])
        await b.close()

    _run(main())
