"""The port's TCP bus (`bus/tcp.py`) against the port's Python broker
(`bus/pybroker.py`), case for case with the JAX package's pair: pub/sub
with wildcards and headers, queue groups sharding exactly once, request
and reply and its timeout, a 4 MiB payload, unsubscribe, durable capture
with ack, redelivery, filter auto-ack and max_deliver dead-lettering, the
`.symlog` replay of unacked work across a broker restart, `connect` over
`symbus://` and its alias `nats://`, and an unreachable broker failing after
the retries with no fallback to the in-process bus. Every case runs on both
packages (`pkg`); the wire is one protocol, so a port client also talks to
the JAX broker and the other way round."""

import asyncio
import socket
import time
import types

import pytest

import symbiont_tpu.bus.pybroker as jpybroker
import symbiont_tpu.bus.tcp as jtcp
import symbiont_tpu_torch.bus.pybroker as tpybroker
import symbiont_tpu_torch.bus.tcp as ttcp
from symbiont_tpu.bus.connect import connect as jconnect
from symbiont_tpu_torch.bus.connect import connect as tconnect

PACKAGES = {
    "jax": types.SimpleNamespace(tcp=jtcp, pybroker=jpybroker, connect=jconnect),
    "port": types.SimpleNamespace(tcp=ttcp, pybroker=tpybroker, connect=tconnect),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _client(pkg, port):
    bus = pkg.tcp.TcpBus("127.0.0.1", port)
    await bus.connect()
    return bus


def _with_broker(pkg, body, n_clients=2, data_dir=None, client_pkg=None):
    """Run `body(broker, clients)` against a fresh broker of `pkg`, the
    clients of `client_pkg` (default the same package)."""
    async def main():
        broker = pkg.pybroker.PyBroker(port=0, data_dir=data_dir)
        await broker.start()
        clients = [await _client(client_pkg or pkg, broker.bound_port)
                   for _ in range(n_clients)]
        try:
            await body(broker, clients)
        finally:
            for c in clients:
                await c.close()
            await broker.stop()

    asyncio.run(main())


def test_pub_sub_wildcards_and_headers(pkg):
    async def body(broker, clients):
        a, b = clients
        star = await b.subscribe("greet.*")
        tail = await b.subscribe("greet.>")
        await asyncio.sleep(0.05)
        await a.publish("greet.world", "привет".encode(), headers={"X-Trace-Id": "t1"})
        for sub in (star, tail):
            msg = await sub.next(2)
            assert msg.subject == "greet.world" and msg.data.decode() == "привет"
            assert msg.headers["X-Trace-Id"] == "t1"
        await a.publish("greet.deep.er", b"deep")
        assert (await tail.next(2)).data == b"deep"
        assert await star.next(0.1) is None

    _with_broker(pkg, body)


def test_queue_group_delivers_each_message_once(pkg):
    async def body(broker, clients):
        a, b, c = clients
        s1 = await b.subscribe("jobs", queue="workers")
        s2 = await c.subscribe("jobs", queue="workers")
        await asyncio.sleep(0.05)
        for i in range(10):
            await a.publish("jobs", str(i).encode())
        got = {1: [], 2: []}
        deadline = time.time() + 5
        while len(got[1]) + len(got[2]) < 10 and time.time() < deadline:
            for k, s in ((1, s1), (2, s2)):
                m = await s.next(0.02)
                if m is not None:
                    got[k].append(int(m.data))
        assert sorted(got[1] + got[2]) == list(range(10))
        assert got[1] and got[2]  # round robin over the members

    _with_broker(pkg, body, n_clients=3)


def test_request_reply_and_its_timeout(pkg):
    async def body(broker, clients):
        a, b = clients
        esub = await b.subscribe("svc.echo")

        async def responder():
            m = await esub.next(3)
            await b.publish(m.reply, b"pong:" + m.data)

        task = asyncio.create_task(responder())
        reply = await a.request("svc.echo", b"ping", timeout=3)
        assert reply.data == b"pong:ping"
        await task
        with pytest.raises(TimeoutError):
            await a.request("svc.nobody", b"x", timeout=0.2)

    _with_broker(pkg, body)


def test_large_payload(pkg):
    async def body(broker, clients):
        a, b = clients
        sub = await b.subscribe("big")
        await asyncio.sleep(0.05)
        payload = bytes(range(256)) * (4 * 4096)  # 4 MiB
        await a.publish("big", payload)
        msg = await sub.next(5)
        assert msg is not None and msg.data == payload

    _with_broker(pkg, body)


def test_unsubscribe_stops_delivery(pkg):
    async def body(broker, clients):
        a, b = clients
        sub = await b.subscribe("u.x")
        await asyncio.sleep(0.05)
        await a.publish("u.x", b"1")
        assert (await sub.next(2)).data == b"1"
        sub.close()
        await asyncio.sleep(0.1)
        await a.publish("u.x", b"2")
        assert await sub.next(0.3) is None

    _with_broker(pkg, body)


def test_durable_redelivery_filter_and_dead_letter(pkg):
    async def body(broker, clients):
        a, b = clients
        await a.add_stream("s", ["data.>"], ack_wait_s=0.15, max_deliver=3)
        d = await b.durable_subscribe("s", "g", filter_subject="data.keep.*")
        await a.publish("data.keep.1", b"keep")
        await a.publish("data.skip", b"skip")  # outside the filter: auto-acked
        for n in (1, 2, 3):  # unacked: redelivered, the attempt counted
            m = await d.next(2)
            assert m is not None and m.data == b"keep"
            assert m.headers["X-Symbus-Deliveries"] == str(n)
        assert await d.next(0.5) is None  # max_deliver spent: dead-lettered
        g = (await a.stream_stats())["s"]["groups"]["g"]
        assert g["dead_lettered"] == 1 and g["ack_floor"] == 2

    _with_broker(pkg, body)


def test_symlog_replays_unacked_work_after_a_restart(pkg, tmp_path):
    async def main():
        broker = pkg.pybroker.PyBroker(port=0, data_dir=str(tmp_path))
        await broker.start()
        a = await _client(pkg, broker.bound_port)
        await a.add_stream("p", ["work.>"], ack_wait_s=0.2, max_deliver=5)
        d = await a.durable_subscribe("p", "g")
        await a.publish("work.1", b"acked")
        m = await d.next(2)
        assert m.data == b"acked"
        await a.ack(m)
        await a.publish("work.2", b"survivor")
        assert (await d.next(2)).data == b"survivor"  # not acked
        await a.close()
        await broker.stop()
        assert (tmp_path / "p.symlog").exists()

        broker2 = pkg.pybroker.PyBroker(port=0, data_dir=str(tmp_path))
        await broker2.start()
        b = await _client(pkg, broker2.bound_port)
        try:
            d2 = await b.durable_subscribe("p", "g")
            m = await d2.next(3)
            assert m is not None and m.data == b"survivor"
            assert int(m.headers["X-Symbus-Seq"]) == 2
            await b.ack(m)
            assert await d2.next(0.5) is None
            assert (await b.stream_stats())["p"]["groups"]["g"]["ack_floor"] == 2
        finally:
            await b.close()
            await broker2.stop()

    asyncio.run(main())


@pytest.mark.parametrize("broker_pkg,client_pkg", [("jax", "port"), ("port", "jax")])
def test_one_wire_across_the_packages(broker_pkg, client_pkg):
    async def body(broker, clients):
        a, b = clients
        sub = await b.subscribe("x.*", queue="q")
        await asyncio.sleep(0.05)
        await a.publish("x.y", b"across", headers={"k": "v"})
        m = await sub.next(2)
        assert m.data == b"across" and m.headers["k"] == "v"

    _with_broker(PACKAGES[broker_pkg], body, client_pkg=PACKAGES[client_pkg])


@pytest.mark.parametrize("scheme", ["symbus", "nats"])
def test_connect_dials_the_broker_by_url(pkg, scheme):
    async def body(broker, clients):
        bus = await pkg.connect(f"{scheme}://127.0.0.1:{broker.bound_port}", retries=1)
        try:
            assert isinstance(bus, pkg.tcp.TcpBus)
            sub = await clients[0].subscribe("hello")
            await asyncio.sleep(0.05)
            await bus.publish("hello", b"1")
            assert (await sub.next(2)).data == b"1"
        finally:
            await bus.close()

    _with_broker(pkg, body, n_clients=1)


def test_an_unreachable_broker_fails_without_fallback(pkg):
    port = _free_port()  # nothing listens there
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="unreachable"):
        asyncio.run(pkg.connect(f"symbus://127.0.0.1:{port}", retries=3,
                                        retry_delay_s=0.05))
    assert time.monotonic() - t0 < 10


def test_pybroker_main_runs_as_a_module(pkg, tmp_path):
    """`python -m <package>.bus.pybroker` serves clients (what
    `pybroker_spec` launches)."""
    import subprocess
    import sys

    port = _free_port()
    mod = pkg.pybroker.__name__
    proc = subprocess.Popen([sys.executable, "-m", mod, "--host", "127.0.0.1", "--port",
                             str(port), "--data-dir", str(tmp_path)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        async def main():
            a = await pkg.connect(f"symbus://127.0.0.1:{port}", retries=100,
                                          retry_delay_s=0.1)
            b = await _client(pkg, port)
            try:
                sub = await b.subscribe("m")
                await asyncio.sleep(0.05)
                await a.publish("m", b"ok")
                assert (await sub.next(3)).data == b"ok"
            finally:
                await a.close()
                await b.close()

        asyncio.run(main())
    finally:
        proc.kill()
        proc.wait(timeout=10)
