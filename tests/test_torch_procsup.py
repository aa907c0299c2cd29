"""The port's process supervisor (`resilience/procsup.py`) with real OS
processes over its own broker, case for case with the JAX package's: a
SIGKILLed worker restarts with backoff, a SIGSTOPped one is found by its
stalled heartbeats, killed and restarted; the broker killed under a
supervised worker restarts without the worker judged for the gap; and an
elastic role scaled out to a replica that shares its durable queue group,
then scaled in through the drain protocol while traffic flows, loses no
message. Every case runs on both packages (`pkg`): the toy workers import
that package's `bus.connect`, and `pybroker_spec` launches that package's
broker. Waits are conditions with deadlines; every child is stopped in a
`finally`."""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import time
import types

import pytest

import symbiont_tpu.bus.pybroker as jpybroker
import symbiont_tpu.bus.tcp as jtcp
import symbiont_tpu.resilience.procsup as jprocsup
import symbiont_tpu_torch.bus.pybroker as tpybroker
import symbiont_tpu_torch.bus.tcp as ttcp
import symbiont_tpu_torch.resilience.procsup as tprocsup

PACKAGES = {
    "jax": types.SimpleNamespace(name="symbiont_tpu", pybroker=jpybroker, tcp=jtcp,
                                 procsup=jprocsup),
    "port": types.SimpleNamespace(name="symbiont_tpu_torch", pybroker=tpybroker, tcp=ttcp,
                                  procsup=tprocsup),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a heartbeat worker that imports nothing heavy: the supervisor's contract
# is exercised by signals, not by what the worker computes
_TOY_WORKER = """
import asyncio, importlib, sys
connect = importlib.import_module(sys.argv[3] + ".bus.connect").connect

async def main():
    bus = await connect("symbus://127.0.0.1:" + sys.argv[1])
    while True:
        await bus.publish("_sys.heartbeat." + sys.argv[2], b"{}")
        await asyncio.sleep(0.15)

asyncio.run(main())
"""


def _toy_spec(pkg, port: int, role: str, timeout_s: float = 2.0):
    return pkg.procsup.WorkerSpec(
        role=role, argv=[sys.executable, "-c", _TOY_WORKER, str(port), role, pkg.name],
        heartbeat_timeout_s=timeout_s, boot_grace_s=30.0, backoff_base_s=0.1, backoff_max_s=1.0)


def test_sigkill_restarts_and_sigstop_is_detected(pkg, tmp_path):
    async def main():
        broker = pkg.pybroker.PyBroker(port=0, data_dir=str(tmp_path / "bus"))
        await broker.start()
        port = broker.bound_port
        sup = pkg.procsup.ProcessSupervisor(bus_url=f"symbus://127.0.0.1:{port}",
                                            stdio=subprocess.DEVNULL)
        sup.add_worker(_toy_spec(pkg, port, "toy"))
        await sup.start()
        try:
            await sup.wait_role_up("toy", after=time.monotonic() - 1, timeout_s=30)
            t_kill = time.monotonic()
            os.kill(sup.pid("toy"), signal.SIGKILL)
            ts = await sup.wait_role_up("toy", after=t_kill, timeout_s=30)
            assert sup.restarts("toy") == 1 and ts - t_kill < 15
            t_stop = time.monotonic()
            os.kill(sup.pid("toy"), signal.SIGSTOP)  # alive, silent
            ts = await sup.wait_role_up("toy", after=t_stop + 2.0, timeout_s=30)
            assert sup.restarts("toy") == 2 and ts - t_stop < 20
        finally:
            await sup.stop()
            await broker.stop()

    asyncio.run(main())


def test_broker_death_is_not_blamed_on_the_worker(pkg, tmp_path):
    async def main():
        port = _free_port()
        sup = pkg.procsup.ProcessSupervisor(bus_url=f"symbus://127.0.0.1:{port}",
                                            stdio=subprocess.DEVNULL)
        spec = pkg.procsup.pybroker_spec(port, str(tmp_path / "bus"), heartbeat_timeout_s=2.0)
        assert spec.argv[1:3] == ["-m", f"{pkg.name}.bus.pybroker"]
        sup.add_worker(spec)
        sup.add_worker(_toy_spec(pkg, port, "toy", timeout_s=3.0))
        await sup.start()
        try:
            await sup.wait_role_up("toy", after=time.monotonic() - 1, timeout_s=30)
            t_kill = time.monotonic()
            os.kill(sup.pid("broker"), signal.SIGKILL)
            await sup.wait_role_up("broker", after=t_kill, timeout_s=30)
            await sup.wait_role_up("toy", after=t_kill + 0.5, timeout_s=30)
            assert sup.restarts("broker") == 1 and sup.restarts("toy") == 0
        finally:
            await sup.stop()

    asyncio.run(main())


# a durable consumer that runs the worker half of the drain protocol: on
# `_sys.drain.<role>` it detaches, beats `draining: true` and exits 0.
# argv: port, out path, role, package
_DRAIN_WORKER = """
import asyncio, importlib, json, os, sys
from pathlib import Path
connect = importlib.import_module(sys.argv[4] + ".bus.connect").connect
PORT, OUT = int(sys.argv[1]), Path(sys.argv[2])
ROLE = os.environ.get("SYMBIONT_RUNNER_ROLE") or sys.argv[3]

def payload(draining):
    return json.dumps({"role": ROLE, "pid": os.getpid(), "capacity": 0 if draining else 1,
                       "draining": draining}).encode()

async def main():
    bus = await connect("symbus://127.0.0.1:%d" % PORT)
    await bus.add_stream("w", ["job.>"], ack_wait_s=0.5, max_deliver=50)
    sub = await bus.durable_subscribe("w", "g")
    drain_sub = await bus.subscribe("_sys.drain." + ROLE)
    draining = asyncio.Event()

    async def beat():
        while True:
            await bus.publish("_sys.heartbeat." + ROLE, payload(draining.is_set()))
            await asyncio.sleep(0.15)

    async def drain_watch():
        await drain_sub.next(None)
        draining.set()

    loop = asyncio.get_running_loop()
    tasks = [loop.create_task(beat()), loop.create_task(drain_watch())]
    while not draining.is_set():
        msg = await sub.next(0.1)
        if msg is None:
            continue
        with open(OUT, "a") as f:
            f.write(msg.data.decode() + chr(10))
            f.flush()
            os.fsync(f.fileno())
        await bus.ack(msg)
    sub.close()
    await bus.publish("_sys.heartbeat." + ROLE, payload(True))
    await bus.flush()
    sys.exit(0)

asyncio.run(main())
"""


def _landed(out) -> set:
    return set(out.read_text().splitlines()) if out.exists() else set()


def test_scale_out_and_a_drained_scale_in_lose_nothing(pkg, tmp_path):
    async def wait_landed(out, want):
        deadline = time.monotonic() + 30
        while not want <= _landed(out) and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert want <= _landed(out), sorted(want - _landed(out))

    async def main():
        broker = pkg.pybroker.PyBroker(port=0, data_dir=str(tmp_path / "bus"))
        await broker.start()
        port = broker.bound_port
        out = tmp_path / "landed.txt"
        sup = pkg.procsup.ProcessSupervisor(bus_url=f"symbus://127.0.0.1:{port}",
                                            stdio=subprocess.DEVNULL, drain_deadline_s=10.0)
        sup.add_worker(pkg.procsup.WorkerSpec(
            role="embed", argv=[sys.executable, "-c", _DRAIN_WORKER, str(port), str(out),
                                "embed", pkg.name],
            heartbeat_timeout_s=3.0, boot_grace_s=30.0, backoff_base_s=0.1,
            backoff_max_s=1.0))
        await sup.start()
        pub = pkg.tcp.TcpBus("127.0.0.1", port)
        await pub.connect()
        try:
            t0 = time.monotonic()
            await sup.wait_role_up("embed", after=t0 - 1, timeout_s=30)
            assert (await sup.scale_role("embed", 2))["added"] == ["embed-2"]
            assert sup.replicas("embed") == ["embed", "embed-2"]
            await sup.wait_role_up("embed-2", after=t0, timeout_s=30)
            for i in range(20):
                await pub.publish(f"job.{i}", f"m{i}".encode())
            await wait_landed(out, {f"m{i}" for i in range(20)})
            scale_in = asyncio.create_task(sup.scale_role("embed", 1))
            for i in range(20, 40):  # traffic flows through the drain
                await pub.publish(f"job.{i}", f"m{i}".encode())
                await asyncio.sleep(0.01)
            assert (await scale_in)["drained"] == ["embed-2"]
            assert sup.replicas("embed") == ["embed"]
            assert sup.drain_events[-1][1:3] == ("embed-2", True)  # clean, no SIGKILL
            await wait_landed(out, {f"m{i}" for i in range(40)})
        finally:
            await pub.close()
            await sup.stop()
            await broker.stop()

    asyncio.run(main())
