"""The port's elastic autoscaler (`resilience/autoscale.py`) and the drain
protocol, case for case with the JAX package's: role bounds parsing, the
ops budget's sliding window, scale-out dwell and bounds, scale-in after
consecutive clean passes and its dwell, no flapping under an oscillating
signal, a spent budget and a down broker blocking the pass, heartbeat
payloads of every shape; a drained service detaching its durable consumer
so new work goes to the survivor; and the runner stack draining end to
end on a `_sys.drain.<role>` message (the coalescer flushed, a final
`draining: true` heartbeat, /readyz 503, `drained` set). Every case runs on
both packages (`pkg`)."""

import asyncio
import json
import time
import types

import numpy as np
import pytest

import symbiont_tpu.bus.inproc as jinproc
import symbiont_tpu.config as jconfig
import symbiont_tpu.resilience.autoscale as jautoscale
import symbiont_tpu.resilience.procsup as jprocsup
import symbiont_tpu.runner as jrunner
import symbiont_tpu.services.base as jbase
import symbiont_tpu.subjects as jsubjects
import symbiont_tpu.utils.telemetry as jtelemetry
import symbiont_tpu_torch.bus.inproc as tinproc
import symbiont_tpu_torch.config as tconfig
import symbiont_tpu_torch.resilience.autoscale as tautoscale
import symbiont_tpu_torch.resilience.procsup as tprocsup
import symbiont_tpu_torch.runner as trunner
import symbiont_tpu_torch.services.base as tbase
import symbiont_tpu_torch.subjects as tsubjects
import symbiont_tpu_torch.utils.telemetry as ttelemetry

PACKAGES = {
    "jax": types.SimpleNamespace(inproc=jinproc, config=jconfig, autoscale=jautoscale,
                                 procsup=jprocsup, runner=jrunner, base=jbase,
                                 subjects=jsubjects, metrics=jtelemetry.metrics),
    "port": types.SimpleNamespace(inproc=tinproc, config=tconfig, autoscale=tautoscale,
                                  procsup=tprocsup, runner=trunner, base=tbase,
                                  subjects=tsubjects, metrics=ttelemetry.metrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# -------------------------------------------------------------- the policy


def test_parse_role_bounds(pkg):
    parse = pkg.autoscale.parse_role_bounds
    assert parse("") == {}
    out = parse("embed=1:4, decode=2:2")
    assert (out["embed"].min, out["embed"].max, out["decode"].min, out["decode"].max) == \
        (1, 4, 2, 2)
    for bad in ("embed", "embed=4", "embed=0:4", "embed=3:2", "embed=a:b"):
        with pytest.raises(ValueError):
            parse(bad)
    with pytest.raises(ValueError):
        pkg.config.AutoscaleConfig(roles="embed=0:3")
    with pytest.raises(ValueError):
        pkg.config.AutoscaleConfig(queue_high=4.0, queue_low=8.0)


def test_ops_budget_sliding_window(pkg):
    t = [0.0]
    b = pkg.autoscale.OpsBudget(2, 10.0, clock=lambda: t[0])
    assert b.try_take() and b.try_take() and not b.try_take() and b.remaining() == 0
    t[0] = 10.5
    assert b.try_take() and b.try_take() and not b.try_take()


class _FakeWorker:
    draining = False


class _FakeSup:
    """Records scale_role calls, with the real one's replica names."""

    _broker_healthy = True

    def __init__(self, n=1):
        self.calls = []
        self.n = {"embed": n}
        self.drain_deadline_s = 30.0
        self._sync()

    def _sync(self):
        self.workers = {(r if i == 0 else f"{r}-{i + 1}"): _FakeWorker()
                        for r, k in self.n.items() for i in range(k)}

    def replicas(self, role):
        return [n for n in self.workers if n == role or n.startswith(role + "-")]

    async def scale_role(self, role, n):
        self.calls.append((role, n))
        self.n[role] = n
        self._sync()


def _policy(pkg, sup, sig, t, **over):
    kw = dict(enabled=True, roles="embed=1:3", eval_s=0.1, queue_high=10.0, queue_low=1.0,
              out_dwell_s=1.0, in_dwell_s=2.0, in_clean_passes=2, budget_ops=4,
              budget_window_s=60.0, drain_deadline_s=5.0)
    kw.update(over)
    return pkg.autoscale.Autoscaler(sup, pkg.config.AutoscaleConfig(**kw),
                                    signals=lambda b: sig, clock=lambda: t[0])


def _sig(pkg, depth):
    return {"embed": pkg.autoscale.RoleSignals(queue_depth=depth)}


def test_scale_out_respects_dwell_and_bounds(pkg):
    t, sup = [0.0], _FakeSup()
    a = _policy(pkg, sup, _sig(pkg, 50.0), t)

    async def main():
        await a.evaluate_once()
        assert sup.calls == [("embed", 2)]
        t[0] += 0.5
        await a.evaluate_once()  # inside the dwell
        assert sup.calls == [("embed", 2)]
        t[0] += 1.0
        await a.evaluate_once()
        assert sup.calls[-1] == ("embed", 3)
        t[0] += 2.0
        await a.evaluate_once()  # at the max
        assert sup.calls[-1] == ("embed", 3) and a.flaps() == 0

    asyncio.run(main())


def test_scale_in_needs_clean_passes_and_dwell(pkg):
    t, sup = [0.0], _FakeSup(n=3)
    sig = _sig(pkg, 0.5)
    a = _policy(pkg, sup, sig, t)

    async def main():
        t[0] += 10.0
        await a.evaluate_once()
        assert sup.calls == []
        sig.update(_sig(pkg, 5.0))  # a dead-band pass resets the streak
        await a.evaluate_once()
        sig.update(_sig(pkg, 0.5))
        await a.evaluate_once()
        assert sup.calls == []
        await a.evaluate_once()
        assert sup.calls == [("embed", 2)]

    asyncio.run(main())


def test_oscillating_signal_never_flaps(pkg):
    t, sup = [0.0], _FakeSup()
    sig = _sig(pkg, 50.0)
    a = _policy(pkg, sup, sig, t)

    async def main():
        for i in range(40):
            sig.update(_sig(pkg, 50.0 if i % 2 == 0 else 0.0))
            await a.evaluate_once()
            t[0] += 0.3
        assert all(d == "out" for _, _, d, _ in a.decisions) and a.flaps() == 0

    asyncio.run(main())


@pytest.mark.parametrize("block", ["budget", "broker"])
def test_a_spent_budget_or_a_down_broker_blocks_scaling(pkg, block):
    t, sup = [0.0], _FakeSup()
    a = _policy(pkg, sup, _sig(pkg, 50.0), t, budget_ops=1)

    async def main():
        if block == "broker":
            sup._broker_healthy = False
            await a.evaluate_once()
            assert sup.calls == []
            return
        await a.evaluate_once()
        t[0] += 5.0
        await a.evaluate_once()
        assert sup.calls == [("embed", 2)]

    asyncio.run(main())


def test_heartbeat_payloads_of_every_shape(pkg):
    w = pkg.procsup._Worker(pkg.procsup.WorkerSpec(role="r", argv=["true"]))
    note = pkg.procsup.ProcessSupervisor._note_heartbeat_payload
    for raw in (b"", b"not json", json.dumps({"role": "r", "pid": 1}).encode()):
        note(w, raw)
        assert not w.reported_draining and w.reported_capacity == 1.0
    note(w, json.dumps({"role": "r", "pid": 1, "capacity": 0, "draining": True}).encode())
    assert w.reported_draining and w.reported_capacity == 0.0


# --------------------------------------------------------- the drain protocol


def test_drained_consumer_detaches_and_the_survivor_takes_new_work(pkg):
    class Consumer(pkg.base.Service):
        name = "toy"

        def __init__(self, bus, seen):
            super().__init__(bus)
            self.seen = seen

        async def _setup(self):
            await self._subscribe_loop("job.*", self._handle, queue="g", durable_stream="s")

        async def _handle(self, msg):
            self.seen.append(bytes(msg.data))

    async def wait(pred):
        deadline = time.monotonic() + 10
        while not pred() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)

    async def main():
        bus = pkg.inproc.InprocBus()
        await bus.add_stream("s", ["job.>"], ack_wait_s=0.2, max_deliver=10)
        seen_a, seen_b = [], []
        a, b = Consumer(bus, seen_a), Consumer(bus, seen_b)
        await a.start()
        await b.start()
        for i in range(6):
            await bus.publish(f"job.{i}", f"m{i}".encode())
        await wait(lambda: len(seen_a) + len(seen_b) >= 6)
        await a.drain()
        frozen = len(seen_a)
        for i in range(6, 16):
            await bus.publish(f"job.{i}", f"m{i}".encode())
        await wait(lambda: len(seen_b) >= 16 - frozen)
        assert len(seen_a) == frozen
        assert sorted(seen_a + seen_b) == sorted(f"m{i}".encode() for i in range(16))
        await b.stop()
        await a.stop()
        await bus.close()

    asyncio.run(main())


class _ModelCfg:
    hidden_size = 16


class _StubEngine:
    """What the stack reads of an embed engine: 16-wide zero vectors."""

    device = "cpu"

    def __init__(self, config):
        self.config = config.EngineConfig(embedding_dim=16, max_batch=16,
                                          flush_deadline_ms=2.0)
        self.model_cfg = _ModelCfg()
        self.cross_params = None
        self.stats = {"embed_calls": 0, "compiles": 0}

    def embed_texts(self, texts):
        return np.zeros((len(texts), 16), np.float32)


def test_runner_stack_drains_end_to_end(pkg, tmp_path):
    c = pkg.config

    async def main():
        cfg = c.SymbiontConfig(
            vector_store=c.VectorStoreConfig(dim=16, data_dir=str(tmp_path / "vs"),
                                             coalesce_max_age_ms=60_000.0),
            graph_store=c.GraphStoreConfig(data_dir=str(tmp_path / "gs")),
            text_generator=c.TextGeneratorConfig(markov_state_path=None),
            api=c.ApiConfig(host="127.0.0.1", port=0))
        cfg.runner.services = "perception,preprocessing,vector_memory,api"
        cfg.runner.role = "worker"
        cfg.runner.heartbeat_s = 0.1
        cfg.bus.durable = True
        bus = pkg.inproc.InprocBus()
        beats = []
        sub = await bus.subscribe(pkg.subjects.SYS_HEARTBEAT + ".>")

        async def collect():
            async for m in sub:
                beats.append(json.loads(m.data))

        collector = asyncio.create_task(collect())
        stack = pkg.runner.SymbiontStack(cfg, bus=bus, engine=_StubEngine(c),
                                         fetcher=lambda url: "<html><p>one sentence.</p></html>")
        await stack.start()
        try:
            deadline = time.monotonic() + 10
            while not beats and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert beats[0]["capacity"] == 1 and beats[0]["draining"] is False
            assert stack.fleet_exporter is not None and stack.fleet is not None
            key = dict(labels={"service": "vector_memory"})
            base = pkg.metrics.get("coalesce.messages", **key)
            await bus.publish(pkg.subjects.TASKS_PERCEIVE_URL,
                              json.dumps({"url": "http://x/1"}).encode())
            deadline = time.monotonic() + 10
            while (pkg.metrics.get("coalesce.messages", **key) <= base
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.02)
            assert stack.vector_store.count() == 0  # parked in the 60 s window
            await bus.publish(f"{pkg.subjects.SYS_DRAIN}.worker", b"{}")
            await asyncio.wait_for(stack.drained.wait(), 10)
            assert stack.vector_store.count() == 1  # the drain flushed it
            final = [b for b in beats if b.get("draining")]
            assert final and final[-1]["capacity"] == 0
            assert stack.api._ready is False
        finally:
            await stack.stop()
            await bus.close()
            collector.cancel()

    asyncio.run(main())
