"""The port's `GenBatcher` (engine/batcher.py) on the CPU, at tiny
geometries: concurrent requests share one session and equal their
standalone text and the JAX batcher's; mixed sampling shares one decode;
a request that arrives mid-decode joins at a chunk boundary with its
standalone text; a session that cannot start fails every future; a
rejected newcomer goes back to the queue and wakes the run loop; an
admission prefill overlaps the running chunks; a cancelled request frees
its row; the tenant lanes and the stride clock drain as JAX's do."""

import asyncio
import threading
import time
from types import SimpleNamespace

import pytest

from symbiont_tpu.engine.batcher import GenBatcher as JaxGenBatcher
from symbiont_tpu.engine.batcher import TenantLanes as JaxTenantLanes
from symbiont_tpu.resilience.admission import StrideClock as JaxStrideClock
from symbiont_tpu_torch.engine import batcher as batcher_mod
from symbiont_tpu_torch.engine import lm as lm_mod
from symbiont_tpu_torch.engine.batcher import GenBatcher, TenantLanes, _PendingGen
from symbiont_tpu_torch.resilience.admission import AdmissionReject, StrideClock
from tests.test_torch_lm import _pair, _port

GEN = dict(stream_chunk=4, new_token_buckets=[8, 32], prompt_buckets=[8],
           gen_max_batch=4, gen_flush_deadline_ms=50.0)


async def _gather(batcher_cls, eng, calls, **kw):
    b = batcher_cls(eng, **kw)
    await b.start()
    try:
        return await asyncio.gather(*[b.generate(*a, **k) for a, k in calls]), b.stats
    finally:
        await b.close()


@pytest.mark.parametrize("arch,nkv", [("llama", 2), ("gpt2", None)])
def test_concurrent_requests_share_one_session_and_match_jax(arch, nkv):
    jax_eng, port = _pair(arch, nkv, **GEN)
    calls = [(("aa", 6), {}), (("bb", 6), {}), (("cc", 8), {})]
    singles = [port.generate(*a) for a, _ in calls]
    got, stats = asyncio.run(_gather(GenBatcher, port, calls))
    assert got == singles and stats["sessions"] == 1 == port.stats["sessions"]
    want, _ = asyncio.run(_gather(JaxGenBatcher, jax_eng, calls))
    assert got == want


def test_mixed_sampling_shares_one_decode():
    port = _port(**GEN, top_k=40)
    greedy = port.generate("aa", 6)
    calls = [(("aa", 6), {}), (("aa", 6), dict(temperature=0.0)),
             (("aa", 6), dict(temperature=5.0, top_k=0))]
    (default, explicit, sampled), stats = asyncio.run(_gather(GenBatcher, port, calls))
    assert default == explicit == greedy and isinstance(sampled, str)
    assert stats["sessions"] == 1


def test_request_arriving_midflight_joins_at_a_chunk_boundary(monkeypatch):
    port = _port(**dict(GEN, gen_flush_deadline_ms=5.0))
    solo_a, solo_b = port.generate("aa", 24), port.generate("bb", 8)
    gate = threading.Event()
    step = lm_mod.BatchSession.step

    def gated_step(self):
        assert gate.wait(20), "the test's gate never opened"
        return step(self)

    monkeypatch.setattr(lm_mod.BatchSession, "step", gated_step)

    async def scenario():
        b = GenBatcher(port)
        await b.start()
        try:
            t1 = asyncio.ensure_future(b.generate("aa", 24))
            await asyncio.sleep(0.1)  # t1's session has started, its first step waits
            t2 = asyncio.ensure_future(b.generate("bb", 8))
            await asyncio.sleep(0)
            gate.set()
            return await asyncio.gather(t1, t2), b.stats
        finally:
            await b.close()

    (ra, rb), stats = asyncio.run(scenario())
    assert (ra, rb) == (solo_a, solo_b)
    assert stats["admitted_midflight"] == 1 and stats["sessions"] == 1
    assert port.stats["admitted"] == 1


def test_a_session_that_cannot_start_fails_every_future():
    port = _port(**dict(GEN, gen_flush_deadline_ms=5.0, max_positions=8))

    async def scenario():
        b = GenBatcher(port)
        await b.start()
        try:
            futs = [b.generate("hi", 16), b.generate("yo", 16)]
            return await asyncio.wait_for(asyncio.gather(*futs, return_exceptions=True), 15)
        finally:
            await b.close()

    results = asyncio.run(scenario())
    assert all(isinstance(r, ValueError) for r in results), results


def test_requeue_wakes_the_run_loop():
    """A session takes the queue and puts back a newcomer it cannot admit:
    the put-back must wake a run loop parked on the cleared event."""

    class FakeSess:
        rows = [SimpleNamespace(tag=0)]

        def __init__(self):
            self.steps_left = 2

        def capacity(self):
            return 1

        def can_admit(self, prompt, max_new, lookahead_chunks=0):
            return False  # the newcomer's budget never fits

        def prefill_warm(self, k):
            return True

        def remaining_steps(self):
            return self.steps_left

        def round_slots(self):
            return 1

        def step(self):
            self.steps_left -= 1
            return [(0, "first done")] if self.steps_left == 0 else []

        def done(self):
            return self.steps_left <= 0

        def close(self):
            self.closed = True

    class FakeLm:
        config = SimpleNamespace(gen_max_batch=8, gen_flush_deadline_ms=1.0,
                                 new_token_buckets=[16], temperature=1.0, top_k=0)

        def start_session(self, prompts, max_new, temperature, top_k, tenants=None,
                          task_ids=None):
            return FakeSess()

    async def scenario():
        loop = asyncio.get_running_loop()
        b = GenBatcher(FakeLm())  # _run not started: _flush is driven by hand
        first = _PendingGen("a", 16, 1.0, 0, loop.create_future())
        b._submit(first)
        batch = b._take_chunk()
        late = _PendingGen("b", 16, 1.0, 0, loop.create_future())
        b._submit(late)
        b._wake.clear()  # the run loop consumed the wake and parked
        await b._flush(batch)
        assert first.future.result() == "first done"
        assert list(b._queue) == [late]  # the refused newcomer is queued again...
        assert b._wake.is_set()  # ...and the run loop is woken

    asyncio.run(scenario())


def test_admission_prefill_overlaps_the_running_chunks(monkeypatch):
    """The newcomer's prefill runs on an executor thread without the
    engine lock: chunks keep coming while it is slowed down."""
    port = _port(**dict(GEN, gen_flush_deadline_ms=5.0, new_token_buckets=[8, 64]))
    solo_a, solo_b = port.generate("aa", 64), port.generate("bb", 8)
    steps, window = [], {}
    step, prepare = lm_mod.BatchSession.step, lm_mod.BatchSession.prepare_admit

    def paced_step(self):
        time.sleep(0.05)  # the session outlasts the slowed prepare
        out = step(self)
        steps.append(time.perf_counter())
        return out

    def slow_prepare(self, *a, **kw):
        window["start"] = time.perf_counter()
        time.sleep(0.4)
        out = prepare(self, *a, **kw)
        window["end"] = time.perf_counter()
        return out

    monkeypatch.setattr(lm_mod.BatchSession, "step", paced_step)
    monkeypatch.setattr(lm_mod.BatchSession, "prepare_admit", slow_prepare)

    async def scenario():
        b = GenBatcher(port)
        await b.start()
        try:
            t1 = asyncio.ensure_future(b.generate("aa", 64))
            await asyncio.sleep(0.1)
            t2 = asyncio.ensure_future(b.generate("bb", 8))
            return await asyncio.gather(t1, t2), b.stats
        finally:
            await b.close()

    (ra, rb), stats = asyncio.run(scenario())
    assert (ra, rb) == (solo_a, solo_b) and stats["admitted_midflight"] == 1
    during = [t for t in steps if window["start"] < t < window["end"]]
    assert len(during) >= 2, f"{len(during)} chunks ran during a 0.4 s admission prefill"


def test_cancelled_request_frees_its_row(monkeypatch):
    port = _port(**dict(GEN, gen_flush_deadline_ms=5.0))
    solo = port.generate("bb", 24)
    gate = threading.Event()
    step = lm_mod.BatchSession.step
    monkeypatch.setattr(lm_mod.BatchSession, "step",
                        lambda self: gate.wait(20) and step(self))

    async def scenario():
        b = GenBatcher(port)
        await b.start()
        try:
            cancel = asyncio.Event()
            t1 = asyncio.ensure_future(b.generate("aa", 32, cancel=cancel))
            t2 = asyncio.ensure_future(b.generate("bb", 24))
            await asyncio.sleep(0.1)  # one session for both, its first step waits
            cancel.set()
            gate.set()
            return await asyncio.gather(t1, t2), b.stats
        finally:
            await b.close()

    (ra, rb), stats = asyncio.run(scenario())
    assert ra is None and rb == solo and stats["cancelled"] == 1 and stats["sessions"] == 1
    assert port.stats["cancelled"] == 1 and port.kv_row_counts() == (0, 0)


# ------------------------------------------------------------- fairness


def _item(tenant, i):
    return SimpleNamespace(tenant=tenant, i=i)


def test_tenant_lanes_drain_as_jax_does(monkeypatch):
    monkeypatch.setattr(batcher_mod, "MAX_TENANT_LANES", 3)
    mine, theirs = TenantLanes(), JaxTenantLanes(max_lanes=3)
    items = ([_item("hot", i) for i in range(6)] + [_item("cold", i) for i in range(2)]
             + [_item(None, 0), _item("new-1", 0), _item("new-2", 0)])
    for lanes in (mine, theirs):
        for it in items:
            lanes.append(it)
    order = [(it.tenant, it.i) for it in mine]
    assert order == [(it.tenant, it.i) for it in theirs]
    assert sorted(order, key=str) == sorted(((it.tenant, it.i) for it in items), key=str)
    assert set(mine._lanes) == {"hot", "cold", "default", "(overflow)"}
    drained = []
    for lanes in (mine, theirs):  # taken, put back at the fronts, drained
        lanes.requeue_front([lanes.popleft() for _ in range(3)])
        drained.append([(it.tenant, it.i) for it in lanes.drain_fair()])
    assert drained[0] == drained[1] and sorted(drained[0], key=str) == sorted(order, key=str)
    assert len(mine) == 0 and not mine and mine.peek() is None


def test_full_lane_rejects():
    lanes = TenantLanes(max_per_tenant=2)
    lanes.append(_item("a", 0))
    lanes.append(_item("a", 1))
    with pytest.raises(AdmissionReject) as e:
        lanes.append(_item("a", 2))
    assert e.value.reason == "engine_lane_full" and e.value.retry_after_s == 1.0
    lanes.append(_item("b", 0))  # another tenant's lane has room
    assert len(lanes) == 3


def test_stride_clock_matches_jax():
    weights = {"gold": 4.0, "free": 1.0}
    mine, theirs = StrideClock(weights), JaxStrideClock(weights)
    picks = []
    for clock in (mine, theirs):
        seq = []
        for _ in range(12):
            t = clock.pick(["gold", "free", "idle"][: 2 + (len(seq) > 6)])
            clock.charge(t)
            seq.append(t)
        clock.forget("idle")
        picks.append((seq, clock.effective("gold"), clock.effective("free")))
    assert picks[0] == picks[1]
    assert picks[0][0].count("gold") > 2 * picks[0][0].count("free")
