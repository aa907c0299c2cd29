"""The port's stack alone on the CPU: its health, readiness, metrics and
trace surfaces; generation over the SSE stream on the Markov backend and
on the LM backend (a tiny synthetic llama, streamed and batched); durable
at-least-once delivery (a malformed payload quarantined in `/api/dlq`, and
its replay); a quota 429 with Retry-After; the census, device-trace and
executables routes answering with JAX's key sets, and the obs settings
that start those planes; every setting of A8 stage 2 starting its plane (the TCP bus to a broker,
the external stores behind their breakers, the fleet plane, heartbeats,
the SLO watchdog, the generation journal), backends that fail loudly
instead of falling back, and the LM's paged layout, drafter and online
fine-tune serving under a tensor-parallel mesh."""

import asyncio
import json
import tempfile
import urllib.error
import urllib.request

import pytest
import torch

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.connect import connect
from symbiont_tpu_torch.bus.inproc import InprocBus
from symbiont_tpu_torch.config import (AdmissionConfig, ApiConfig, BusConfig, EngineConfig,
                                       GraphStoreConfig, LmConfig, ObsConfig, SymbiontConfig,
                                       TextGeneratorConfig, VectorStoreConfig)
from symbiont_tpu_torch.graph.neo4j_backend import make_graph_store
from symbiont_tpu_torch.memory.qdrant_backend import make_vector_store
from symbiont_tpu_torch.parallel import build_mesh
from symbiont_tpu_torch.runner import SymbiontStack
from symbiont_tpu_torch.services.api import ApiService

PAGE = """<html><body><article><p>Matrix engines multiply quickly. Vector memory
stores every sentence!</p><p>Graphs link tokens to documents?</p></article></body></html>"""
TINY_LM = dict(enabled=True, force_cpu=True, arch="llama", hidden_size=32, num_layers=2,
               num_heads=4, intermediate_size=64, max_positions=256, dtype="float32",
               prompt_buckets=[8, 16, 64], new_token_buckets=[8, 16], temperature=0.0)


def _config(tmp_path, lm=False, **sections):
    cfg = SymbiontConfig(
        engine=EngineConfig(embedding_dim=32, length_buckets=[16, 32], batch_buckets=[2, 8],
                            max_batch=8, dtype="float32", flush_deadline_ms=2.0,
                            rerank_enabled=True, force_cpu=True),
        vector_store=VectorStoreConfig(dim=32, data_dir=str(tmp_path / "vs"),
                                       shard_capacity=64),
        graph_store=GraphStoreConfig(data_dir=str(tmp_path / "gs")),
        text_generator=TextGeneratorConfig(markov_state_path=str(tmp_path / "markov.json")),
        api=ApiConfig(host="127.0.0.1", port=0, sse_keepalive_s=0.5),
        lm=LmConfig(**TINY_LM) if lm else LmConfig())
    for name, section in sections.items():
        setattr(cfg, name, section)
    return cfg


def _http(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json", **(headers or {})}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _scenario(cfg, body):
    """Run `body(stack, http)` against a started stack, then stop it."""

    async def main():
        bus = InprocBus()
        stack = SymbiontStack(cfg, bus=bus, fetcher=lambda url: PAGE)
        await stack.start()
        loop = asyncio.get_running_loop()

        def http(*a, **kw):
            return loop.run_in_executor(None, lambda: _http(stack.api.port, *a, **kw))

        try:
            return await body(stack, http)
        finally:
            await stack.stop()
            await bus.close()

    return asyncio.run(main())


async def _until(pred, timeout=30.0):
    for _ in range(int(timeout / 0.02)):
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError("condition not reached")


async def _sse_events(port, n, out):
    """Read `n` data events from /api/events into `out`."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /api/events HTTP/1.1\r\nHost: x\r\n\r\n")
    await writer.drain()
    try:
        while len(out) < n:
            line = await reader.readline()
            if not line:
                return
            if line.startswith(b"data: "):
                out.append(json.loads(line[6:]))
    finally:
        writer.close()


def test_health_metrics_and_trace_surfaces(tmp_path):
    async def body(stack, http):
        st, _, raw = await http("POST", "/api/submit-url", {"url": "http://x/doc"})
        assert st == 200
        await _until(lambda: stack.vector_store.count() >= 3)
        # the registry is the process's: count from here
        fused0 = json.loads((await http("GET", "/api/metrics"))[2])["counters"].get(
            "api.fused_search", 0)
        st, _, raw = await http("POST", "/api/search/semantic",
                                {"query_text": "matrix", "top_k": 2, "rerank": True},
                                headers={"X-Trace-Id": "trace-surface"})
        assert st == 200 and json.loads(raw)["error_message"] is None
        assert (await http("GET", "/healthz"))[0] == 200
        st, _, raw = await http("GET", "/readyz")
        assert st == 200 and json.loads(raw)["status"] == "ready"
        st, hdr, text = await http("GET", "/metrics")
        text = text.decode()
        assert st == 200 and hdr["Content-Type"].startswith("text/plain")
        assert 'symbiont_batcher_queue_depth{batcher="embed"' in text
        assert "symbiont_engine_" in text and "# TYPE symbiont_span_duration_ms" in text
        st, hdr, om = await http("GET", "/metrics",
                                 headers={"Accept": "application/openmetrics-text"})
        assert st == 200 and om.decode().rstrip().endswith("# EOF")
        st, _, raw = await http("GET", "/api/metrics")
        snap = json.loads(raw)
        assert st == 200 and snap["counters"]["api.fused_search"] - fused0 == 1
        st, _, raw = await http("GET", "/api/traces/recent")
        assert st == 200 and json.loads(raw)["traces"]
        st, _, raw = await http("GET", "/api/traces/trace-surface")
        tree = raw.decode()
        assert st == 200
        for name in ("api.search", "engine.query.search", "engine.rerank"):
            assert f'"{name}"' in tree
        assert (await http("GET", "/api/traces/trace-surface/critical_path"))[0] == 200
        st, _, raw = await http("GET", "/api/traces/trace-surface/export?fmt=chrome")
        assert st == 200 and json.loads(raw)["traceEvents"]
        st, _, raw = await http("GET", "/api/health/engine")
        health = json.loads(raw)
        assert st == 200 and health["stats"]["embed_batches"] >= 1
        assert health["backends"] == {"embed": True, "rerank": True, "generate": False,
                                      "vector": True, "graph": True}

    _scenario(_config(tmp_path), body)


def test_readyz_is_503_until_mark_ready():
    async def main():
        bus = InprocBus()
        api = ApiService(bus, ApiConfig(host="127.0.0.1", port=0), BusConfig(),
                         defer_ready=True)
        await api.start()
        loop = asyncio.get_running_loop()
        try:
            before = await loop.run_in_executor(None, _http, api.port, "GET", "/readyz")
            live = await loop.run_in_executor(None, _http, api.port, "GET", "/healthz")
            api.mark_ready()
            after = await loop.run_in_executor(None, _http, api.port, "GET", "/readyz")
        finally:
            await api.stop()
            await bus.close()
        return before[0], live[0], after[0]

    assert asyncio.run(main()) == (503, 200, 200)


def test_markov_generation_reaches_the_sse_stream(tmp_path):
    async def body(stack, http):
        st, _, _ = await http("POST", "/api/submit-url", {"url": "http://x/doc"})
        assert st == 200
        textgen = next(s for s in stack.services if s.name == "text_generator")
        await _until(lambda: textgen.markov.chain)
        events = []
        reader = asyncio.create_task(_sse_events(stack.api.port, 1, events))
        await asyncio.sleep(0.2)
        st, _, _ = await http("POST", "/api/generate-text",
                              {"task_id": "m-1", "prompt": None, "max_length": 6})
        assert st == 200
        await asyncio.wait_for(reader, 10)
        assert events[0]["original_task_id"] == "m-1" and events[0]["generated_text"]

    _scenario(_config(tmp_path), body)


def test_lm_generation_streams_partials_and_batches(tmp_path):
    async def body(stack, http):
        assert stack.lm is not None and stack._lm_batcher is not None
        events = []
        # the stream: its partials, a done chunk, then the final message;
        # then a batched request's final message
        reader = asyncio.create_task(_sse_events(stack.api.port, 99, events))
        await asyncio.sleep(0.2)
        st, _, _ = await http("POST", "/api/generate-text",
                              {"task_id": "s-1", "prompt": "hello there", "max_length": 16,
                               "stream": True, "temperature": 0.0})
        assert st == 200
        await _until(lambda: any(e.get("original_task_id") == "s-1"
                                 and "generated_text" in e for e in events))
        st, _, _ = await http("POST", "/api/generate-text",
                              {"task_id": "b-1", "prompt": "hello there", "max_length": 16,
                               "temperature": 0.0})
        assert st == 200
        await _until(lambda: any(e.get("original_task_id") == "b-1" for e in events))
        reader.cancel()
        partials = [e for e in events if e["original_task_id"] == "s-1" and "text_delta" in e]
        final = next(e["generated_text"] for e in events
                     if e["original_task_id"] == "s-1" and "generated_text" in e)
        batched = next(e["generated_text"] for e in events if e["original_task_id"] == "b-1")
        assert len(partials) >= 2 and partials[-1]["done"]
        assert [p["seq"] for p in partials] == sorted(p["seq"] for p in partials)
        assert "".join(p["text_delta"] for p in partials) == final
        want = stack.lm.generate("hello there", 16, temperature=0.0)
        assert final == want and batched == want

    _scenario(_config(tmp_path, lm=True), body)


def test_malformed_durable_delivery_is_quarantined_and_replayed(tmp_path):
    cfg = _config(tmp_path, bus=BusConfig(durable=True, durable_ack_wait_s=0.1,
                                          durable_max_deliver=2))

    async def body(stack, http):
        await stack.bus.publish(subjects.DATA_TEXT_WITH_EMBEDDINGS, b"{not json")

        async def dlq():
            return json.loads((await http("GET", "/api/dlq"))[2])

        for _ in range(300):
            listing = await dlq()
            if listing["size"]:
                break
            await asyncio.sleep(0.05)
        assert listing["available"] and listing["size"] >= 1
        entry = listing["entries"][0]
        assert entry["subject"] == subjects.DATA_TEXT_WITH_EMBEDDINGS
        assert entry["deliveries"] == 2
        st, _, raw = await http("POST", "/api/dlq/replay", {"id": entry["id"]})
        assert st == 200 and json.loads(raw)["replayed"] == 1
        # still malformed: it fails its fresh budget and is quarantined again
        for _ in range(300):
            listing = await dlq()
            if listing["size"] and listing["entries"][0]["id"] != entry["id"]:
                break
            await asyncio.sleep(0.05)
        assert listing["size"] == 1 and listing["entries"][0]["id"] != entry["id"]
        st, _, raw = await http("POST", "/api/dlq/replay", {"id": entry["id"]})
        assert st == 404

    _scenario(cfg, body)


def test_quota_answers_429_with_retry_after(tmp_path):
    cfg = _config(tmp_path, admission=AdmissionConfig(ingest_rate=0.001, ingest_burst=1.0))

    async def body(stack, http):
        headers = {"X-Symbiont-Tenant": "burst"}
        assert (await http("POST", "/api/submit-url", {"url": "http://x/doc"},
                           headers=headers))[0] == 200
        st, hdr, raw = await http("POST", "/api/submit-url", {"url": "http://x/doc"},
                                  headers=headers)
        assert st == 429 and json.loads(raw)["reason"] == "quota"
        assert int(hdr["Retry-After"]) >= 1
        # another tenant is untouched
        assert (await http("POST", "/api/submit-url", {"url": "http://x/doc"},
                           headers={"X-Symbiont-Tenant": "calm"}))[0] == 200

    _scenario(cfg, body)


# the key sets JAX's gateway answers these routes with
# (symbiont_tpu/services/api.py `_memory_census`, `_profile_device`,
# `_engine_executables`; symbiont_tpu/obs/hbm.py `census`, `census_diff`)
CENSUS_KEYS = {"available", "arrays", "bytes_total", "group_count", "groups"}
GROUP_KEYS = {"shape", "dtype", "sharding", "count", "bytes"}
DIFF_KEYS = {"available", "bytes_delta", "array_delta", "groups"}
EXECUTABLE_KEYS = {"executable", "dispatches", "compiles", "host_wall_ms", "mean_dispatch_us",
                   "flops", "bytes_accessed", "temp_bytes", "argument_bytes", "output_bytes",
                   "generated_code_bytes", "achieved_gflops_per_s", "achieved_gbps",
                   "arithmetic_intensity", "hbm_util_vs_ref_pct"}


def test_memory_census_answers_with_jax_key_sets(tmp_path):
    """`GET /api/memory/census` with `top`, and `?diff=1` arming its
    baseline then answering the delta."""
    async def body(stack, http):
        st, _, raw = await http("GET", "/api/memory/census?top=2")
        doc = json.loads(raw)
        assert st == 200 and set(doc) == {"census"} and set(doc["census"]) == CENSUS_KEYS
        groups = doc["census"]["groups"]
        assert doc["census"]["available"] and len(groups) <= 3
        assert all(set(g) == GROUP_KEYS for g in groups)
        if doc["census"]["group_count"] > 2:
            assert groups[-1]["dtype"] == "(other)"
        st, _, raw = await http("GET", "/api/memory/census?diff=1")
        armed = json.loads(raw)
        assert st == 200 and set(armed) == {"baseline_armed", "census", "message"}
        assert set(armed["census"]) == {"available", "arrays", "bytes_total"}
        st, _, raw = await http("GET", "/api/memory/census?diff=1&top=4")
        diff = json.loads(raw)
        assert st == 200 and set(diff) == {"diff", "census"} and set(diff["diff"]) == DIFF_KEYS
        assert len(diff["diff"]["groups"]) <= 4
        st, _, _ = await http("GET", "/api/memory/census?top=x")
        assert st == 400

    _scenario(_config(tmp_path), body)


def test_profile_device_and_executables_answer_with_jax_key_sets(tmp_path):
    """`POST /api/profile/device` captures a trace (the CPU's activities
    here) whose artifact `/api/engine/executables` and the timeline's
    Chrome export name; the executables' rows are graded, and an embed
    row carries its first call's cost."""
    cfg = _config(tmp_path, obs=ObsConfig(xprof_trace_dir=str(tmp_path / "traces")))

    async def body(stack, http):
        assert (await http("POST", "/api/submit-url", {"url": "http://x/doc"}))[0] == 200
        await _until(lambda: stack.engine.stats["embed_calls"] > 0)
        st, _, raw = await http("POST", "/api/profile/device", {"duration_s": 0.1})
        res = json.loads(raw)
        assert st == 200 and set(res) == {"status", "artifact", "window_s", "hint"}
        assert res["status"] == "captured" and res["artifact"].startswith(str(tmp_path / "traces"))
        assert json.loads(open(f"{res['artifact']}/trace.json").read())["traceEvents"]
        st, _, raw = await http("POST", "/api/profile/device", {"duration_s": -1})
        assert st == 400
        st, _, raw = await http("GET", "/api/engine/executables")
        doc = json.loads(raw)
        assert st == 200 and set(doc) == {"executables", "total_dispatches",
                                          "device_trace_artifact"}
        assert doc["device_trace_artifact"] == res["artifact"]
        assert all(set(r) == EXECUTABLE_KEYS for r in doc["executables"])
        embed = [r for r in doc["executables"] if r["executable"].startswith("embed[")]
        assert embed and embed[0]["flops"] > 0 and embed[0]["bytes_accessed"] > 0
        assert embed[0]["temp_bytes"] is None  # the CPU measures no memory
        if embed[0]["dispatches"]:
            assert embed[0]["achieved_gflops_per_s"] > 0

    _scenario(cfg, body)


@pytest.mark.parametrize("fields", [dict(xprof_trace_dir="traces"), dict(xprof_trace_max_s=0.05),
                                    dict(hbm_census_groups=3)])
def test_a7_settings_start_their_plane(tmp_path, fields):
    """Each of the three obs settings the runner once refused configures
    its plane: the trace directory, the trace window's clamp, the
    census's default row bound."""
    from symbiont_tpu_torch.obs.hbm import hbm_ledger
    from symbiont_tpu_torch.obs.xprof import device_trace

    if "xprof_trace_dir" in fields:
        fields = dict(xprof_trace_dir=str(tmp_path / fields["xprof_trace_dir"]))
    cfg = _config(tmp_path, obs=ObsConfig(**fields))

    async def body(stack, http):
        if "hbm_census_groups" in fields:
            assert hbm_ledger.census_groups == 3
            st, _, raw = await http("GET", "/api/memory/census")
            census = json.loads(raw)["census"]
            assert st == 200 and len(census["groups"]) <= 4
            return
        st, _, raw = await http("POST", "/api/profile/device", {"duration_s": 0.5})
        res = json.loads(raw)
        assert st == 200 and res["status"] == "captured"
        if "xprof_trace_max_s" in fields:
            assert device_trace._max_s == 0.05  # the clamp itself: test_torch_obs.py
        else:
            assert res["artifact"].startswith(fields["xprof_trace_dir"])

    _scenario(cfg, body)


def _set(cfg, section, **fields):
    for k, v in fields.items():
        setattr(getattr(cfg, section), k, v)
    return cfg


@pytest.mark.parametrize("section,fields,item", [
    ("lm", dict(kv_layout="paged", kv_page_tokens=8), "paged"),
    ("lm", dict(spec_draft_model="/no/such/drafter"), "missing drafter"),
    ("lm", dict(ingest_train=True, ingest_train_seq_len=16, ingest_train_batch=2), "trainer"),
])
def test_unported_settings_raise_naming_their_item(tmp_path, section, fields, item):
    """The LM's paged layout, a drafter dir (missing here: plain decode,
    as on one device) and the online fine-tune serve under the serving
    mesh's 'tensor' axis: the stack on [1, 2] starts with a TP LM and
    answers a generate request with the engine's own greedy text; with
    `ingest_train` its trainer also takes one pass and syncs the engine,
    which stays TP-placed. (Each setting was once refused under TP.)"""
    from symbiont_tpu_torch.parallel import Sharded

    cfg = _set(_config(tmp_path, lm=True), section, **fields)
    cfg.parallel.mesh_shape = [1, 2]

    async def body(stack, http):
        assert stack.lm is not None and stack.lm.mesh is not None
        assert (stack.lm.pool is not None) == (item == "paged")
        assert stack.lm._draft is None
        events = []
        reader = asyncio.create_task(_sse_events(stack.api.port, 1, events))
        await asyncio.sleep(0.2)
        st, _, _ = await http("POST", "/api/generate-text",
                              {"task_id": "tp-1", "prompt": "hello there", "max_length": 8,
                               "temperature": 0.0})
        assert st == 200
        await asyncio.wait_for(reader, 30)
        assert events[0]["original_task_id"] == "tp-1"
        assert events[0]["generated_text"] == stack.lm.generate("hello there", 8,
                                                                temperature=0.0)
        textgen = next(s for s in stack.services if s.name == "text_generator")
        assert (textgen.lm_trainer is not None) == (item == "trainer")
        if textgen.lm_trainer is not None:
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: textgen.lm_trainer.train_on_texts(["a document to learn " * 4]))
            assert out["steps"] >= 1 and out["loss"] > 0
            assert textgen.lm_trainer.stats["param_syncs"] == 1
            assert isinstance(stack.lm.params["layers"][0]["q"]["kernel"], Sharded)

    _scenario(cfg, body)


def _plane_broker(stack_cfg, scheme):
    """A port broker for `bus.url`; the stack dials it itself."""
    from symbiont_tpu_torch.bus.pybroker import PyBroker

    broker = PyBroker(port=0)

    async def start():
        await broker.start()
        stack_cfg.bus.url = f"{scheme}://127.0.0.1:{broker.bound_port}"
    return broker, start


async def _plane_bus(stack):
    from symbiont_tpu_torch.bus.tcp import TcpBus

    assert isinstance(stack.bus, TcpBus)
    sub = await stack.bus.subscribe("plane.echo")
    await stack.bus.publish("plane.echo", b"over tcp")
    assert (await sub.next(5)).data == b"over tcp"


async def _plane_qdrant(stack, state):
    from symbiont_tpu_torch.memory.qdrant_backend import QdrantStore
    from symbiont_tpu_torch.resilience.stores import ResilientVectorStore

    assert isinstance(stack.vector_store, ResilientVectorStore)
    assert isinstance(stack.vector_store.inner, QdrantStore)
    await stack.bus.publish(subjects.TASKS_PERCEIVE_URL, json.dumps({"url": "u"}).encode())
    await _until(lambda: len(state["collections"].get(stack.config.vector_store.collection,
                                                      {}).get("points", {})) >= 3)


async def _plane_neo4j(stack, state):
    from symbiont_tpu_torch.graph.neo4j_backend import Neo4jGraphStore
    from symbiont_tpu_torch.resilience.stores import ResilientGraphStore

    assert isinstance(stack.graph_store, ResilientGraphStore)
    assert isinstance(stack.graph_store.inner, Neo4jGraphStore)
    await stack.bus.publish(subjects.TASKS_PERCEIVE_URL, json.dumps({"url": "u"}).encode())
    await _until(lambda: any("HAS_SENTENCE" in st for st, _ in state["statements"]))


async def _plane_fleet(stack):
    assert stack.fleet_exporter is not None and stack.fleet is not None
    assert stack.api.fleet is stack.fleet and stack._drain_sub is not None
    await stack.fleet_exporter.publish_once()
    await _until(lambda: "gateway" in stack.fleet.rollup()["roles"])


async def _plane_heartbeats(stack):
    role = stack._hb_role
    sub = await stack.bus.subscribe(f"{subjects.SYS_HEARTBEAT}.{role}")
    beat = json.loads((await sub.next(10)).data)
    assert beat["role"] == role and beat["capacity"] == 1 and beat["draining"] is False


async def _plane_watchdog(stack):
    from symbiont_tpu_torch.obs.watchdog import SloWatchdog

    assert isinstance(stack.watchdog, SloWatchdog)
    assert stack.watchdog.thresholds == {"api.search": 500.0}
    assert stack.api.ladder is not None  # breach passes drive its rungs
    assert stack.api.ladder.on_slo_pass in stack.watchdog.listeners


async def _plane_journal(stack, tmp_path):
    from symbiont_tpu_torch.resilience.genlog import GenJournal
    from symbiont_tpu_torch.services.text_generator import TextGeneratorService

    assert isinstance(stack.lm.journal, GenJournal)
    assert stack.lm.journal.path == tmp_path / "genlog" / "local.genlog"
    [svc] = [s for s in stack.services if isinstance(s, TextGeneratorService)]
    assert svc.journal is stack.lm.journal and svc.lm_resume == stack.lm.generate_stream


@pytest.mark.parametrize("plane", ["symbus", "nats", "qdrant", "neo4j", "role", "heartbeat",
                                   "slo", "journal"])
def test_stage2_settings_start_their_planes(tmp_path, plane):
    """Each setting that the port refused before A8 stage 2 now starts its
    plane: the TCP bus to a broker (`symbus://`, `nats://`), the external
    stores behind their breakers (stub servers), the fleet plane and drain
    subscription of a named role, heartbeats, the SLO watchdog wired to the
    shedding ladder, and the generation journal handed to the service."""
    from http.server import ThreadingHTTPServer
    import threading

    from tests.test_neo4j_backend import _FakeNeo4j
    from tests.test_qdrant_backend import _FakeQdrant

    cfg = _config(tmp_path, lm=plane == "journal")
    broker = server = None
    checks = {"role": _plane_fleet, "heartbeat": _plane_heartbeats, "slo": _plane_watchdog,
              "journal": lambda st: _plane_journal(st, tmp_path)}
    if plane in ("symbus", "nats"):
        broker, start_broker = _plane_broker(cfg, plane)
        checks[plane] = _plane_bus
    elif plane in ("qdrant", "neo4j"):
        handler, attr = ((_FakeQdrant, "fake_store") if plane == "qdrant"
                         else (_FakeNeo4j, "state"))
        state = ({"collections": {}} if plane == "qdrant"
                 else {"statements": [], "auth": [], "paths": []})
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        setattr(server, attr, state)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        uri = f"http://127.0.0.1:{server.server_address[1]}"
        cfg.resilience.spill_dir = str(tmp_path / "spill")
        if plane == "qdrant":
            _set(cfg, "vector_store", uri=uri)
            checks[plane] = lambda st: _plane_qdrant(st, state)
        else:
            _set(cfg, "graph_store", uri=uri)
            checks[plane] = lambda st: _plane_neo4j(st, state)
    else:
        section, fields = {"role": ("runner", dict(role="gateway")),
                           "heartbeat": ("runner", dict(heartbeat_s=0.1)),
                           "slo": ("obs", dict(slo_p99_ms=["api.search=500"])),
                           "journal": ("gen_journal", dict(enabled=True,
                                                           dir=str(tmp_path / "genlog")))}[plane]
        _set(cfg, section, **fields)
        if plane == "slo":
            cfg.admission = AdmissionConfig(enabled=True)

    async def main():
        if broker is not None:
            await start_broker()
        bus = None if broker is not None else InprocBus()
        stack = SymbiontStack(cfg, bus=bus, fetcher=lambda url: PAGE)
        try:
            await stack.start()
            await checks[plane](stack)
        finally:
            await stack.stop()
            if bus is not None:
                await bus.close()
            if broker is not None:
                await broker.stop()

    try:
        asyncio.run(main())
    finally:
        if server is not None:
            server.shutdown()


@pytest.mark.parametrize("explicit", [False, True])
def test_postmortems_go_under_the_temp_dir_unless_a_dir_is_set(tmp_path, monkeypatch,
                                                               explicit):
    """JAX's default postmortem dir is a fixed /tmp path; the port's stack
    resolves it under the process's temp dir, and takes a set dir as is."""
    from symbiont_tpu_torch.obs.hbm import oom_forensics

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmpdir"))
    cfg = _config(tmp_path)
    if explicit:
        cfg.obs = ObsConfig(hbm_postmortem_dir=str(tmp_path / "pm"))

    async def body(stack, http):
        return oom_forensics._dir

    want = tmp_path / "pm" if explicit else tmp_path / "tmpdir" / "symbiont_hbm"
    assert _scenario(cfg, body) == str(want)


def test_a_mesh_argument_raises_naming_a15(tmp_path):
    """A caller's mesh reaches the engines: with a 'tensor' axis the LM's
    paged layout (once refused there, naming A15) serves on it, its page
    pool one set of arrays a tensor shard, and the LM answers a request
    with its own greedy text."""
    cfg = _config(tmp_path, lm=True)
    cfg.lm.kv_layout, cfg.lm.kv_page_tokens = "paged", 8
    mesh = build_mesh([1, 2], devices=[torch.device("cpu")] * 2)

    async def main():
        stack = SymbiontStack(cfg, bus=InprocBus(), mesh=mesh, fetcher=lambda url: PAGE)
        await stack.start()
        try:
            assert stack.lm.mesh is mesh and len(stack.lm.pool.shards) == 2
            assert stack._lm_batcher is not None
            return await asyncio.get_running_loop().run_in_executor(
                None, lambda: stack.lm.generate_batch(["hello"], [8]))
        finally:
            await stack.stop()

    got = asyncio.run(main())
    assert isinstance(got, list) and len(got) == 1 and got[0]


@pytest.mark.parametrize("call,error,match", [
    (lambda: asyncio.run(connect("symbus://127.0.0.1:1", retries=2, retry_delay_s=0.01)),
     ConnectionError, "unreachable"),
    (lambda: make_vector_store(VectorStoreConfig(uri="grpc://q:6334")), ValueError,
     "REST endpoint"),
    (lambda: make_graph_store(GraphStoreConfig(uri="bolt://n:7687")), ValueError, "bolt"),
])
def test_backends_fail_loudly_and_never_fall_back(call, error, match):
    """An unreachable broker fails after its retries instead of switching
    to the in-process bus; an external store URL the backend cannot speak
    fails at once instead of leaving the embedded store in its place."""
    with pytest.raises(error, match=match):
        call()


def test_the_default_stack_needs_cuda_and_never_falls_back(tmp_path):
    """Without CUDA the default engine raises; nothing runs on the CPU
    behind the caller's back."""
    cfg = _config(tmp_path)
    cfg.engine = EngineConfig(embedding_dim=32)

    async def main():
        bus = InprocBus()
        stack = SymbiontStack(cfg, bus=bus)
        try:
            with pytest.raises(RuntimeError, match="CUDA"):
                await stack.start()
            assert stack.engine is None
        finally:
            await stack.stop()
            await bus.close()

    asyncio.run(main())
