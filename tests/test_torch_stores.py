"""The port's external stores and their resilience wrappers, case for case
with the JAX package's: the circuit breaker (`resilience/breaker.py`:
open, half-open probe, recovery, a failed probe reopening, fatal errors
bypassing the count), the spill wrappers (`resilience/stores.py`: a vector
outage spilled and replayed in order, the spill surviving a restart, the
open breaker's read fallback, config errors never spilled, the graph
document spill), the Qdrant REST backend (`memory/qdrant_backend.py`)
and the Neo4j HTTP backend (`graph/neo4j_backend.py`) against the
in-process stub servers of tests/test_qdrant_backend.py and
tests/test_neo4j_backend.py, and the factories that pick them from
`vector_store.uri` / `graph_store.uri`, wrapped when breakers are on. Every
case runs on both packages (`pkg`); the Neo4j statements and the Qdrant
hits of the two packages are the same."""

import threading
import types
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import symbiont_tpu.config as jconfig
import symbiont_tpu.graph.neo4j_backend as jneo4j
import symbiont_tpu.graph.store as jgraph_store
import symbiont_tpu.memory.qdrant_backend as jqdrant
import symbiont_tpu.resilience.breaker as jbreaker
import symbiont_tpu.resilience.stores as jstores
import symbiont_tpu.schema as jschema
import symbiont_tpu_torch.config as tconfig
import symbiont_tpu_torch.graph.neo4j_backend as tneo4j
import symbiont_tpu_torch.graph.store as tgraph_store
import symbiont_tpu_torch.memory.qdrant_backend as tqdrant
import symbiont_tpu_torch.resilience.breaker as tbreaker
import symbiont_tpu_torch.resilience.stores as tstores
import symbiont_tpu_torch.schema as tschema
from symbiont_tpu_torch.graph.neo4j_backend import make_graph_store
from symbiont_tpu_torch.memory.qdrant_backend import make_vector_store
from symbiont_tpu_torch.memory.vector_store import VectorStore
from tests.test_neo4j_backend import _FakeNeo4j
from tests.test_qdrant_backend import _FakeQdrant

PACKAGES = {
    "jax": types.SimpleNamespace(config=jconfig, neo4j=jneo4j, graph_store=jgraph_store,
                                 qdrant=jqdrant, breaker=jbreaker, stores=jstores,
                                 schema=jschema),
    "port": types.SimpleNamespace(config=tconfig, neo4j=tneo4j, graph_store=tgraph_store,
                                  qdrant=tqdrant, breaker=tbreaker, stores=tstores,
                                  schema=tschema),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _serve(handler, state_attr, state):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    setattr(srv, state_attr, state)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def fake_qdrant():
    srv, uri = _serve(_FakeQdrant, "fake_store", {"collections": {}})
    yield uri, srv.fake_store
    srv.shutdown()


@pytest.fixture()
def fake_neo4j():
    srv, uri = _serve(_FakeNeo4j, "state", {"statements": [], "auth": [], "paths": []})
    yield uri, srv.state
    srv.shutdown()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _boom(exc=RuntimeError):
    def f():
        raise exc("down")
    return f


# ---------------------------------------------------------------- breaker


def test_breaker_opens_half_opens_and_recovers(pkg):
    clock = _Clock()
    br = pkg.breaker.CircuitBreaker("t", failure_threshold=3, reset_timeout_s=10.0, clock=clock)
    for _ in range(3):
        with pytest.raises(RuntimeError):
            br.call(_boom())
    assert br.state == "open"
    with pytest.raises(pkg.breaker.CircuitOpenError):  # refused fast
        br.call(lambda: "never runs")
    assert issubclass(pkg.breaker.CircuitOpenError, ConnectionError)
    clock.t = 9.9
    assert not br.allow()
    clock.t = 10.1
    assert br.state == "half_open" and br.allow()
    assert not br.allow()  # one probe at a time
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_failed_probe_reopens(pkg):
    clock = _Clock()
    br = pkg.breaker.CircuitBreaker("t2", failure_threshold=1, reset_timeout_s=5.0, clock=clock)
    with pytest.raises(RuntimeError):
        br.call(_boom())
    clock.t = 6.0
    with pytest.raises(RuntimeError):
        br.call(_boom())
    assert br.state == "open"
    assert br.retry_in_s() == pytest.approx(5.0, abs=0.01)


def test_breaker_fatal_errors_bypass_the_count(pkg):
    br = pkg.breaker.CircuitBreaker("t3", failure_threshold=1)
    with pytest.raises(ValueError):
        br.call(_boom(ValueError), fatal=(ValueError,))
    assert br.state == "closed"


# ------------------------------------------------------------ the wrappers


class _FlakyVectorStore:
    """Fails the first `fail_n` upserts, then recovers."""

    supports_fused = False

    def __init__(self, fail_n=0):
        self.fail_n = fail_n
        self.calls = 0
        self.points = {}

    def ensure_collection(self, dim=None):
        pass

    def upsert(self, points):
        self.calls += 1
        if self.calls <= self.fail_n:
            raise ConnectionError("backend down")
        for pid, vec, payload in points:
            self.points[pid] = (vec, payload)
        return len(points)

    def search(self, query, top_k):
        return []

    def count(self):
        return len(self.points)


def test_vector_outage_spills_and_replays_in_order(pkg, tmp_path):
    inner = _FlakyVectorStore(fail_n=2)
    spill = tmp_path / "spill.jsonl"
    store = pkg.stores.ResilientVectorStore(
        inner, breaker=pkg.breaker.CircuitBreaker("v", failure_threshold=10,
                                                  reset_timeout_s=0.01),
        spill_path=str(spill))
    assert store.upsert([("a", [1.0], {"k": 1})]) == 1
    assert store.upsert([("b", [2.0], {"k": 2})]) == 1
    assert inner.count() == 0 and store.spill_pending() == 2 and spill.exists()
    assert store.upsert([("c", [3.0], {"k": 3})]) == 1  # replays the spill first
    assert list(inner.points) == ["a", "b", "c"] and store.spill_pending() == 0
    assert not spill.exists()


def test_vector_spill_survives_a_restart(pkg, tmp_path):
    spill = tmp_path / "spill.jsonl"
    down = pkg.stores.ResilientVectorStore(
        _FlakyVectorStore(fail_n=99),
        breaker=pkg.breaker.CircuitBreaker("vp", failure_threshold=1, reset_timeout_s=30.0),
        spill_path=str(spill))
    down.upsert([("a", [1.0], {})])
    healthy = _FlakyVectorStore()
    revived = pkg.stores.ResilientVectorStore(healthy, breaker=pkg.breaker.CircuitBreaker("vp2"),
                                              spill_path=str(spill))
    assert revived.spill_pending() == 1 and revived.replay_spill() == 1
    assert healthy.count() == 1 and revived.spill_pending() == 0


def test_open_breaker_reads_from_the_fallback(pkg):
    class _Hits:
        def search(self, query, top_k):
            return ["local-hit"]

    br = pkg.breaker.CircuitBreaker("vr", failure_threshold=1, reset_timeout_s=60.0)
    store = pkg.stores.ResilientVectorStore(_FlakyVectorStore(fail_n=99), breaker=br,
                                            fallback=_Hits())
    br.record_failure()
    assert store.search([1.0], 3) == ["local-hit"]
    with pytest.raises(pkg.breaker.CircuitOpenError):
        pkg.stores.ResilientVectorStore(_FlakyVectorStore(), breaker=br).search([1.0], 3)


def test_config_errors_are_never_spilled(pkg):
    class _DimMismatch(_FlakyVectorStore):
        def upsert(self, points):
            raise ValueError("dim mismatch")

    store = pkg.stores.ResilientVectorStore(_DimMismatch(),
                                            breaker=pkg.breaker.CircuitBreaker("vc"))
    with pytest.raises(ValueError):
        store.upsert([("a", [1.0], {})])
    assert store.spill_pending() == 0


def _doc(pkg, i, sentences=("a.",)):
    return pkg.schema.TokenizedTextMessage(original_id=f"d{i}", source_url="u", tokens=["a"],
                                           sentences=list(sentences), timestamp_ms=1)


def test_graph_outage_spills_and_replays(pkg, tmp_path):
    class _FlakyGraph:
        def __init__(self):
            self.calls = 0
            self.saved = []

        def save_tokenized(self, msg):
            self.calls += 1
            if self.calls == 1:
                raise ConnectionError("neo4j down")
            self.saved.append(msg.original_id)
            return 1

    inner = _FlakyGraph()
    store = pkg.stores.ResilientGraphStore(
        inner, breaker=pkg.breaker.CircuitBreaker("g", failure_threshold=10),
        spill_path=str(tmp_path / "graph.spill.jsonl"))
    assert store.save_tokenized(_doc(pkg, 0)) == -1 and store.spill_pending() == 1
    assert store.save_tokenized(_doc(pkg, 1)) == 1
    assert inner.saved == ["d0", "d1"] and store.spill_pending() == 0


# ---------------------------------------------------------------- backends


def _qcfg(pkg, uri, dim=8):
    return pkg.config.VectorStoreConfig(uri=uri, dim=dim, collection="symbiont_test")


def test_qdrant_ensure_upsert_search_count(pkg, fake_qdrant):
    uri, state = fake_qdrant
    store = pkg.qdrant.QdrantStore(_qcfg(pkg, uri), retries=2, retry_delay_s=0.05)
    store.ensure_collection()
    store.ensure_collection()  # idempotent
    assert state["collections"]["symbiont_test"]["dim"] == 8
    vecs = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    assert store.upsert([(f"p{i}", vecs[i], {"sentence_text": f"s{i}"}) for i in range(5)]) == 5
    assert store.count() == 5
    hits = store.search(vecs[3], 2)
    assert [h.id for h in hits][0] == "p3" and hits[0].payload["sentence_text"] == "s3"
    assert len(hits) == 2 and store.search(vecs[0], 0) == []


def test_qdrant_hits_are_the_same_in_both_packages(fake_qdrant):
    uri, _ = fake_qdrant
    vecs = np.random.default_rng(3).normal(size=(12, 8)).astype(np.float32)
    got = {}
    for name, p in PACKAGES.items():
        store = p.qdrant.QdrantStore(_qcfg(p, uri), retries=1, retry_delay_s=0.01)
        store.ensure_collection()
        store.upsert([(f"p{i}", vecs[i], {"i": i}) for i in range(12)])
        got[name] = [[(h.id, h.score, h.payload) for h in store.search(q, 4)] for q in vecs[:3]]
    assert got["jax"] == got["port"]


def test_qdrant_partial_commit_marker(pkg, fake_qdrant, monkeypatch):
    uri, state = fake_qdrant
    store = pkg.qdrant.QdrantStore(_qcfg(pkg, uri), retries=2, retry_delay_s=0.05)
    store.ensure_collection()
    monkeypatch.setattr(pkg.qdrant.QdrantStore, "UPSERT_CHUNK", 2)
    vecs = np.random.default_rng(1).normal(size=(5, 8)).astype(np.float32)
    state["fail_upserts_after_requests"] = 1  # chunk 0 lands, chunk 1 fails
    with pytest.raises(Exception) as ei:
        store.upsert([(f"q{i}", vecs[i], {}) for i in range(5)])
    assert ei.value.points_committed == 2
    del state["fail_upserts_after_requests"]
    assert store.upsert([(f"q{i}", vecs[i], {}) for i in range(5)]) == 5
    assert store.count() == 5


def test_qdrant_unreachable_dim_mismatch_and_scheme(pkg, fake_qdrant):
    with pytest.raises(ConnectionError, match="unreachable"):
        pkg.qdrant.QdrantStore(_qcfg(pkg, "http://127.0.0.1:1"), retries=2,
                               retry_delay_s=0.01).ensure_collection()
    uri, _ = fake_qdrant
    pkg.qdrant.QdrantStore(_qcfg(pkg, uri), retries=1, retry_delay_s=0.01).ensure_collection()
    with pytest.raises(ValueError, match="dim=8"):
        pkg.qdrant.QdrantStore(_qcfg(pkg, uri, dim=16), retries=1,
                               retry_delay_s=0.01).ensure_collection()
    with pytest.raises(ValueError, match="REST endpoint"):
        pkg.qdrant.QdrantStore(_qcfg(pkg, "grpc://host:6334"))


def _neo4j_statements(p, uri):
    store = p.neo4j.Neo4jGraphStore(p.config.GraphStoreConfig(uri=uri, user="u", password="p"),
                                    retries=1, retry_delay_s=0.01)
    store.ensure_schema()
    doc_id = store.save_tokenized(p.schema.TokenizedTextMessage(
        original_id="doc-1", source_url="http://src",
        sentences=["First sentence.", "  ", "Second one.", "First sentence."],
        tokens=["Alpha", "beta", " ", "ALPHA"], timestamp_ms=1718000000000))
    counts = store.counts()
    store.close()
    return doc_id, counts


def test_neo4j_statements_are_the_same_in_both_packages(fake_neo4j):
    uri, state = fake_neo4j
    seen = {}
    for name, p in PACKAGES.items():
        n0, p0 = len(state["statements"]), len(state["paths"])
        doc_id, counts = _neo4j_statements(p, uri)
        seen[name] = (doc_id, counts, state["statements"][n0:], state["paths"][p0:])
    assert seen["jax"] == seen["port"]
    doc_id, counts, stmts, paths = seen["port"]
    assert doc_id == 42 and counts == {"Document": 7, "Sentence": 7, "Token": 7}
    assert stmts[2][0].startswith("MERGE (d:Document") and paths[-1].endswith("/tx/commit")
    assert [p["lc"] for s, p in stmts if "CONTAINS_TOKEN" in s] == ["alpha", "beta", "alpha"]


def test_neo4j_unreachable_and_bolt_refused(pkg):
    with pytest.raises(ConnectionError, match="unreachable"):
        pkg.neo4j.Neo4jGraphStore(pkg.config.GraphStoreConfig(uri="http://127.0.0.1:1"),
                                  retries=2, retry_delay_s=0.01).ensure_schema()
    with pytest.raises(ValueError, match="bolt"):
        pkg.neo4j.Neo4jGraphStore(pkg.config.GraphStoreConfig(uri="bolt://neo4j:7687"))


# ------------------------------------------------------------- the factories


def test_factories_pick_the_backend_from_the_uri(tmp_path):
    cfg = tconfig.VectorStoreConfig(dim=8)
    assert isinstance(make_vector_store(cfg, device="cpu"), VectorStore)
    q = make_vector_store(tconfig.VectorStoreConfig(uri="http://127.0.0.1:1", dim=8))
    assert isinstance(q, tqdrant.QdrantStore)
    embedded = make_graph_store(tconfig.GraphStoreConfig(data_dir=str(tmp_path)))
    assert isinstance(embedded, tgraph_store.GraphStore)
    embedded.close()
    assert isinstance(make_graph_store(tconfig.GraphStoreConfig(uri="http://127.0.0.1:1")),
                      tneo4j.Neo4jGraphStore)


def test_factories_wrap_external_stores_when_breakers_are_on(tmp_path):
    res = tconfig.ResilienceConfig(breaker_enabled=True, spill_dir=str(tmp_path))
    v = make_vector_store(tconfig.VectorStoreConfig(uri="http://127.0.0.1:1", dim=8),
                          resilience=res)
    g = make_graph_store(tconfig.GraphStoreConfig(uri="http://127.0.0.1:1"), resilience=res)
    assert isinstance(v, tstores.ResilientVectorStore)
    assert isinstance(v.inner, tqdrant.QdrantStore)
    assert isinstance(g, tstores.ResilientGraphStore)
    assert isinstance(g.inner, tneo4j.Neo4jGraphStore)
    off = tconfig.ResilienceConfig(breaker_enabled=False)
    assert isinstance(make_vector_store(tconfig.VectorStoreConfig(uri="http://h:1", dim=8),
                                        resilience=off), tqdrant.QdrantStore)
