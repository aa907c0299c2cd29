"""The port's SymbiontStack against the JAX package's, both from one JAX
parameter tree: the JAX stack on a float32 `TpuEngine`, the port's on a
float32 `TorchEngine` on the CPU (engines passed in, rerank on, the hash
tokenizer), each with its own in-process bus, embedded stores and gateway.
Both ingest the same pages through `/api/submit-url`, one page at a time,
and answer the same searches, fused and over the 2-hop path, over real
HTTP. Compared: the stored sentence set, the vectors by sentence text (f32
bars), the search hits (texts in order, scores), the rerank scores (with
a tolerance: the synthetic cross-encoder's score gaps are about 1e-5,
`tests/test_quantization.py:119-126`), the graph search, the Markov
chain, and the JSON key sets of every route both serve."""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from symbiont_tpu.bus.inproc import InprocBus as JaxBus
from symbiont_tpu.config import ApiConfig as JApi
from symbiont_tpu.config import EngineConfig as JEngine
from symbiont_tpu.config import GraphStoreConfig as JGraph
from symbiont_tpu.config import SymbiontConfig as JSymbiont
from symbiont_tpu.config import TextGeneratorConfig as JText
from symbiont_tpu.config import VectorStoreConfig as JVector
from symbiont_tpu.engine.engine import TpuEngine
from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
from symbiont_tpu.models import bert as jbert
from symbiont_tpu.runner import SymbiontStack as JaxStack
from symbiont_tpu_torch.bus.inproc import InprocBus as PortBus
from symbiont_tpu_torch.config import (ApiConfig, EngineConfig, GraphStoreConfig,
                                       SymbiontConfig, TextGeneratorConfig,
                                       VectorStoreConfig)
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.runner import SymbiontStack as PortStack

VOCAB = 1000
GEOM = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, dtype="float32")
ENG = dict(embedding_dim=32, length_buckets=[16, 32], batch_buckets=[2, 8], max_batch=8,
           dtype="float32", flush_deadline_ms=2.0, rerank_enabled=True)
F32 = dict(atol=2e-5, rtol=1e-4)
RERANK_TOL = 1e-4

FAKE_PAGES = {
    "http://example.com/doc1": """
      <html><body><article>
        <h1>Symbiont systems</h1>
        <p>TPUs accelerate matrix multiplication. They excel at embeddings!</p>
        <p>Vector memory stores every sentence. Graphs hold the tokens?</p>
      </article></body></html>""",
    "http://example.com/doc2": """
      <html><body><main>
        <p>Knowledge graphs link tokens to documents. Search finds meaning?</p>
        <p>Matrix engines multiply quickly. Every sentence is a vector.</p>
      </main></body></html>""",
    "http://example.com/doc3": """
      <html><body><article><p>Rerank the hits with a cross encoder. The query
      meets each passage. Scores order the results!</p></article></body></html>""",
}
N_SENTENCES = 11
QUERIES = ["matrix multiplication", "knowledge graphs and tokens", "cross encoder scores",
           "every sentence"]
GET_ROUTES = ["/healthz", "/readyz", "/api/metrics", "/api/health/engine",
              "/api/traces/recent", "/api/engine/timeline", "/api/engine/executables",
              "/api/memory", "/api/tenants", "/api/fleet", "/api/dlq"]
# keys one package's body has and the other's lacks, by route: the port's
# executables payload says why no row carries a roofline grade, and the JAX
# one names its device-trace artifact where the port has none
PORT_ONLY_KEYS: dict = {}  # route -> keys the port adds to JAX's body (none now)


def _fetcher(url: str) -> str:
    return FAKE_PAGES[url]


def _http(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _configs(tmp, side):
    kw = dict(
        vector_store=dict(dim=32, data_dir=str(tmp / f"{side}_vs"), shard_capacity=64),
        graph_store=dict(data_dir=str(tmp / f"{side}_gs")),
        text_generator=dict(markov_state_path=str(tmp / f"{side}_markov.json")),
        api=dict(host="127.0.0.1", port=0, sse_keepalive_s=0.5))
    if side == "jax":
        return JSymbiont(engine=JEngine(**ENG, data_parallel=False),
                         vector_store=JVector(**kw["vector_store"]),
                         graph_store=JGraph(**kw["graph_store"]),
                         text_generator=JText(**kw["text_generator"]), api=JApi(**kw["api"]))
    return SymbiontConfig(engine=EngineConfig(**ENG, force_cpu=True),
                          vector_store=VectorStoreConfig(**kw["vector_store"]),
                          graph_store=GraphStoreConfig(**kw["graph_store"]),
                          text_generator=TextGeneratorConfig(**kw["text_generator"]),
                          api=ApiConfig(**kw["api"]))


def _drive(stack, bus) -> dict:
    """Start `stack`, ingest FAKE_PAGES one page at a time, run the
    searches (fused, then 2-hop; rerank; graph) and read every GET route."""

    async def scenario():
        await stack.start()
        port = stack.api.port
        loop = asyncio.get_running_loop()

        def http(*a):
            return loop.run_in_executor(None, lambda: _http(port, *a))

        async def until(pred):
            for _ in range(1200):
                if pred():
                    return
                await asyncio.sleep(0.025)
            raise AssertionError("pipeline stalled")

        out = {"search": {}, "rerank": {}, "graph": {}, "routes": {}}
        try:
            n = 0
            for url in FAKE_PAGES:  # one page at a time: a fixed Markov order
                st, _ = await http("POST", "/api/submit-url", {"url": url})
                assert st == 200
                n += 1
                await until(lambda: stack.graph_store.counts()["Document"] >= n)
                textgen = next(s for s in stack.services if s.name == "text_generator")
                await until(lambda: len(textgen.markov.starters) >= n)  # one a page
            await until(lambda: stack.vector_store.count() >= N_SENTENCES)
            store = stack.vector_store
            with store._lock:
                out["vectors"] = {p["sentence_text"]: store._vectors[i].copy()
                                  for i, p in enumerate(store._payloads)}
            # the counters are the process's: count from here
            fused0 = (await http("GET", "/api/metrics"))[1]["counters"].get(
                "api.fused_search", 0)
            for hop in ("fused", "2hop"):
                stack.api.config.fused_search = hop == "fused"
                for q in QUERIES:
                    st, body = await http("POST", "/api/search/semantic",
                                          {"query_text": q, "top_k": 4})
                    assert st == 200 and body["error_message"] is None, body
                    out["search"][hop, q] = body
            for q in QUERIES:
                st, body = await http("POST", "/api/search/semantic",
                                      {"query_text": q, "top_k": 4, "rerank": True})
                assert st == 200 and body["error_message"] is None, body
                out["rerank"][q] = body
                st, body = await http("POST", "/api/search/graph",
                                      {"query_text": q, "top_k": 3})
                assert st == 200, body
                out["graph"][q] = body
            for path in GET_ROUTES:
                st, body = await http("GET", path)
                out["routes"][path] = (st, body)
            out["metrics"] = await http("GET", "/api/metrics")
            textgen = next(s for s in stack.services if s.name == "text_generator")
            out["markov"] = textgen.markov.to_state()
            out["fused_count"] = out["metrics"][1]["counters"].get("api.fused_search",
                                                                   0) - fused0
        finally:
            await stack.stop()
            await bus.close()
        return out

    return asyncio.run(scenario())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stacks")
    jcfg = jbert.BertConfig(**GEOM)
    jp = jbert.init_params(jax.random.key(0), jcfg)
    jc = jbert.init_params(jax.random.key(1), jcfg, with_pooler=True)
    jeng = TpuEngine(JEngine(**ENG, data_parallel=False), params=jp, model_cfg=jcfg,
                     tokenizer=JaxHashTokenizer(VOCAB), cross_params=jc, cross_cfg=jcfg)
    tcfg = tbert.BertConfig(**GEOM)
    to_np = lambda t: bert_params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    teng = TorchEngine(EngineConfig(**ENG), params=to_np(jp), model_cfg=tcfg,
                       tokenizer=HashTokenizer(VOCAB), cross_params=to_np(jc),
                       cross_cfg=tcfg, device="cpu")
    jbus, tbus = JaxBus(), PortBus()
    jax_run = _drive(JaxStack(_configs(tmp, "jax"), bus=jbus, engine=jeng,
                              fetcher=_fetcher), jbus)
    port_run = _drive(PortStack(_configs(tmp, "port"), bus=tbus, engine=teng,
                                fetcher=_fetcher), tbus)
    return jax_run, port_run


def test_the_same_sentences_are_stored(runs):
    j, t = runs
    assert len(t["vectors"]) == N_SENTENCES
    assert set(t["vectors"]) == set(j["vectors"])


def test_stored_vectors_match_by_sentence(runs):
    j, t = runs
    for text, vec in j["vectors"].items():
        np.testing.assert_allclose(t["vectors"][text], vec, **F32, err_msg=text)


@pytest.mark.parametrize("hop", ["fused", "2hop"])
def test_search_hits_match(runs, hop):
    j, t = runs
    for q in QUERIES:
        jr, tr = j["search"][hop, q]["results"], t["search"][hop, q]["results"]
        assert [r["payload"]["sentence_text"] for r in tr] == \
            [r["payload"]["sentence_text"] for r in jr], q
        np.testing.assert_allclose([r["score"] for r in tr], [r["score"] for r in jr],
                                   atol=1e-4)
        assert all(set(a) == set(b) and set(a["payload"]) == set(b["payload"])
                   for a, b in zip(tr, jr))


def test_both_hops_counted_as_jax_counts_them(runs):
    j, t = runs
    # the fused hop served the fused round only: with api.fused_search off
    # the 2-hop and rerank rounds never probe it
    assert t["fused_count"] == j["fused_count"] == len(QUERIES)


def test_rerank_scores_match(runs):
    j, t = runs
    for q in QUERIES:
        want = {r["payload"]["sentence_text"]: r["score"] for r in j["rerank"][q]["results"]}
        got = {r["payload"]["sentence_text"]: r["score"] for r in t["rerank"][q]["results"]}
        assert set(got) == set(want), q
        for text, s in want.items():
            assert abs(got[text] - s) <= RERANK_TOL, (q, text, got[text], s)


def test_graph_search_matches(runs):
    j, t = runs
    for q in QUERIES:
        jb, tb = dict(j["graph"][q]), dict(t["graph"][q])
        # ties rank by document id, a fresh uuid per ingest in both
        # packages: compare without the id, ties in snippet order (top_k 3
        # over 3 documents keeps every tie)
        for body in (jb, tb):
            body["results"] = sorted(({k: v for k, v in r.items()
                                       if k != "original_document_id"}
                                      for r in body["results"]),
                                     key=lambda r: (-r["match_count"], r["snippet"]))
        assert tb == jb, q


def test_markov_chain_matches(runs):
    j, t = runs
    assert t["markov"] == j["markov"] and t["markov"]["chain"]


@pytest.mark.parametrize("path", GET_ROUTES)
def test_route_bodies_have_the_same_keys(runs, path):
    j, t = runs
    (js, jb), (ts, tb) = j["routes"][path], t["routes"][path]
    assert ts == js == 200, (path, ts, js)
    extra = PORT_ONLY_KEYS.get(path, set())
    assert set(tb) - extra == set(jb), path
    assert extra <= set(tb)


def test_engine_health_stats_have_the_same_keys(runs):
    """`/api/health/engine`'s `stats`: the port's keys are JAX's (its
    executables count `compiles` and `compile_s` as JAX's do), plus the
    per-call batch counts the port also keeps."""
    j, t = runs
    jstats = j["routes"]["/api/health/engine"][1]["stats"]
    tstats = t["routes"]["/api/health/engine"][1]["stats"]
    assert {"compiles", "compile_s"} <= set(jstats)
    assert set(tstats) - {"embed_batches", "rerank_batches"} == set(jstats)
    assert tstats["compiles"] >= 1 and tstats["compile_s"] > 0


def test_search_bodies_have_the_same_keys(runs):
    j, t = runs
    for key in j["search"]:
        assert set(t["search"][key]) == set(j["search"][key])
    for q in QUERIES:
        assert set(t["graph"][q]) == set(j["graph"][q])
        assert set(t["rerank"][q]) == set(j["rerank"][q])
