"""The engines' executables on the CPU: `TorchEngine`'s executable cache,
its counts, the ingest pipeline and the store's capacity buffers and
fused warm-up, each case run on the JAX package's `TpuEngine` and on the
port's `TorchEngine` (`device="cpu"`, where an executable is the eager
function) with the same calls and the same expectations. The CUDA graph
behind an executable on the card is held by `chip_smoke.py`'s [graphs]
lines; here its launch bookkeeping runs through a stub graph."""

import asyncio
import base64
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from symbiont_tpu import subjects as jsubjects
from symbiont_tpu.bus.inproc import InprocBus as JaxBus
from symbiont_tpu.config import EngineConfig as JaxEngineConfig
from symbiont_tpu.config import VectorStoreConfig as JaxStoreConfig
from symbiont_tpu.engine.engine import TpuEngine
from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
from symbiont_tpu.memory.vector_store import VectorStore as JaxStore
from symbiont_tpu.services.engine_service import EngineService as JaxEngineService
from symbiont_tpu_torch import subjects as tsubjects
from symbiont_tpu_torch.bus.inproc import InprocBus as PortBus
from symbiont_tpu_torch.config import EngineConfig, VectorStoreConfig
from symbiont_tpu_torch import graphs
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
from symbiont_tpu_torch.memory.vector_store import VectorStore
from symbiont_tpu_torch.obs.device import COMPILE_TRACE_ID
from symbiont_tpu_torch.obs.trace_store import trace_store
from symbiont_tpu_torch.obs.xprof import dispatch_ledger
from symbiont_tpu_torch.ops import flash_attention as fa
from symbiont_tpu_torch.services.engine_service import EngineService as PortEngineService
from symbiont_tpu_torch.utils.telemetry import metrics

SMALL = dict(embedding_dim=32, length_buckets=[8, 16], batch_buckets=[2, 4], max_batch=4,
             dtype="float32")
PKGS = ["jax", "port"]


def engine(pkg, tokenizer=None, **kw):
    cfg = {**SMALL, **kw}
    if pkg == "jax":
        return TpuEngine(JaxEngineConfig(**cfg, data_parallel=False), tokenizer=tokenizer)
    return TorchEngine(EngineConfig(**cfg), tokenizer=tokenizer, device="cpu")


def store(pkg, **kw):
    if pkg == "jax":
        return JaxStore(JaxStoreConfig(dim=32, **kw))
    return VectorStore(VectorStoreConfig(dim=32, **kw), device="cpu")


@pytest.mark.parametrize("pkg", PKGS)
def test_executable_cache_bounded_and_reused(pkg):
    eng = engine(pkg)
    eng.embed_texts(["one two"])
    c0 = eng.stats["compiles"]
    eng.embed_texts(["three four"])  # same (bucket, batch) → no new compile
    assert eng.stats["compiles"] == c0
    eng.embed_texts(["w " * 14])  # longer → next bucket → one new compile
    assert eng.stats["compiles"] == c0 + 1


def test_lru_eviction_counts_match_jax():
    """At executable_cache_size=2 the same call sequence evicts and
    rebuilds the same executables in both packages."""
    calls = [["a b"], ["w " * 14], ["a b"], ["x"] * 3, ["w " * 14], ["a b"], ["x"] * 3]
    seen = {}
    for pkg in PKGS:
        eng = engine(pkg, executable_cache_size=2)
        counts = []
        for texts in calls:
            eng.embed_texts(texts)
            counts.append(eng.stats["compiles"])
        seen[pkg] = (counts, len(eng._exec_cache))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][-1] > 3 and seen["port"][1] == 2  # evictions rebuilt


@pytest.mark.parametrize("pkg", PKGS)
def test_cold_executable_race_compiles_once(pkg):
    """Two threads racing a cold key converge on one executable and count
    one compile."""
    eng = engine(pkg)
    texts = ["same shape text"] * 2
    with ThreadPoolExecutor(max_workers=2) as pool:
        a = pool.submit(eng.embed_texts, texts)
        b = pool.submit(eng.embed_texts, texts)
        np.testing.assert_allclose(a.result(), b.result(), rtol=1e-6)
    assert eng.stats["compiles"] == 1
    assert len(eng._exec_cache) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_concurrent_entry_points_stress(pkg):
    """embed / rerank / fused search from many threads: results equal the
    serial baselines and the counters are exact."""
    eng = engine(pkg, rerank_enabled=True)
    vs = store(pkg, data_dir="", shard_capacity=64)
    corpus = [f"doc {i} about topic {i % 3}" for i in range(12)]
    vecs = eng.embed_texts(corpus)
    vs.upsert([(f"p{i}", vecs[i], {"i": i}) for i in range(len(corpus))])
    texts = [f"query text number {i}" for i in range(6)]
    base_embed = eng.embed_texts(texts)
    base_rerank = eng.rerank("topic", corpus[:5])
    base_fused = [h.id for h in vs.search_fused(eng, "topic 1", 4)]
    s0 = dict(eng.stats)
    N = 8
    with ThreadPoolExecutor(max_workers=12) as pool:
        emb_f = [pool.submit(eng.embed_texts, texts) for _ in range(N)]
        rr_f = [pool.submit(eng.rerank, "topic", corpus[:5]) for _ in range(N)]
        fu_f = [pool.submit(vs.search_fused, eng, "topic 1", 4) for _ in range(N)]
        for f in emb_f:
            np.testing.assert_allclose(f.result(), base_embed, rtol=1e-5)
        for f in rr_f:
            np.testing.assert_allclose(f.result(), base_rerank, rtol=1e-5)
        for f in fu_f:
            assert [h.id for h in f.result()] == base_fused
    assert eng.stats["embed_calls"] == s0["embed_calls"] + N
    assert eng.stats["rerank_calls"] == s0["rerank_calls"] + N
    assert eng.stats["qsearch_calls"] == s0["qsearch_calls"] + N
    assert eng.stats["sentences_embedded"] == s0["sentences_embedded"] + N * len(texts)
    assert eng.stats["compiles"] == s0["compiles"]  # every shape was built serially


@pytest.mark.parametrize("pkg", PKGS)
def test_warm_fused_tracks_capacity_blocks(pkg, tmp_path):
    eng = engine(pkg)
    vs = store(pkg, data_dir=str(tmp_path), shard_capacity=64)
    assert not vs.fused_warm_stale()  # never warmed → nothing to re-warm
    vs.warm_fused(eng, word_counts=(3,))
    assert vs._warmed_capacity == 64 and not vs.fused_warm_stale()
    rng = np.random.default_rng(0)
    vs.upsert([(f"p{i}", rng.standard_normal(32), {}) for i in range(65)])
    assert vs.fused_warm_stale()
    vs.warm_fused(eng, word_counts=(3,))
    assert vs._warmed_capacity == 128 and not vs.fused_warm_stale()


def test_warm_fused_builds_what_jax_compiles(tmp_path):
    """warm_fused's executables (k buckets 8 and 16 over the query length
    buckets) and a fused query after it: the same compile counts."""
    seen = {}
    for pkg in PKGS:
        eng = engine(pkg)
        vs = store(pkg, data_dir=str(tmp_path / pkg), shard_capacity=64)
        rng = np.random.default_rng(1)
        vs.upsert([(f"p{i}", rng.standard_normal(32), {}) for i in range(20)])
        vs.warm_fused(eng)
        c = eng.stats["compiles"]
        vs.search_fused(eng, "three word query", 5)
        seen[pkg] = (c, eng.stats["compiles"], eng.stats["qsearch_calls"])
    assert seen["port"] == seen["jax"] and seen["port"][0] > 0
    assert seen["port"][1] == seen["port"][0]  # the warmed query captured nothing


@pytest.mark.parametrize("pkg", PKGS)
def test_embed_texts_chunked_pipeline_matches_unchunked(pkg):
    texts = [f"sentence {i} " + "pad " * (i % 13) for i in range(30)]
    base = engine(pkg).embed_texts(texts)
    chunked = engine(pkg, host_prep_chunk=7)
    got = chunked.embed_texts(texts)
    if pkg == "jax":  # XLA's CPU sums differ with the batch's make-up
        np.testing.assert_allclose(got, base, atol=1e-4, rtol=1e-3)
    else:
        np.testing.assert_array_equal(got, base)
    assert chunked._prep_pool is not None  # the prep thread tokenized


@pytest.mark.parametrize("pkg", PKGS)
def test_embed_texts_prefetch_overlaps_dispatch(pkg):
    """Tokenize of chunk N+1 runs while chunk N dispatches: the gated
    tokenizer blocks chunk 2's encode until chunk 1 has dispatched, so a
    serial implementation times out."""
    dispatched = threading.Event()
    base = JaxHashTokenizer if pkg == "jax" else HashTokenizer

    class GatedTok(base):
        def __init__(self):
            super().__init__(30000)
            self.calls = 0

        def encode_batch(self, texts, max_len):
            self.calls += 1
            if self.calls == 2:  # chunk 2 rides the prefetch thread
                assert dispatched.wait(10), "chunk-2 tokenize did not overlap chunk-1 dispatch"
            return super().encode_batch(texts, max_len)

    tok = GatedTok()
    eng = engine(pkg, tokenizer=tok, host_prep_chunk=4)
    orig = eng._dispatch_embed

    def wrapped(encoded, offset, buckets, pending):
        orig(encoded, offset, buckets, pending)
        dispatched.set()

    eng._dispatch_embed = wrapped
    out = eng.embed_texts([f"t {i} " + "w " * (i % 10) for i in range(10)])
    assert out.shape == (10, 32)
    assert tok.calls == 3  # 10 texts / chunk 4


def test_compile_gauges_ledger_and_trace_span():
    """engine.compiles / engine.compile_s are registered and follow the
    stats; each first call notes a compile in the dispatch ledger and a
    span on the engine-compiles trace under JAX's signature string."""
    eng = engine("port")
    labels = {"service": "engine"}
    assert metrics.gauge_get("engine.compiles", labels) == 0
    before = {r["executable"]: r["compiles"] for r in dispatch_ledger.snapshot()}
    eng.embed_texts(["one two three"])
    assert metrics.gauge_get("engine.compiles", labels) == eng.stats["compiles"] == 1
    assert metrics.gauge_get("engine.compile_s", labels) == eng.stats["compile_s"] > 0
    sig = "embed[L=8,B=2]"
    rows = {r["executable"]: r for r in dispatch_ledger.snapshot()}
    assert rows[sig]["compiles"] == before.get(sig, 0) + 1
    spans = [s for s in trace_store.spans_for(COMPILE_TRACE_ID)
             if s.fields.get("signature") == sig]
    assert spans and spans[-1].name == "engine.compile" and spans[-1].duration_ms > 0


def test_k_static_matches_jax():
    jv, tv = store("jax", data_dir=""), store("port", data_dir="")
    for top_k in (0, 1, 5, 8, 9, 16, 17, 100, 1000):
        for n in (0, 1, 7, 8, 20, 64, 300):
            for cap in (8, 64, 128, 65536):
                assert tv._k_static(top_k, n, cap) == jv._k_static(top_k, n, cap), \
                    (top_k, n, cap)


def test_one_corpus_buffer_per_capacity():
    """Syncs write the rows into the capacity's buffer in place; a new
    buffer only past a block, and the search executables go with the old
    one."""
    vs = store("port", data_dir="", shard_capacity=64)
    rng = np.random.default_rng(2)
    vs.upsert([(f"a{i}", rng.standard_normal(32), {}) for i in range(10)])
    hits = vs.search(rng.standard_normal(32), 3)
    buf = vs._device_corpus
    ptr = buf.data_ptr()
    assert len(hits) == 3 and len(vs._search_fns) == 1
    vs.upsert([(f"b{i}", rng.standard_normal(32), {}) for i in range(40)])
    vs.search(rng.standard_normal(32), 3)
    assert vs._device_corpus is buf and buf.data_ptr() == ptr and tuple(buf.shape) == (64, 32)
    assert len(vs._search_fns) == 1  # 50 rows: the same (capacity, k) executable
    np.testing.assert_array_equal(buf[:50].float().numpy(),
                                  torch.from_numpy(vs._vectors).bfloat16().float().numpy())
    vs.upsert([(f"c{i}", rng.standard_normal(32), {}) for i in range(20)])
    vs.search(rng.standard_normal(32), 3)
    assert vs._device_corpus is not buf and tuple(vs._device_corpus.shape) == (128, 32)
    assert list(vs._search_fns) == [(128, 8)]


def test_store_search_matches_jax(tmp_path):
    """search through the (capacity, k bucket) executables returns the JAX
    store's hits for every top_k."""
    rng = np.random.default_rng(3)
    pts = [(f"p{i}", rng.standard_normal(32), {"i": i}) for i in range(40)]
    jv, tv = store("jax", data_dir=""), store("port", data_dir="")
    jv.upsert(pts)
    tv.upsert(pts)
    for top_k in (1, 5, 8, 12, 40, 60):
        q = rng.standard_normal(32)
        jh, th = jv.search(q, top_k), tv.search(q, top_k)
        assert [h.id for h in th] == [h.id for h in jh]
        np.testing.assert_allclose([h.score for h in th], [h.score for h in jh], atol=1e-5)


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_service_rewarms_after_a_block_crossing(pkg, tmp_path):
    """The service warms the fused query at start and again once upserts
    cross a capacity block (the executables are keyed by capacity)."""
    Bus, Svc, subj = ((JaxBus, JaxEngineService, jsubjects) if pkg == "jax"
                      else (PortBus, PortEngineService, tsubjects))

    async def scenario():
        bus = Bus()
        vs = store(pkg, data_dir=str(tmp_path), shard_capacity=64)
        svc = Svc(bus, engine=engine(pkg), vector_store=vs, coalesce=False)
        await svc.start()

        async def warmed():
            while svc._warm_task is not None and not svc._warm_task.done():
                await asyncio.sleep(0.01)

        try:
            await warmed()
            assert vs._warmed_capacity == 64
            rows = np.random.default_rng(4).standard_normal((65, 32)).astype(np.float32)
            msg = await bus.request(subj.ENGINE_VECTOR_UPSERT, json.dumps({
                "ids": [f"00000000-0000-4000-8000-{i:012d}" for i in range(65)], "dim": 32,
                "vectors_b64": base64.b64encode(rows.tobytes()).decode()}).encode(), 30.0)
            assert json.loads(msg.data)["upserted"] == 65
            await asyncio.sleep(0.05)
            await warmed()
            assert vs._warmed_capacity == 128 and not vs.fused_warm_stale()
            assert not svc._warm_failed
        finally:
            await svc.stop()
            await bus.close()

    asyncio.run(scenario())


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_count_captured_launches():
    """A replay makes no wrapper call: each one adds the launches its
    capture recorded (here 12 B1 and 1 B3 through a stub graph), and a
    call made under capture goes to the capturing thread's tally."""
    exe = graphs.Executable(lambda x: x, "cpu")
    exe.graph, exe.static_in, exe.counts = _StubGraph(), (torch.zeros(2),), (12, 0, 1)
    l0, q0 = fa.launches, fa.bwd_q_launches
    for _ in range(5):
        exe.replay((torch.ones(2),))
    assert exe.graph.replays == exe.replays == 5
    assert fa.launches - l0 == 60 and fa.bwd_q_launches - q0 == 5
    assert torch.equal(exe.static_in[0], torch.ones(2))
    fa.note_replay((0, 0, 0), 3)
    assert fa.launches - l0 == 60
    assert fa.take_captured() == (0, 0, 0)


def test_cpu_executables_run_the_function_eagerly():
    calls = []
    firsts = []
    exe = graphs.Executable(lambda x: calls.append(x) or x * 2, "cpu", on_first=firsts.append)
    assert torch.equal(exe(torch.ones(3)), torch.full((3,), 2.0))
    exe(torch.ones(3))
    assert len(calls) == 2 and len(firsts) == 1 and exe.graph is None


def test_graphs_encoder_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """[graphs]' encoder lines end to end on the CPU at a tiny geometry:
    every check they make on the card, B1's plain forwards counted as its
    launches (a CPU executable captures nothing, so no warm-up runs)."""
    forward = fa._forward

    def counted(*a, **kw):
        with fa._count_lock:
            fa.launches += 1
        return forward(*a, **kw)

    monkeypatch.setattr(fa, "_forward", counted)
    out = chip_smoke.graphs_encoder_phase(
        chip_smoke.synth_texts(np.random.default_rng(0), 64), device="cpu",
        engine_kw=dict(embedding_dim=64, length_buckets=[16, 32, 64], batch_buckets=[1, 4, 16],
                       max_batch=16))
    printed = capsys.readouterr().out
    assert printed.count("[graphs]") == 3
    assert out["b1_cold"] == out["b1_warm"] == 6 * out["batches"]
    assert out["compiles"] == out["signatures"] + out["rerank_captures"] + out["fused_captures"]
    assert out["graph_pool_bytes"] is None and out["busy_pct"] is None
