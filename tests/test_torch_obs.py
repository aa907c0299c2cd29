"""The port's observability hooks (utils/telemetry.py, obs/) against the JAX
package's: the metrics registry renders the same snapshot for the same
operations, the device-memory ledger's claims retire with their owners and
reconcile on the CPU with basis "none", `guard_oom` records and re-raises a
device OOM, the dispatch ledger and the padding series read as the JAX
engine's for the same batches, and `maybe_profile` writes a Chrome trace.

The registries are process-global in both packages, and other tests of a
worker write to them too: these tests read deltas, by label, or use
registries of their own."""

import gc
import json

import jax
import numpy as np
import pytest
import torch

from symbiont_tpu.config import EngineConfig as JaxEngineConfig
from symbiont_tpu.engine.engine import TpuEngine
from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
from symbiont_tpu.models import bert as jbert
from symbiont_tpu.obs import engine_timeline as jtimeline
from symbiont_tpu.obs import hbm as jhbm
from symbiont_tpu.obs import xprof as jxprof
from symbiont_tpu.utils import telemetry as jtelemetry
from symbiont_tpu_torch.config import EngineConfig, VectorStoreConfig
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
from symbiont_tpu_torch.memory.vector_store import VectorStore
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.obs import device as tdevice
from symbiont_tpu_torch.obs import engine_timeline as ttimeline
from symbiont_tpu_torch.obs import hbm as thbm
from symbiont_tpu_torch.obs import xprof as txprof
from symbiont_tpu_torch.utils import telemetry as ttelemetry

VOCAB = 1000
GEOM = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=64, dtype="float32")
ENG = dict(embedding_dim=64, length_buckets=[16, 32, 64], batch_buckets=[2, 4],
           max_batch=4, dtype="float32")
TEXTS = [" ".join(f"w{(i * 7 + j) % 97}" for j in range(n))
         for i, n in enumerate([3, 40, 9, 1, 25, 60, 14, 2, 33, 7, 50])]
ENGINE = {"service": "engine"}


class _Owner:
    """Something a claim or a weakref gauge can be bound to."""

    def __init__(self, n):
        self.n = n


def _drive(m, owner):
    """The same registry operations, on either package's `Metrics`."""
    m.inc("a.total")
    m.inc("a.total", 2, labels={"site": "x"})
    m.inc("a.total", 0.5, labels={"site": "x"})
    for v in (0.5, 3.0, 7.0, 7.0, 120.0, 20000.0):
        m.observe("lat_ms", v, labels={"route": "embed"})
    m.gauge_set("g.value", 4, labels={"service": "engine", "dtype": "int8"})
    m.gauge_add("g.live", 3)
    m.gauge_add("g.live", -1)
    m.register_gauge("g.callback", lambda: 11, labels={"device": "0"})
    m.register_gauge("g.flaky", lambda: 1 / 0)
    m.register_weakref_gauge("g.owned", owner, lambda o: o.n)


def test_metrics_render_as_the_jax_registry():
    mine, theirs = ttelemetry.Metrics(), jtelemetry.Metrics()
    owner = _Owner(5)
    _drive(mine, owner)
    _drive(theirs, owner)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.export()["counters"] == theirs.export()["counters"]
    assert mine.get("a.total", {"site": "x"}) == 2.5
    assert mine.gauge_get("g.owned") == 5 and mine.gauge_get("g.live") == 2
    summary = mine.histogram_summary("lat_ms", {"route": "embed"})
    assert (summary["count"], summary["min"], summary["max"]) == (6, 0.5, 20000.0)
    assert summary["buckets"][-1] == ("+Inf", 6)
    # a dead owner retires its weakref gauge; a raising callback is kept
    del owner
    gc.collect()
    assert "g.owned" not in mine.snapshot()["gauges"]
    assert mine.snapshot() == theirs.snapshot()
    assert ("g.flaky", ()) in mine._gauge_fns


def _ledger_ops(ledger, owners):
    ledger.claim("engine.params", owners[0], lambda o: o.n)
    ledger.claim("engine.params", owners[1], lambda o: o.n)  # one subsystem sums
    ledger.claim("memory.corpus", owners[2], lambda o: o.n)
    ledger.claim("kv.view", owners[2], lambda o: 50, overlay=True)
    ledger.claim("retired", owners[2], lambda o: None)
    ledger.claim("flaky", owners[1], lambda o: 1 / 0)  # skipped this read, kept


def test_hbm_claims_sum_retire_and_match_jax():
    mine, theirs = thbm.HbmLedger(), jhbm.HbmLedger(jtelemetry.Metrics())
    owners = [_Owner(100), _Owner(30), _Owner(64)]
    _ledger_ops(mine, owners)
    _ledger_ops(theirs, owners)
    rows = mine.rows()
    assert rows == theirs.rows()
    assert [(r["subsystem"], r["bytes"]) for r in rows] == [
        ("engine.params", 130), ("memory.corpus", 64), ("kv.view", 50)]
    assert mine.attributed_bytes() == theirs.attributed_bytes() == 194  # overlay left out
    assert len(mine) == 5  # "retired" is gone, "flaky" stays
    # the claims retire with their owners
    del owners[0]
    gc.collect()
    assert {r["subsystem"]: r["bytes"] for r in mine.rows()}["engine.params"] == 30
    owners.clear()
    gc.collect()
    assert mine.rows() == [] and len(mine) == 0


def test_reconcile_without_cuda_has_basis_none():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ledger = thbm.HbmLedger()
    owner = _Owner(1 << 20)
    ledger.claim("engine.params", owner, lambda o: o.n)
    rec = ledger.reconcile()
    assert rec["basis"] == "none" and rec["devices"] == []
    assert rec["bytes_in_use"] == 0 and rec["unattributed_bytes"] == 0
    assert rec["attributed_bytes"] == 1 << 20
    assert tdevice.local_device_stats() == []
    registry = ttelemetry.Metrics()
    assert tdevice.register_device_gauges(registry) == 0
    assert registry.snapshot()["gauges"] == {}


def test_guard_oom_records_and_reraises(tmp_path, monkeypatch):
    forensics = thbm.oom_forensics
    monkeypatch.setattr(forensics, "_dir", str(tmp_path))
    site = {"site": "test.guard"}
    before = ttelemetry.metrics.get("engine.oom_total", site)
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 PiB")
    with pytest.raises(torch.cuda.OutOfMemoryError) as raised:
        with thbm.guard_oom("test.guard"):
            raise err
    assert raised.value is err  # re-raised unchanged
    assert ttelemetry.metrics.get("engine.oom_total", site) == before + 1
    last = forensics.last
    assert last["site"] == "test.guard" and last["postmortem"].startswith(str(tmp_path))
    report = json.loads(open(last["postmortem"]).read())
    assert report["error_type"] == "OutOfMemoryError"
    assert report["memory"]["basis"] in ("none", "memory_stats")
    assert isinstance(report["timeline_tail"], list)
    # other errors pass through uncounted; a message-only OOM is recognised
    with pytest.raises(ValueError):
        with thbm.guard_oom("test.guard"):
            raise ValueError("shape mismatch")
    assert ttelemetry.metrics.get("engine.oom_total", site) == before + 1
    assert thbm.is_oom(RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"))
    assert not thbm.is_oom(RuntimeError("device-side assert triggered"))
    # the postmortem directory stays bounded
    monkeypatch.setattr(forensics, "_max_files", 2)
    for _ in range(4):
        forensics.record("test.prune", err)
    assert len([p for p in tmp_path.iterdir() if p.name.startswith("oom_")]) == 2


def test_dispatch_ledger_rows_and_bound():
    registry = ttelemetry.Metrics()
    ledger = txprof.DispatchLedger(max_executables=2, registry=registry)
    ledger.note_dispatch("embed[L=32,B=8]", 0.002)
    ledger.note_dispatch("embed[L=32,B=8]", 0.004)
    ledger.note_dispatch("rerank[L=64,B=8]", 0.001)
    ledger.note_dispatch("qsearch[L=32,B=(1024, 8)]", 0.001)  # evicts the oldest row
    rows = ledger.snapshot()
    assert [r["executable"] for r in rows] == ["rerank[L=64,B=8]", "qsearch[L=32,B=(1024, 8)]"]
    assert registry.get("xla.dispatches_total", {"executable": "embed[L=32,B=8]"}) == 2
    ledger.note_host_sync("site", 3)
    assert registry.get("engine.host_syncs_total", {"site": "site"}) == 3
    assert len(ledger) == 2


@pytest.fixture(scope="module")
def engines():
    jcfg = jbert.BertConfig(**GEOM)
    jp = jbert.init_params(jax.random.key(0), jcfg)
    jc = jbert.init_params(jax.random.key(1), jcfg, with_pooler=True)
    jax_eng = TpuEngine(JaxEngineConfig(**ENG, data_parallel=False), params=jp,
                        model_cfg=jcfg, tokenizer=JaxHashTokenizer(VOCAB),
                        cross_params=jc, cross_cfg=jcfg)
    tcfg = tbert.BertConfig(**GEOM)
    to_t = lambda t: bert_params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    port = TorchEngine(EngineConfig(**ENG), params=to_t(jp), model_cfg=tcfg,
                       tokenizer=HashTokenizer(VOCAB), cross_params=to_t(jc),
                       cross_cfg=tcfg, device="cpu")
    return jax_eng, port


def _padding_series(m):
    return (m.get("engine.tokens_real", ENGINE), m.get("engine.tokens_padding", ENGINE))


def test_padding_series_and_dispatches_match_jax(engines):
    jax_eng, port = engines
    calls = (lambda e: e.embed_texts(TEXTS), lambda e: e.rerank("w1 w2", TEXTS[:5]))
    for call in calls:
        deltas = []
        for eng, m, tl, dl in ((jax_eng, jtelemetry.metrics, jtimeline.engine_timeline,
                                jxprof.dispatch_ledger),
                               (port, ttelemetry.metrics, ttimeline.engine_timeline,
                                txprof.dispatch_ledger)):
            tokens0, n0 = _padding_series(m), len(tl.events())
            disp0 = {r["executable"]: r["dispatches"] for r in dl.snapshot()}
            call(eng)
            tokens1 = _padding_series(m)
            flushes = [{k: e[k] for k in ("bucket", "batch_rows", "n_real", "real_tokens",
                                          "total_tokens")} for e in tl.events()[n0:]]
            disp = {r["executable"]: r["dispatches"] - disp0.get(r["executable"], 0)
                    for r in dl.snapshot()}
            deltas.append({
                "tokens": (tokens1[0] - tokens0[0], tokens1[1] - tokens0[1]),
                "fill": m.gauge_get("engine.batch_fill_ratio", ENGINE),
                "waste": m.gauge_get("engine.bucket_pad_waste_ratio", ENGINE),
                "flushes": flushes,
                "dispatches": {s: n for s, n in disp.items() if n}})
        assert deltas[1] == deltas[0]
        assert deltas[1]["tokens"][0] > 0 and len(deltas[1]["flushes"]) >= 2


def test_qsearch_dispatch_and_host_syncs(engines):
    _, port = engines
    corpus = torch.nn.functional.normalize(torch.randn(16, 64), dim=-1)
    syncs = {"site": "TorchEngine.embed_and_search"}
    before = ttelemetry.metrics.get("engine.host_syncs_total", syncs)
    rows0 = {r["executable"]: r["dispatches"] for r in txprof.dispatch_ledger.snapshot()}
    port.embed_and_search("w3 w4 w5", corpus, 16, 4)
    rows = {r["executable"]: r["dispatches"] for r in txprof.dispatch_ledger.snapshot()}
    assert rows["qsearch[L=16,B=(16, 4)]"] == rows0.get("qsearch[L=16,B=(16, 4)]", 0) + 1
    assert ttelemetry.metrics.get("engine.host_syncs_total", syncs) == before + 1
    embed_syncs = {"site": "TorchEngine.embed_texts"}
    before = ttelemetry.metrics.get("engine.host_syncs_total", embed_syncs)
    port.embed_texts(TEXTS)  # several batches, one fetch
    assert ttelemetry.metrics.get("engine.host_syncs_total", embed_syncs) == before + 1


def test_engine_gauges_and_params_claim_retire_with_the_engine():
    eng = TorchEngine(EngineConfig(**ENG, rerank_enabled=True, quantize="int8"), device="cpu")
    held = quant.param_bytes(eng.params) + quant.param_bytes(eng.cross_params)
    rows = {r["subsystem"]: r["bytes"] for r in thbm.hbm_ledger.rows()}
    assert rows["engine.params"] >= held == eng.param_bytes()
    eng.embed_texts(TEXTS[:3])
    assert ttelemetry.metrics.gauge_get("engine.sentences_embedded", ENGINE) == 3
    assert ttelemetry.metrics.gauge_get(
        "engine.param_bytes", {**ENGINE, "dtype": "int8"}) == quant.param_bytes(eng.params)
    before = rows["engine.params"]
    del eng
    gc.collect()
    rows = {r["subsystem"]: r["bytes"] for r in thbm.hbm_ledger.rows()}
    assert rows.get("engine.params", 0) == before - held
    assert "engine.sentences_embedded" not in ttelemetry.metrics.snapshot()["gauges"]


def test_vector_store_claims_its_padded_corpus():
    store = VectorStore(VectorStoreConfig(dim=8, shard_capacity=64), device="cpu")

    def corpus_claim():
        return sum(r["bytes"] for r in thbm.hbm_ledger.rows() if r["subsystem"] == "memory.corpus")

    before = corpus_claim()
    store.upsert_rows([f"p{i}" for i in range(70)], np.ones((70, 8), np.float32),
                      [{} for _ in range(70)])
    store.search([1.0] * 8, 3)  # places the padded corpus on the device
    assert store._device_corpus.shape == (128, 8)
    assert corpus_claim() == before + 128 * 8 * 2  # bf16 rows, padded to capacity
    del store
    gc.collect()
    assert corpus_claim() == before


def test_engine_timeline_summary_matches_jax():
    mine = ttimeline.EngineTimeline(capacity=4, registry=ttelemetry.Metrics())
    theirs = jtimeline.EngineTimeline(capacity=4, registry=jtelemetry.Metrics())
    assert mine.summary()["dominant_stall"] == "no engine traffic recorded"
    for bucket, rows, n_real, real in ((32, 8, 5, 100), (64, 8, 8, 400), (16, 2, 1, 9),
                                       (32, 4, 4, 120), (128, 1, 1, 100)):
        for tl in (mine, theirs):
            tl.note_embed_flush(bucket, rows, n_real, real_tokens=real,
                                total_tokens=bucket * rows)
    got, want = mine.summary(), theirs.summary()
    for key in ("embed_flushes", "embed_padding_pct", "packing_opportunity_pct"):
        assert got[key] == want[key], key
    assert len(mine) == 4  # the ring keeps the newest
    assert (mine.registry.gauge_get("engine.packing_opportunity_pct", ENGINE)
            == theirs.registry.gauge_get("engine.packing_opportunity_pct", ENGINE))
    assert got["dominant_stall"].startswith("embed padding")


def test_maybe_profile_writes_a_chrome_trace(tmp_path, monkeypatch, engines):
    _, port = engines
    monkeypatch.delenv("SYMBIONT_PROFILE_DIR", raising=False)
    with ttelemetry.maybe_profile("test.off"):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("SYMBIONT_PROFILE_DIR", str(tmp_path))
    captured = {"name": "engine.embed"}
    before = ttelemetry.metrics.get("profile.captured", captured)
    port.embed_texts(TEXTS[:2])
    traces = list(tmp_path.glob("engine.embed.*.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert any(e.get("name") == "engine.embed" for e in trace["traceEvents"])
    assert ttelemetry.metrics.get("profile.captured", captured) == before + 1
    # one profile at a time: a nested call runs unprofiled and is counted
    skipped = {"name": "test.inner"}
    before = ttelemetry.metrics.get("profile.skipped", skipped)
    with ttelemetry.maybe_profile("test.outer"):
        with ttelemetry.maybe_profile("test.inner"):
            torch.ones(2).sum()
    assert ttelemetry.metrics.get("profile.skipped", skipped) == before + 1
    assert len(list(tmp_path.glob("test.outer.*.json"))) == 1
