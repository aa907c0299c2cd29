"""The port's observability hooks (utils/telemetry.py, obs/) against the JAX
package's: the metrics registry renders the same snapshot for the same
operations, the device-memory ledger's claims retire with their owners and
reconcile on the CPU against the live-tensor census, `guard_oom` records and re-raises a
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
    # the name is from before the census was ported: without CUDA the
    # basis is now the live-tensor census, as JAX's falls back to
    # `jax.live_arrays()` on the CPU
    ledger = thbm.HbmLedger()
    owner = _Owner(1 << 20)
    ledger.claim("engine.params", owner, lambda o: o.n)
    held = torch.zeros(1 << 22, dtype=torch.uint8)  # 4 MiB the census must see
    rec = ledger.reconcile(census_rows=4)
    assert rec["basis"] == "live_arrays" and rec["devices"] == []
    assert jhbm.HbmLedger(jtelemetry.Metrics()).reconcile()["basis"] == "live_arrays"
    assert rec["bytes_in_use"] >= held.numel()
    assert rec["unattributed_bytes"] == max(0, rec["bytes_in_use"] - (1 << 20))
    assert rec["attributed_bytes"] == 1 << 20
    assert rec["census"]["available"] and len(rec["census"]["groups"]) <= 5
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
    assert report["memory"]["basis"] in ("live_arrays", "memory_stats")
    assert report["census"]["available"] and len(report["census"]["groups"]) <= 33
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


# ------------------------------------------------------------------ A7's rest

# dtypes both packages name alike, for arrays and tensors of equal shapes
_CENSUS_SET = [((64, 32), "float32"), ((64, 32), "float32"), ((8,), "int32"),
               ((3, 5, 7), "bfloat16"), ((1000,), "bool"), ((2, 2), "int8"), ((16, 16), "float32")]


def _strip(rows, key="sharding"):
    return [{k: v for k, v in r.items() if k != key} for r in rows]


def _censuses(monkeypatch, arrays_np, top):
    """JAX's census of `arrays_np` as jax arrays (`jax.live_arrays`
    patched to them) and the port's of the same as CPU tensors (the
    collector's objects patched to them, a view beside one of them that
    must not count twice)."""
    jarrs = [jax.numpy.asarray(a) for a in arrays_np]
    tens = [torch.from_numpy(np.asarray(a, np.float32)).to(
        {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32,
         "bool": torch.bool, "int8": torch.int8}[str(a.dtype)]) for a in arrays_np]
    monkeypatch.setattr(jax, "live_arrays", lambda: jarrs)
    monkeypatch.setattr(thbm.gc, "get_objects", lambda: [*tens, tens[0][:3], object()])
    return jhbm.census(top=top), thbm.census(top=top, device="cpu")


def _arrays(spec, seed=0):
    import ml_dtypes

    rng = np.random.default_rng(seed)
    dt = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32, "int32": np.int32,
          "bool": np.bool_, "int8": np.int8}
    return [rng.normal(size=shape).astype(dt[d]) for shape, d in spec]


@pytest.mark.parametrize("top", [0, 3])
def test_census_groups_fold_and_order_as_jax(monkeypatch, top):
    """Equal arrays and tensors: the same groups (shape, dtype, count,
    bytes), the same order, the same "(other)" fold past `top`; a view
    counts its storage once."""
    j, t = _censuses(monkeypatch, _arrays(_CENSUS_SET), top)
    assert t["available"] and j["available"]
    assert {k: t[k] for k in ("arrays", "bytes_total", "group_count")} == {
        k: j[k] for k in ("arrays", "bytes_total", "group_count")}
    assert _strip(t["groups"]) == _strip(j["groups"])
    assert {g["sharding"] for g in t["groups"] if g["dtype"] != "(other)"} == {"cpu"}
    if top:
        assert t["groups"][-1]["dtype"] == "(other)" and len(t["groups"]) == top + 1


def test_census_diff_matches_jax(monkeypatch):
    """Two censuses a group apart, diffed by both packages: the same
    deltas, growth first."""
    before_np = _arrays(_CENSUS_SET)
    after_np = before_np[1:] + _arrays([((128, 32), "float32"), ((8,), "int32")], seed=1)
    jb, tb = _censuses(monkeypatch, before_np, 0)
    ja, ta = _censuses(monkeypatch, after_np, 0)
    jd, td = jhbm.census_diff(jb, ja, top=3), thbm.census_diff(tb, ta, top=3)
    assert set(td) == set(jd) and td["available"]
    assert (td["bytes_delta"], td["array_delta"]) == (jd["bytes_delta"], jd["array_delta"])
    assert _strip(td["groups"]) == _strip(jd["groups"])
    assert thbm.census_diff({"available": False}, ta) == {"available": False}


def test_peak_temp_bytes_reads_the_ledger_as_jax(monkeypatch):
    """The largest `temp_bytes` of the ledger's rows under a prefix; rows
    without a memory analysis count as none, in both packages."""
    mine, theirs = txprof.DispatchLedger(), jxprof.DispatchLedger(registry=jtelemetry.Metrics())
    monkeypatch.setattr(txprof, "dispatch_ledger", mine)
    monkeypatch.setattr(jxprof, "dispatch_ledger", theirs)
    for ledger in (mine, theirs):
        ledger.note_compile("lm.prefill[P=64,B=1,new=64]", {"flops": 1.0, "bytes_accessed": 2.0},
                            {"temp_bytes": 4096, "argument_bytes": 512, "output_bytes": 64})
        ledger.note_compile("lm.verify_chunk[P=64,B=8,k=8]", None, {"temp_bytes": 9000})
        ledger.note_compile("embed[L=32,B=8]", None, {"temp_bytes": 1 << 20})
        ledger.note_compile("lm.decode_chunk[P=64,B=8,chunk=16]", None)
    for prefix in ("lm.", "embed", "", "none."):
        assert thbm.peak_temp_bytes(prefix) == jhbm.peak_temp_bytes(prefix)
    assert thbm.peak_temp_bytes("lm.") == 9000
    rows = {r["executable"]: r for r in mine.snapshot()}
    want = {r["executable"]: r for r in theirs.snapshot()}
    assert rows == want


def test_grade_executable_copy_matches_jax():
    from symbiont_tpu.bench.roofline import grade_executable as jgrade

    table = [(None, None, 0.1, 3, None), (2e9, 4e8, 0.5, 5, None), (0.0, 1e6, 0.02, 2, 100.0),
             (5e12, None, 1.0, 10, 3350.0), (1e9, 1e9, 0.0, 4, None), (1e9, 1e9, 0.3, 0, None),
             (7.5e10, 3e9, 0.125, 7, 2000.0)]
    for args in table:
        assert txprof.grade_executable(*args) == jgrade(*args), args


def test_gemm_executable_cost_is_2mnk_and_attention_adds_b1():
    """An executable's first call (its cost analysis on the CPU): a GEMM
    of [M, K] x [K, N] counts 2·M·N·K operations and its operands' and
    result's bytes; a launch of the flash kernel recorded inside adds the
    B1 formula's operations and bytes (`ops/flash_attention.kernel_work`:
    4·B·NH·pairs·D, causal pairs the lower triangle)."""
    from symbiont_tpu_torch.graphs import Executable
    from symbiont_tpu_torch.ops import flash_attention as fa

    M, K, N = 16, 32, 8
    a, b = torch.randn(M, K), torch.randn(K, N)
    gemm = Executable(lambda x, y: x @ y, "cpu")
    with torch.inference_mode():
        assert torch.equal(gemm(a, b), a @ b)
    assert gemm.cost == {"flops": 2.0 * M * N * K, "bytes_accessed": float(4 * (M * K + K * N
                                                                                + M * N))}
    assert gemm.memory is None  # the CPU measures no memory
    q = torch.zeros(2, 4, 64, 32)
    kv = torch.zeros(2, 2, 64, 32)

    def attention(x, y):
        fa._note_work(0, q, kv, True)  # what a launch of B1 records
        return x @ y

    exe = Executable(attention, "cpu", signature="test.attention[S=64]")
    exe(a, b)
    pairs = 64 * 65 // 2
    b1_bytes = 2 * 2 * 4 * 64 * 32 * 4 + 2 * 2 * 2 * 64 * 32 * 4 + 2 * 64 * 4 + 2 * 4 * 64 * 4
    assert fa.kernel_work(0, q, kv, True) == (4.0 * 2 * 4 * pairs * 32, b1_bytes)
    assert exe.cost["flops"] == 2.0 * M * N * K + 4.0 * 2 * 4 * pairs * 32
    assert exe.cost["bytes_accessed"] == gemm.cost["bytes_accessed"] + b1_bytes
    row = next(r for r in txprof.dispatch_ledger.snapshot()
               if r["executable"] == "test.attention[S=64]")
    assert row["compiles"] >= 1 and row["flops"] == exe.cost["flops"]
    # B2 and B3 by their own formulas, non-causal
    f2, _ = fa.kernel_work(1, q, q, False)
    f3, _ = fa.kernel_work(2, q, q, False)
    assert (f2, f3) == (8.0 * 2 * 4 * 64 * 64 * 32, 6.0 * 2 * 4 * 64 * 64 * 32)


def test_store_search_cost_counts_its_product_and_imports_no_compiler_stack():
    """A store search's first call on the CPU, as a memory role serves it
    (under inference mode, where `aten.matmul` reaches the cost's dispatch
    mode whole): its ledger row holds the scoring product's 2·N·D
    operations (an `aten.mv`, which the flop counter leaves out), and the
    analysis imports neither `torch._dynamo` nor sympy (through torch's
    Python decompositions), which cost a role's first request seconds. In
    a process of its own, where no other test has imported them."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, tempfile, numpy as np\n"
            "from symbiont_tpu_torch.config import VectorStoreConfig\n"
            "from symbiont_tpu_torch.memory.vector_store import VectorStore\n"
            "from symbiont_tpu_torch.obs.xprof import dispatch_ledger\n"
            "store = VectorStore(VectorStoreConfig(dim=24, data_dir=tempfile.mkdtemp(), "
            "shard_capacity=96), device='cpu')\n"
            "v = np.random.default_rng(0).standard_normal((90, 24)).astype(np.float32)\n"
            "store.upsert([(f'p{i}', v[i], {}) for i in range(90)])\n"
            "hits = store.search(v[7], 5)\n"
            "assert hits[0].id == 'p7', hits\n"
            "row, = [r for r in dispatch_ledger.snapshot() "
            "if r['executable'].startswith('memory.search')]\n"
            "print(row['flops'], 'torch._dynamo' in sys.modules, 'sympy' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parents[1]).stdout.split()
    assert out == [str(2.0 * 96 * 24), "False", "False"]


def test_device_trace_capture_busy_error_and_captured(tmp_path, monkeypatch):
    """`DeviceTraceCapture`: "busy" while the profiler lock is held, a
    ValueError for a duration that is not a positive number, and a
    captured window (the CPU's activities here) clamped to `max_s`, its
    Chrome trace in the artifact directory; the counters move as JAX's."""
    cap = txprof.DeviceTraceCapture()
    cap.configure(trace_dir=str(tmp_path), max_s=0.05)
    reg = ttelemetry.metrics
    busy0 = reg.get("profile.device_busy")
    with ttelemetry._profile_lock:
        assert cap.capture(0.01) == {"status": "busy",
                                     "detail": "a profiler capture is already in flight"}
    assert reg.get("profile.device_busy") == busy0 + 1
    for bad in (0, -1.0, "soon"):
        with pytest.raises(ValueError):
            cap.capture(bad)
    n0 = reg.get("profile.device_captures")
    slept = []
    monkeypatch.setattr(txprof.time, "sleep", slept.append)
    res = cap.capture(10.0)
    assert slept == [0.05]  # the window, clamped to max_s
    assert res["status"] == "captured" and set(res) == {"status", "artifact", "window_s", "hint"}
    assert cap.last_artifact == res["artifact"]
    assert res["artifact"].startswith(str(tmp_path))
    assert "traceEvents" in json.loads(open(f"{res['artifact']}/trace.json").read())
    assert reg.get("profile.device_captures") == n0 + 1
    assert not ttelemetry._profile_lock.locked()
