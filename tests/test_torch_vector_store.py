"""The port's VectorStore (CPU corpus) against the JAX store: upsert,
search, fused search, WAL reload, snapshot, and tie order."""

import json

import numpy as np
import pytest
import torch

from symbiont_tpu.config import VectorStoreConfig as JaxStoreConfig
from symbiont_tpu.memory.vector_store import VectorStore as JaxStore
from symbiont_tpu_torch.config import VectorStoreConfig
from symbiont_tpu_torch.memory.vector_store import VectorStore, cosine_topk

DIM = 32


def _stores(tmp_path=None, **kw):
    jdir = "" if tmp_path is None else str(tmp_path / "jax")
    tdir = "" if tmp_path is None else str(tmp_path / "torch")
    j = JaxStore(JaxStoreConfig(dim=DIM, data_dir=jdir, **kw))
    t = VectorStore(VectorStoreConfig(dim=DIM, data_dir=tdir, **kw), device="cpu")
    return j, t


def _rows(seed, n):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _hits(hs):
    return [(h.id, h.score, h.payload) for h in hs]


def test_search_matches_jax(tmp_path):
    j, t = _stores(tmp_path, shard_capacity=64)
    vecs = _rows(0, 50)
    ids = [f"p{i}" for i in range(50)]
    pay = [{"i": i, "text": f"row {i}"} for i in range(50)]
    assert j.upsert_rows(ids, vecs, pay) == t.upsert_rows(ids, vecs, pay) == 50
    for seed in range(4):
        q = _rows(100 + seed, 1)[0]
        a, b = j.search(q, 7), t.search(q, 7)
        assert [h.id for h in a] == [h.id for h in b]
        np.testing.assert_allclose([h.score for h in b], [h.score for h in a],
                                   atol=1e-6)
        assert [h.payload for h in a] == [h.payload for h in b]
    assert t.search(np.zeros(DIM), 0) == [] and t.count() == 50


def test_upsert_overwrite_and_tuple_api_match_jax():
    j, t = _stores(shard_capacity=16)
    pts = [(f"p{i}", list(v), {"i": i}) for i, v in enumerate(_rows(1, 20))]
    j.upsert(pts)
    t.upsert(pts)
    # overwrite row 3 with row 0's direction, and a duplicate id in one batch
    again = [("p3", pts[0][1], {"i": "new"}), ("x", pts[5][1], {}),
             ("x", pts[6][1], {"dup": 1})]
    j.upsert(again)
    t.upsert(again)
    q = np.asarray(pts[0][1])
    assert _hits(j.search(q, 5))[:2] == _hits(t.search(q, 5))[:2]
    assert t.count() == j.count() == 21
    # "x" and "p6" now share a vector: the tie goes to the lower row, p6
    q6 = np.asarray(pts[6][1])
    assert _hits(t.search(q6, 2)) == _hits(j.search(q6, 2))
    assert [h.payload for h in t.search(q6, 2)] == [{"i": 6}, {"dup": 1}]
    with pytest.raises(ValueError):
        t.upsert([("bad", [1.0, 2.0], {})])
    with pytest.raises(ValueError):
        t.search(np.zeros(DIM + 1), 3)


def test_all_ties_resolve_by_row_index():
    # every row identical → every score ties; lax.top_k orders ties by the
    # lower index and torch.topk promises no order: the port sorts stably
    base = np.zeros((96, DIM), np.float32)
    base[:, 0] = 1.0
    ids = [f"t{i:03d}" for i in range(96)]
    j, t = _stores(shard_capacity=32)
    j.upsert_rows(ids, base, [{} for _ in ids])
    t.upsert_rows(ids, base, [{} for _ in ids])
    q = np.zeros(DIM, np.float32)
    q[0] = 1.0
    assert [h.id for h in t.search(q, 10)] == [h.id for h in j.search(q, 10)] == ids[:10]


def test_cosine_topk_ties_and_invalid_rows():
    corpus = torch.zeros(8, 4)
    corpus[:, 0] = 1.0
    corpus[5] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    s, i = cosine_topk(corpus, torch.tensor([1.0, 0.0, 0.0, 0.0]), n_valid=6, k=8)
    assert i.tolist()[:5] == [0, 1, 2, 3, 4]
    assert i.tolist()[5] == 5 and s[5] == 0.0
    assert torch.isneginf(s[6:]).all() and s.dtype == torch.float32


def test_wal_reload_and_cross_format(tmp_path):
    j, t = _stores(tmp_path, shard_capacity=16)
    vecs = _rows(2, 12)
    ids = [f"w{i}" for i in range(12)]
    t.upsert_rows(ids, vecs, [{"i": i} for i in range(12)])
    j.upsert_rows(ids, vecs, [{"i": i} for i in range(12)])
    q = _rows(3, 1)[0]
    want = _hits(t.search(q, 5))
    again = VectorStore(VectorStoreConfig(dim=DIM, data_dir=str(tmp_path / "torch"),
                                          shard_capacity=16), device="cpu")
    assert again.count() == 12 and _hits(again.search(q, 5)) == want
    # the two stores write the same WAL format, so each reads the other's
    wal = "symbiont_document_embeddings.wal.jsonl"
    jrec = [json.loads(x) for x in (tmp_path / "jax" / wal).read_text().splitlines()]
    trec = [json.loads(x) for x in (tmp_path / "torch" / wal).read_text().splitlines()]
    assert jrec == trec
    from_jax = VectorStore(VectorStoreConfig(dim=DIM, data_dir=str(tmp_path / "jax"),
                                             shard_capacity=16), device="cpu")
    assert [h.id for h in from_jax.search(q, 5)] == [h[0] for h in want]


def test_compact_snapshot_then_wal_tail(tmp_path):
    _, t = _stores(tmp_path, shard_capacity=16)
    vecs = _rows(4, 10)
    t.upsert_rows([f"c{i}" for i in range(6)], vecs[:6])
    t.compact()
    t.upsert_rows([f"c{i}" for i in range(6, 10)], vecs[6:])
    root = tmp_path / "torch"
    assert (root / "symbiont_document_embeddings.vectors.npy").exists()
    again = VectorStore(VectorStoreConfig(dim=DIM, data_dir=str(root),
                                          shard_capacity=16), device="cpu")
    assert again.count() == 10
    assert again.search(vecs[8], 1)[0].id == "c8"
    # a corrupt WAL line is skipped and counted, not fatal
    with open(root / "symbiont_document_embeddings.wal.jsonl", "a") as f:
        f.write("{not json\n")
    again2 = VectorStore(VectorStoreConfig(dim=DIM, data_dir=str(root),
                                           shard_capacity=16), device="cpu")
    assert again2.count() == 10 and again2.last_load_skipped_lines == 1


def test_capacity_blocks_and_device_corpus():
    _, t = _stores(shard_capacity=16)
    t.upsert_rows([f"r{i}" for i in range(20)], _rows(5, 20))
    t.search(_rows(6, 1)[0], 3)
    corpus = t._device_corpus
    assert corpus.shape == (32, DIM) and corpus.dtype == torch.bfloat16
    assert t._capacity(0) == 16 and t._capacity(33) == 48


def test_search_fused_matches_split_and_jax_store(tmp_path):
    # the port's fused path (engine embed + cosine top-k in one call) and
    # its split path agree, and match the JAX store's split search
    from symbiont_tpu_torch.config import EngineConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine

    eng = TorchEngine(EngineConfig(embedding_dim=DIM, length_buckets=[8, 16],
                                   batch_buckets=[2, 4], max_batch=4,
                                   dtype="float32"), device="cpu")
    j, t = _stores(tmp_path, shard_capacity=64)
    texts = [f"sentence number {i} about topic {i % 5}" for i in range(20)]
    vecs = eng.embed_texts(texts)
    for s in (j, t):
        s.upsert([(f"p{i}", vecs[i], {"sentence_text": texts[i]}) for i in range(20)])
    q = eng.embed_query("topic 3")
    split, fused, ref = t.search(q, 5), t.search_fused(eng, "topic 3", 5), j.search(q, 5)
    assert [h.id for h in fused] == [h.id for h in split] == [h.id for h in ref]
    for a, b in zip(fused, split):
        assert abs(a.score - b.score) < 1e-2 and a.payload == b.payload
    empty = VectorStore(VectorStoreConfig(dim=DIM, data_dir=""), device="cpu")
    assert empty.search_fused(eng, "anything", 5) == []
