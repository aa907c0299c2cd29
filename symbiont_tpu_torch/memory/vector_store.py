"""Vector store with a CUDA-resident corpus: exact cosine top-k as one
bf16 matrix-vector product.

A copy of `symbiont_tpu/memory/vector_store.py` (same WAL, snapshot, ids and
payloads, same search semantics) whose device side is PyTorch: the corpus
is a bf16 tensor on the store's device, padded to `_capacity` rows, and a
search is `corpus @ query` on bf16 operands with float32 scores, invalid
rows at -inf, then a top-k whose ties go to the lower row index — what `lax.top_k`
does in the JAX store. `torch.topk` promises no order among equal scores,
so the top-k here is a stable descending sort (`cosine_topk`), shared with
the engine's fused query search. With a `mesh` whose 'data' axis is > 1
the capacity rounds to a multiple of the axis and the corpus is row-split
over it (a `parallel.sharding.Sharded`, one block a data entry), searched
per shard on each shard's device and merged (`corpus_topk`), with hits
identical to one device's, as the JAX store's sharded corpus is.

Over a mesh that spans processes (A15 multi-host) every process holds the
same host rows, because every process makes the same upserts in the same
order (JAX's `device_put` of the host corpus assumes the same), and places
only its own row blocks. A search runs each local shard's executable, and
`corpus_topk` all-gathers the candidates over the data line's group, so
`search` and `search_fused` return the same hits in every process.

The device corpus is one buffer per capacity: a sync writes the rows into
it in place, and a new buffer replaces it only when upserts cross a
capacity block (or the collection's dim changes). So the store's search
executables and the engine's fused `qsearch` ones (CUDA graphs on the
card, `graphs.py`) read one address for as long as the capacity
holds, with the row count as a device scalar among their inputs. `k` is
bucketed by `_k_static`, as in JAX, so a store has one search executable
per (capacity, k bucket); `warm_fused` builds the engine's fused ones for
the current capacity and `fused_warm_stale` says when a block was crossed.

API parity with the reference's Qdrant adapter:
- ensure_collection (dim + cosine at startup):
  reference vector_memory_service/src/main.rs:24-119
- upsert(points with uuid ids + QdrantPointPayload-shaped payloads), ack after
  durable: main.rs:121-228 (wait=true at :196)
- search(query, top_k) → hits with id, score, payload: main.rs:230-456

Durability: append-only JSONL WAL + optional compacted .npy snapshot;
load() replays snapshot + WAL tail (SURVEY.md §5.4: DB-as-truth stance kept,
now inside the framework).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from symbiont_tpu_torch.config import VectorStoreConfig
from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.graphs import Executable, GraphPool, pool_for
from symbiont_tpu_torch.models.quant import tensor_bytes
from symbiont_tpu_torch.obs.hbm import hbm_ledger
from symbiont_tpu_torch.parallel.mesh import axis_size, mesh_device
from symbiont_tpu_torch.parallel.sharding import (
    Sharded,
    batch_sharding,
    corpus_topk,
    device_put,
    search_line,
    shard_topk,
)

log = logging.getLogger(__name__)


def cosine_topk(corpus: torch.Tensor, query: torch.Tensor, n_valid: int,
                k: int):
    """Scores of every corpus row against `query` (both L2-normalized, so
    the dot product is the cosine): bf16 operands, float32 products and
    sums — the JAX store's `(bf16 @ bf16).astype(f32)` comes out unrounded
    to bf16, as XLA folds the cast into the product. Rows at or past
    `n_valid` score -inf. Returns the top `k` as (scores f32 [k], row
    indices [k]), equal scores in row order."""
    scores = (corpus.to(torch.bfloat16).float()
              @ query.to(torch.bfloat16).float())
    # n_valid may be a host int or a device scalar (an executable's input)
    valid = torch.arange(corpus.shape[0], device=corpus.device) < n_valid
    scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]


@dataclass
class SearchHit:
    id: str
    score: float
    payload: dict


class VectorStore:
    supports_fused = True  # corpus is device-resident → fused embed+top-k

    def __init__(self, config: Optional[VectorStoreConfig] = None,
                 device=None, mesh=None):
        self.config = config or VectorStoreConfig()
        self.mesh = mesh
        # a store over a real mesh answers on the mesh's lead entry
        self.device = resolve_device(mesh_device(mesh, device) if mesh is not None
                                     and mesh.size > 1 else device)
        self.dim = self.config.dim
        self._lock = threading.RLock()
        self._ids: List[str] = []
        self._id_to_row: Dict[str, int] = {}
        self._payloads: List[dict] = []
        self._vectors = np.zeros((0, self.dim), np.float32)  # L2-normalized rows
        self._device_corpus = None  # padded [capacity, D] bf16 on device
        self._device_rows = 0  # rows valid in the device copy
        self._dirty = True
        self._search_fns: Dict[tuple, Executable] = {}
        self._replay_lock = threading.Lock()  # the search graphs' replays
        self._graph_pool = GraphPool() if self.device.type == "cuda" else None
        self._graph_pools = {self.device: self._graph_pool}  # one a device
        self._warmed_capacity: Optional[int] = None  # capacity warm_fused built for
        self._wal_file = None
        self.last_load_skipped_lines = 0  # corrupt WAL lines on last load()
        # the device-memory ledger (obs/hbm.py): the padded device corpus's
        # bytes, read from the tensor's size (no device sync)
        hbm_ledger.claim("memory.corpus", self,
                         lambda vs: (0 if vs._device_corpus is None
                                     else tensor_bytes(vs._device_corpus)))
        if self._graph_pool is not None:
            hbm_ledger.claim("memory.search_graphs", self,
                             lambda vs: sum(p.nbytes() for p in list(vs._graph_pools.values())))
        if self.config.data_dir:
            Path(self.config.data_dir).mkdir(parents=True, exist_ok=True)
            self.load()

    # ------------------------------------------------------------ lifecycle

    def ensure_collection(self, dim: Optional[int] = None) -> None:
        """Validate/establish the collection config (reference: main.rs:24-119).

        Like Qdrant's ensure path this is idempotent; a dim mismatch with
        existing data is an error rather than silent re-create."""
        dim = dim or self.config.dim
        with self._lock:
            if len(self._ids) and dim != self.dim:
                raise ValueError(
                    f"collection '{self.config.collection}' already has dim "
                    f"{self.dim}, requested {dim}")
            self.dim = dim
            if self._vectors.shape[1] != dim:
                self._vectors = np.zeros((0, dim), np.float32)

    def count(self) -> int:
        with self._lock:
            return len(self._ids)

    # -------------------------------------------------------------- upsert

    def upsert(self, points: Sequence[Tuple[str, Sequence[float], dict]]) -> int:
        """Insert or overwrite points; ack only after the WAL write+flush
        (the reference's wait=true durability, main.rs:196). Returns count.

        Normalization is one vectorized pass over the whole batch — the
        per-point numpy calls (asarray + norm per row) were ~1 s of CPU per
        3k-point ingest wave on the one-core host (measured r5)."""
        if not points:
            return 0
        with self._lock:
            try:
                batch = np.asarray([vec for _, vec, _ in points], np.float32)
            except (ValueError, TypeError):
                batch = None  # ragged input: report the offending row below
            if batch is None or batch.ndim != 2 or batch.shape[1] != self.dim:
                for _, vec, _ in points:
                    v = np.asarray(vec, np.float32)
                    if v.shape != (self.dim,):
                        raise ValueError(
                            f"vector dim {v.shape} != collection dim {self.dim}")
                raise ValueError(f"vectors must be [n, {self.dim}]")
            return self._ingest_locked([p[0] for p in points], batch,
                                       [p[2] for p in points])

    def upsert_rows(self, ids: Sequence[str], rows,
                    payloads: Optional[Sequence[dict]] = None) -> int:
        """Tensor-frame fast path: ingest an already-packed [n, dim] float
        block (typically a read-only `np.frombuffer` view straight off the
        bus — schema/frames) without ever materializing per-float Python
        objects. Same semantics and WAL durability as upsert().

        Non-f32 rows (the half-width f16 wire form, or bf16 engine output)
        are upcast to f32 here — the store's in-memory matrix, WAL, and
        search math stay f32 regardless of what dtype rode the bus."""
        ids = list(ids)
        if not ids:
            return 0
        rows = np.asarray(rows, np.float32)  # upcasts f16/f64 views in C
        if rows.ndim != 2 or rows.shape[0] != len(ids):
            raise ValueError(
                f"rows shape {rows.shape} does not match {len(ids)} ids")
        if rows.shape[1] != self.dim:
            raise ValueError(
                f"vector dim ({rows.shape[1]},) != collection dim {self.dim}")
        payloads = ([{}] * len(ids) if payloads is None else list(payloads))
        if len(payloads) != len(ids):
            # zip would silently truncate and drop points
            raise ValueError(f"{len(payloads)} payloads for {len(ids)} ids")
        with self._lock:
            return self._ingest_locked(ids, rows, payloads)

    def _ingest_locked(self, ids: List[str], batch: np.ndarray,
                       payloads: List[dict]) -> int:
        """Shared ingest tail (caller holds the lock, batch is validated
        [n, dim] f32 — possibly a read-only view; the WAL records the RAW
        vectors, normalization happens on the in-memory copy only)."""
        norms = np.linalg.norm(batch, axis=1, keepdims=True)
        normed = np.divide(batch, norms, out=batch.astype(np.float32,
                                                          copy=True),
                           where=norms > 0)
        rows = []
        new_pos: Dict[str, int] = {}  # ids first seen in THIS call — a
        # duplicate id within one batch (e.g. WAL replay of an update)
        # must overwrite, not append twice
        for j, (pid, payload) in enumerate(zip(ids, payloads)):
            if pid in self._id_to_row:
                r = self._id_to_row[pid]
                self._vectors[r] = normed[j]
                self._payloads[r] = dict(payload)
                self._dirty = True
            elif pid in new_pos:
                rows[new_pos[pid]] = (pid, j, dict(payload))
            else:
                new_pos[pid] = len(rows)
                rows.append((pid, j, dict(payload)))
        if rows:
            new_vecs = normed[[j for _, j, _ in rows]]
            base = len(self._ids)
            self._vectors = (np.concatenate([self._vectors, new_vecs])
                             if len(self._vectors) else new_vecs)
            for i, (pid, _, payload) in enumerate(rows):
                self._ids.append(pid)
                self._id_to_row[pid] = base + i
                self._payloads.append(payload)
            self._dirty = True
        self._wal_append(list(zip(ids, batch, payloads)))
        return len(ids)

    # -------------------------------------------------------------- search

    def _capacity(self, n: int) -> int:
        """Static capacity: next multiple of shard_capacity (and of the data
        axis size under a mesh) — keeps the device corpus shape stable
        across growth."""
        block = self.config.shard_capacity
        cap = max(block, ((n + block - 1) // block) * block)
        if self.mesh is not None:
            nd = axis_size(self.mesh, "data")
            cap = ((cap + nd - 1) // nd) * nd
        return cap

    def _sharded(self) -> bool:
        """Corpus rows live split over the mesh's 'data' axis."""
        return axis_size(self.mesh, "data") > 1

    def _sync_device(self) -> None:
        """The rows into the device buffer of the current capacity, in
        place; a new zeroed buffer only when the capacity (or the dim)
        changed. Copies run on the current stream, so a search enqueued
        before the sync reads the rows as they were and one enqueued after
        reads them as written."""
        n = len(self._ids)
        if self._device_corpus is not None and not self._dirty and self._device_rows == n:
            return
        cap = self._capacity(n)
        if self._device_corpus is None or tuple(self._device_corpus.shape) != (cap, self.dim):
            zeros = torch.zeros((cap, self.dim), dtype=torch.bfloat16, device=self.device)
            self._device_corpus = (device_put(zeros, batch_sharding(self.mesh))
                                   if self._sharded() else zeros)
            self._search_fns.clear()  # bound to the old buffer
        if n and isinstance(self._device_corpus, Sharded):
            # every entry's block of rows, written into its own shard
            corpus = self._device_corpus
            rows = cap // axis_size(self.mesh, "data")
            for i, shard in enumerate(corpus.shards):
                if shard is None:  # another process's entry
                    continue
                lo = self.mesh.coords(i)["data"] * rows
                if lo < n:
                    shard[:min(n, lo + rows) - lo] = torch.from_numpy(
                        self._vectors[lo:lo + rows]).to(shard.device)
        elif n:
            self._device_corpus[:n] = torch.from_numpy(self._vectors).to(self.device)
        self._device_rows = n
        self._dirty = False

    def _get_search_fn(self, cap: int, k: int) -> Executable:
        """The search executable of (capacity, k bucket) on the current
        buffer: the query [D] and the row count in, (scores, rows) out."""
        key = (cap, k)
        exe = self._search_fns.get(key)
        if exe is None and isinstance(self._device_corpus, Sharded):
            exe = self._search_fns[key] = self._sharded_search(cap, k)
        elif exe is None:
            corpus = self._device_corpus

            def fn(query, n_valid):
                return cosine_topk(corpus, query, n_valid, k)

            exe = self._search_fns[key] = Executable(
                fn, self.device, pool=self._graph_pool,
                signature=f"memory.search[N={cap},k={k}]")
        return exe

    def _sharded_search(self, cap: int, k: int):
        """The search of a row-split corpus (`parallel/sharding.corpus_topk`):
        each data entry's shard this process holds searched by an
        executable on its device (its top-k with global row ids), the
        candidates merged on the lead (all-gathered first where the data
        line crosses processes); called as a search executable is."""
        corpus, mesh = self._device_corpus, self.mesh
        rows = cap // axis_size(mesh, "data")
        layout = search_line(mesh)
        line = layout[0]
        exes = {d: Executable(functools.partial(shard_topk, corpus.shards[e], base=d * rows,
                                                k=min(k, rows)),
                              mesh.device_list[e], pool=pool_for(self._graph_pools,
                                                                 mesh.device_list[e]),
                              signature=f"memory.search.shard[N={rows},k={k},shard={d}]")
                for d, e in enumerate(line) if mesh.is_local(e)}

        def search(query, n_valid, lock=None):
            return corpus_topk(mesh, corpus, query, n_valid, k, layout=layout,
                               local=lambda d: functools.partial(exes[d], lock=lock))

        return search

    def _k_static(self, top_k: int, n: int, cap: int) -> int:
        """Static k bucket (next power of two ≥ k, ≤ cap) bounds the
        executables, floored at 8 so every query with top_k ≤ 8 shares one
        per capacity, as in the JAX store; the caller trims the surplus."""
        k = 8
        while k < min(top_k, n):
            k *= 2
        return min(k, cap)

    def _hits_from(self, scores, idx, top_k: int) -> List[SearchHit]:
        hits = []
        for s, i in zip(np.asarray(scores)[:top_k], np.asarray(idx)[:top_k]):
            if not np.isfinite(s):
                continue
            hits.append(SearchHit(id=self._ids[i], score=float(s),
                                  payload=dict(self._payloads[i])))
        return hits

    def search(self, query: Sequence[float], top_k: int) -> List[SearchHit]:
        """Exact cosine top-k (reference search handler: main.rs:230-456).

        The device call runs OUTSIDE the store lock, on a snapshot of (the
        capacity's buffer, n) taken under it. Rows only append (an upsert
        overwrites its row in place), and a sync writes the buffer in place
        on the current stream, so the search reads, in stream order, the
        buffer as it was before or after a concurrent upsert's copy, and
        rows [0, n) are rows of the snapshot's ids either way. Concurrent
        ingest and search callers never stall behind a search."""
        with self._lock:
            n = len(self._ids)
            if n == 0 or top_k <= 0:
                return []
            self._sync_device()
            cap = self._device_corpus.shape[0]
            q = np.asarray(query, np.float32)
            if q.shape != (self.dim,):
                raise ValueError(f"query dim {q.shape} != collection dim {self.dim}")
            fn = self._get_search_fn(cap, self._k_static(top_k, n, cap))
        qn = float(np.linalg.norm(q))
        q = q / qn if qn > 0 else q
        with torch.inference_mode():
            scores, idx = fn(torch.from_numpy(q), torch.tensor(n, dtype=torch.int64),
                             lock=self._replay_lock)
            scores, idx = scores.cpu(), idx.cpu()
        with self._lock:
            return self._hits_from(scores, idx, top_k)

    def search_fused(self, engine, text: str, top_k: int) -> List[SearchHit]:
        """Interactive-query fast path: hand the device-resident corpus to the
        engine's fused embed+top-k call (one host round-trip instead of
        embed then search). Same results as search(embed_query(text)) —
        asserted in tests."""
        with self._lock:
            n = len(self._ids)
            if n == 0 or top_k <= 0:
                return []
            self._sync_device()
            corpus = self._device_corpus
            k = self._k_static(top_k, n, corpus.shape[0])
            search = self._fused_search(k)
        # device call outside the lock — see search() for why the snapshot
        # stays valid
        scores, idx = engine.embed_and_search(text, corpus, n, k, search=search)
        with self._lock:
            return self._hits_from(scores, idx, top_k)

    def _fused_search(self, k: int):
        """What a fused query searches a row-split corpus with: this
        store's per-shard search executables, under its replay lock (None
        for a corpus on one device, which the engine's program scores)."""
        if not isinstance(self._device_corpus, Sharded):
            return None
        return functools.partial(self._get_search_fn(self._device_corpus.shape[0], k),
                                 lock=self._replay_lock)

    def warm_fused(self, engine, word_counts: Sequence[int] = (3, 40, 150),
                   top_ks: Optional[Sequence[int]] = None) -> None:
        """Build the engine's fused embed+top-k executables (CUDA graphs on
        the card) for the store's current capacity across the query length
        buckets, an empty store included (its capacity is the first
        block), so the first fused query of each (length bucket, capacity)
        does not pay a capture inside the gateway's probe timeout. Warms
        every power-of-two k bucket up to config.warm_top_k and records the
        warmed capacity (`fused_warm_stale`)."""
        if top_ks is None:
            top_ks = [8]
            while top_ks[-1] < self.config.warm_top_k:
                top_ks.append(top_ks[-1] * 2)
        with self._lock:
            self._sync_device()
            corpus = self._device_corpus
            n = len(self._ids)
            ks = sorted({self._k_static(k, max(n, k), corpus.shape[0]) for k in top_ks})
            searches = {k: self._fused_search(k) for k in ks}
        for k in ks:
            for wc in word_counts:
                engine.embed_and_search("warm " * wc, corpus, n, k, search=searches[k])
        with self._lock:
            self._warmed_capacity = corpus.shape[0]

    def fused_warm_stale(self) -> bool:
        """True when upserts have crossed a capacity block since the last
        warm_fused: the next fused query would pay a fresh capture, so the
        owner should re-run warm_fused in the background."""
        with self._lock:
            return (self._warmed_capacity is not None
                    and self._capacity(len(self._ids)) != self._warmed_capacity)

    # --------------------------------------------------------- persistence

    def _wal_path(self) -> Optional[Path]:
        if not self.config.data_dir:
            return None
        return Path(self.config.data_dir) / f"{self.config.collection}.wal.jsonl"

    def _wal_append(self, points) -> None:
        path = self._wal_path()
        if path is None:
            return
        if self._wal_file is None:
            self._wal_file = open(path, "a", encoding="utf-8")
        # vectors ride as base64 f32 (internal durability format, not wire
        # schema): json-serializing 384 floats per point was the single
        # hottest CPU term of a bulk-ingest wave (measured r5). load()
        # accepts both this and the pre-r5 "vector" float-list records.
        import base64

        lines = []
        for pid, vec, payload in points:
            rec = {"id": pid,
                   "vector_b64": base64.b64encode(
                       np.asarray(vec, np.float32).tobytes()).decode("ascii"),
                   "payload": payload}
            lines.append(json.dumps(rec, ensure_ascii=False))
        self._wal_file.write("\n".join(lines) + "\n")
        self._wal_file.flush()
        os.fsync(self._wal_file.fileno())

    def compact(self) -> None:
        """Snapshot vectors+payloads, truncate the WAL."""
        if not self.config.data_dir:
            return
        with self._lock:
            root = Path(self.config.data_dir)
            np.save(root / f"{self.config.collection}.vectors.npy", self._vectors)
            meta = {"dim": self.dim, "ids": self._ids, "payloads": self._payloads}
            tmp = root / f"{self.config.collection}.meta.json.tmp"
            tmp.write_text(json.dumps(meta, ensure_ascii=False))
            tmp.replace(root / f"{self.config.collection}.meta.json")
            if self._wal_file is not None:
                self._wal_file.close()
                self._wal_file = None
            wal = self._wal_path()
            if wal and wal.exists():
                wal.unlink()

    def load(self) -> None:
        root = Path(self.config.data_dir)
        meta_p = root / f"{self.config.collection}.meta.json"
        with self._lock:
            if meta_p.exists():
                meta = json.loads(meta_p.read_text())
                self.dim = meta["dim"]
                self._ids = list(meta["ids"])
                self._payloads = list(meta["payloads"])
                self._vectors = np.load(root / f"{self.config.collection}.vectors.npy")
                self._id_to_row = {pid: i for i, pid in enumerate(self._ids)}
            wal = self._wal_path()
            skipped = 0
            if wal and wal.exists():
                replay: List[Tuple[str, list, dict]] = []
                with open(wal, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                            if "vector_b64" in rec:
                                import base64

                                vec = np.frombuffer(
                                    base64.b64decode(rec["vector_b64"]),
                                    dtype=np.float32)
                            else:  # pre-r5 float-list records
                                vec = rec["vector"]
                            replay.append((rec["id"], vec, rec["payload"]))
                        except (json.JSONDecodeError, KeyError, ValueError):
                            skipped += 1
                if skipped:
                    # a rollback to a pre-r5 build re-writes this WAL with
                    # float-list records; anything the OLD code cannot parse
                    # (e.g. the r5 vector_b64 format) is not "a corrupt
                    # line", it is DATA LOSS — make the count visible so the
                    # operator knows how many points vanished (compact()
                    # BEFORE rolling back, see docs/DEPLOYMENT.md)
                    log.warning(
                        "%s: skipped %d corrupt/unreadable WAL line(s) — "
                        "these points are NOT loaded; if this follows a "
                        "version rollback, the WAL format changed and the "
                        "skipped records are lost unless re-ingested "
                        "(run compact() before rolling back)",
                        wal, skipped)
                if replay:
                    # replay through upsert minus re-logging
                    wal_file, self._wal_file = self._wal_file, None
                    data_dir, self.config.data_dir = self.config.data_dir, ""
                    try:
                        self.upsert(replay)
                    finally:
                        self.config.data_dir = data_dir
                        self._wal_file = wal_file
            self.last_load_skipped_lines = skipped
            self._dirty = True
