"""Vector store with a CUDA-resident corpus: exact cosine top-k as one
bf16 matrix-vector product.

A copy of `symbiont_tpu/memory/vector_store.py` (same WAL, snapshot, ids and
payloads, same search semantics) whose device side is PyTorch: the corpus
is a bf16 tensor on the store's device, padded to `_capacity` rows, and a
search is `corpus @ query` on bf16 operands with float32 scores, invalid
rows at -inf, then a top-k whose ties go to the lower row index — what `lax.top_k`
does in the JAX store. `torch.topk` promises no order among equal scores,
so the top-k here is a stable descending sort (`cosine_topk`), shared with
the engine's fused query search. The mesh-sharded corpus of the JAX store
is not ported (ROADMAP Queue A: multi-device).

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
from symbiont_tpu_torch.models.quant import tensor_bytes
from symbiont_tpu_torch.obs.hbm import hbm_ledger

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
                 device=None):
        self.config = config or VectorStoreConfig()
        self.device = resolve_device(device)
        self.dim = self.config.dim
        self._lock = threading.RLock()
        self._ids: List[str] = []
        self._id_to_row: Dict[str, int] = {}
        self._payloads: List[dict] = []
        self._vectors = np.zeros((0, self.dim), np.float32)  # L2-normalized rows
        self._device_corpus = None  # padded [capacity, D] bf16 on device
        self._device_rows = 0  # rows valid in the device copy
        self._dirty = True
        self._wal_file = None
        self.last_load_skipped_lines = 0  # corrupt WAL lines on last load()
        # the device-memory ledger (obs/hbm.py): the padded device corpus's
        # bytes, read from the tensor's size (no device sync)
        hbm_ledger.claim("memory.corpus", self,
                         lambda vs: (0 if vs._device_corpus is None
                                     else tensor_bytes(vs._device_corpus)))
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
        """Static capacity: next multiple of shard_capacity — keeps the
        device corpus shape stable across growth."""
        block = self.config.shard_capacity
        return max(block, ((n + block - 1) // block) * block)

    def _sync_device(self) -> None:
        n = len(self._ids)
        if self._device_corpus is not None and not self._dirty and self._device_rows == n:
            return
        cap = self._capacity(n)
        padded = torch.zeros((cap, self.dim), dtype=torch.bfloat16,
                             device=self.device)
        if n:
            padded[:n] = torch.from_numpy(self._vectors).to(self.device)
        self._device_corpus = padded
        self._device_rows = n
        self._dirty = False

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

        The device call runs OUTSIDE the store lock: every sync builds a new
        corpus tensor, so a snapshot of (corpus, n) taken under the lock
        stays valid, and concurrent ingest/search callers never stall
        behind a search."""
        with self._lock:
            n = len(self._ids)
            if n == 0 or top_k <= 0:
                return []
            self._sync_device()
            corpus = self._device_corpus
            cap = corpus.shape[0]
            q = np.asarray(query, np.float32)
            if q.shape != (self.dim,):
                raise ValueError(f"query dim {q.shape} != collection dim {self.dim}")
            k = min(top_k, cap)
        qn = float(np.linalg.norm(q))
        q = q / qn if qn > 0 else q
        scores, idx = cosine_topk(corpus, torch.from_numpy(q).to(self.device),
                                  n, k)
        with self._lock:
            return self._hits_from(scores.cpu(), idx.cpu(), top_k)

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
            k = min(top_k, corpus.shape[0])
        # device call outside the lock — see search() for why the snapshot
        # stays valid
        scores, idx = engine.embed_and_search(text, corpus, n, k)
        with self._lock:
            return self._hits_from(scores, idx, top_k)

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
