"""Optional external-Qdrant backend for the vector-memory surface.

Copy of the JAX package's `symbiont_tpu/memory/qdrant_backend.py`;
`make_vector_store` places the embedded store on a device and, where one
is given, a mesh.

The framework's default store is the embedded device-resident one
(memory/vector_store.py — exact cosine on the engine's device).
Deployments migrating from the reference, which runs a real Qdrant (reference:
docker-compose.yml:16-25; services/vector_memory_service/src/main.rs), can
keep it: set `vector_store.uri` (or the reference's `QDRANT_URI` env alias)
to the Qdrant HTTP endpoint and the runner swaps this adapter in. Same
collection layout as the reference — named collection, configured dim,
cosine distance (main.rs:20-22,34-42) — so an existing reference Qdrant
volume is readable as-is.

Speaks Qdrant's REST API via stdlib urllib (no qdrant-client dependency):
- PUT  /collections/{name}                 ensure (dim, cosine)
- PUT  /collections/{name}/points?wait=true upsert (the reference's
  wait=true durability stance, main.rs:196)
- POST /collections/{name}/points/search   top-k, payload on, vectors off
  (main.rs:261-286)
- POST /collections/{name}/points/count    exact count

No fused embed+top-k here (the corpus lives in Qdrant, not device memory) —
`supports_fused = False`, so the engine plane serves only the 2-hop path
and the gateway's fused probe falls back exactly as in any non-co-located
deployment.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple

from symbiont_tpu_torch.config import VectorStoreConfig
from symbiont_tpu_torch.memory.vector_store import SearchHit
from symbiont_tpu_torch.utils.retry import connect_retry

log = logging.getLogger(__name__)


class QdrantStore:
    """Vector-memory surface (ensure_collection/upsert/search/count) over a
    remote Qdrant. Connect-retry at startup mirrors the reference's 5×5s
    (reference: vector_memory_service/src/main.rs:505-532)."""

    supports_fused = False

    def __init__(self, config: VectorStoreConfig,
                 retries: int = 5, retry_delay_s: float = 5.0):
        if not config.uri:
            raise ValueError("QdrantStore requires vector_store.uri")
        if not config.uri.startswith(("http://", "https://")):
            raise ValueError(
                f"vector_store.uri must be the Qdrant REST endpoint "
                f"(http://host:6333), got {config.uri!r}")
        self.config = config
        self.base = config.uri.rstrip("/")
        self.collection = config.collection
        self.dim = config.dim
        self._retries = retries
        self._retry_delay_s = retry_delay_s

    # ------------------------------------------------------------------ http

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              timeout: float = 20.0) -> dict:
        req = urllib.request.Request(
            f"{self.base}{path}",
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"}, method=method)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"{}")

    # --------------------------------------------------------------- surface

    def ensure_collection(self, dim: Optional[int] = None) -> None:
        if dim is not None:
            self.dim = dim
        body = {"vectors": {"size": self.dim, "distance": "Cosine"},
                "on_disk_payload": True}

        def attempt() -> None:
            try:
                self._call("PUT", f"/collections/{self.collection}", body)
            except urllib.error.HTTPError as e:
                if e.code != 409:  # 409 = already exists
                    raise
                # existing collection: verify its dim matches instead of
                # failing later on every upsert (the embedded store's
                # fail-fast stance)
                info = self._call("GET", f"/collections/{self.collection}")
                have = (info.get("result", {}).get("config", {})
                        .get("params", {}).get("vectors", {}).get("size"))
                if have is not None and int(have) != self.dim:
                    raise ValueError(
                        f"collection {self.collection!r} exists with "
                        f"dim={have}, engine produces dim={self.dim}")
            log.info("qdrant collection %r ready (dim=%d, cosine)",
                     self.collection, self.dim)

        # dim mismatch is a config error, not a connectivity one — no retry
        connect_retry(attempt, retries=self._retries,
                      delay_s=self._retry_delay_s,
                      what=f"qdrant at {self.base}", fatal=(ValueError,))

    # Real Qdrant caps the JSON request body (32MB default); a 768-dim f32
    # point is ~10KB as JSON text, so bulk upserts must chunk. 512 points ≈
    # 5MB per request — safely under the cap with headroom for payloads.
    UPSERT_CHUNK = 512

    def upsert(self, points: Sequence[Tuple[str, Sequence[float], dict]]) -> int:
        """Chunked wait=true upsert. NOT atomic across chunks: a hard failure
        on chunk i>0 raises after earlier chunks committed (the raised
        HTTPError/URLError carries `.points_committed` with how many points
        landed). Safe to retry the WHOLE call: point ids are deterministic,
        so re-upserting committed chunks is idempotent overwriting."""
        if not points:
            return 0
        for i in range(0, len(points), self.UPSERT_CHUNK):
            chunk = points[i:i + self.UPSERT_CHUNK]
            body = {"points": [{"id": pid, "vector": [float(x) for x in vec],
                                "payload": payload}
                               for pid, vec, payload in chunk]}
            try:
                self._call("PUT",
                           f"/collections/{self.collection}/points?wait=true",
                           body)
            except Exception as e:
                e.points_committed = i  # partial-commit marker for callers
                raise
        return len(points)

    def search(self, query: Sequence[float], top_k: int) -> List[SearchHit]:
        if top_k <= 0:
            return []
        body = {"vector": [float(x) for x in query], "limit": int(top_k),
                "with_payload": True, "with_vector": False}
        out = self._call("POST",
                         f"/collections/{self.collection}/points/search", body)
        return [SearchHit(id=str(h["id"]), score=float(h["score"]),
                          payload=h.get("payload") or {})
                for h in out.get("result", [])]

    def count(self) -> int:
        out = self._call("POST",
                         f"/collections/{self.collection}/points/count",
                         {"exact": True})
        return int(out.get("result", {}).get("count", 0))


def make_vector_store(config: VectorStoreConfig, device=None, resilience=None, mesh=None):
    """Backend selection: uri set → external Qdrant; else the embedded
    store on `device` (the engine's; the default and the fast path).

    With a ResilienceConfig (and breakers enabled), the EXTERNAL backend is
    wrapped in a circuit breaker + WAL spill (resilience/stores.py): a
    mid-run Qdrant outage degrades to local spooling instead of turning
    every embedding into a dropped write. The embedded store needs no
    breaker — its failure domain is the process itself."""
    if config.uri:
        store = QdrantStore(config)
        if resilience is not None and resilience.breaker_enabled:
            from pathlib import Path

            from symbiont_tpu_torch.resilience.breaker import CircuitBreaker
            from symbiont_tpu_torch.resilience.stores import ResilientVectorStore

            return ResilientVectorStore(
                store,
                breaker=CircuitBreaker(
                    "vector_store",
                    failure_threshold=resilience.breaker_failure_threshold,
                    reset_timeout_s=resilience.breaker_reset_timeout_s),
                spill_path=str(Path(resilience.spill_dir)
                               / f"{config.collection}.spill.jsonl"))
        return store
    from symbiont_tpu_torch.memory.vector_store import VectorStore

    return VectorStore(config, device=device, mesh=mesh)
