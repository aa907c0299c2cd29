"""Optional external-Neo4j backend for the knowledge-graph surface.

Copy of the JAX package's `symbiont_tpu/graph/neo4j_backend.py`.

The framework's default graph store is the embedded sqlite one
(graph/store.py). Deployments migrating from the reference, which writes to
a real Neo4j over Bolt (reference: docker-compose.yml:2-14;
services/knowledge_graph_service/src/main.rs), can keep their graph: set
`graph_store.uri` (or the reference's NEO4J_URI/USER/PASSWORD env aliases)
to the Neo4j **HTTP API** endpoint (http://host:7474) and the runner swaps
this adapter in.

Write parity with the reference's save_to_neo4j (main.rs:23-140), issued as
ONE transactional HTTP request (`/db/{db}/tx/commit`) to match its
single-explicit-transaction behavior (main.rs:32-134):

- MERGE (d:Document {original_id}) ON CREATE/ON MATCH SET source_url,
  processed_at_ms (main.rs:37-63);
- per non-empty sentence: MERGE (s:Sentence {text}), MERGE
  (d)-[:HAS_SENTENCE {order}]->(s) (main.rs:70-93);
- per non-empty token: MERGE (t:Token {text_lc}), SET
  text_original_case, MERGE (d)-[:CONTAINS_TOKEN]->(t) (main.rs:100-125);
- ensure_schema creates the unique constraint + text_lc index with the
  reference's 5×3s retry (main.rs:158-173,253-284).

Speaks stdlib urllib with basic auth — no neo4j driver dependency.
"""

from __future__ import annotations

import base64
import json
import logging
import urllib.request
from typing import Dict, List, Tuple

from symbiont_tpu_torch.config import GraphStoreConfig
from symbiont_tpu_torch.schema import TokenizedTextMessage
from symbiont_tpu_torch.utils.retry import connect_retry

log = logging.getLogger(__name__)


class Neo4jGraphStore:
    def __init__(self, config: GraphStoreConfig,
                 retries: int = 5, retry_delay_s: float = 3.0):
        if not config.uri:
            raise ValueError("Neo4jGraphStore requires graph_store.uri")
        if not config.uri.startswith(("http://", "https://")):
            # the reference's compose uses bolt://host:7687; this adapter
            # speaks the HTTP API — fail fast with the fix, not a retry loop
            raise ValueError(
                f"graph_store.uri must be the Neo4j HTTP endpoint "
                f"(http://host:7474), not {config.uri!r} — the bolt:// "
                f"protocol is not supported")
        self.config = config
        self.base = config.uri.rstrip("/")
        self._auth = base64.b64encode(
            f"{config.user}:{config.password}".encode()).decode()
        self._retries = retries
        self._retry_delay_s = retry_delay_s

    # ------------------------------------------------------------------ http

    def _commit(self, statements: List[Tuple[str, dict]],
                timeout: float = 30.0) -> List[dict]:
        body = {"statements": [{"statement": s, "parameters": p}
                               for s, p in statements]}
        req = urllib.request.Request(
            f"{self.base}/db/{self.config.database}/tx/commit",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Basic {self._auth}"},
            method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = json.loads(r.read())
        if out.get("errors"):
            raise RuntimeError(f"neo4j error: {out['errors']}")
        return out.get("results", [])

    # --------------------------------------------------------------- surface

    def ensure_schema(self) -> None:
        """Unique Document.original_id + Token.text_lc index, retried
        (reference: ensure_schema_internal + retry task, main.rs:158-173,
        253-284)."""
        stmts = [
            ("CREATE CONSTRAINT symbiont_doc_id IF NOT EXISTS "
             "FOR (d:Document) REQUIRE d.original_id IS UNIQUE", {}),
            ("CREATE INDEX symbiont_token_lc IF NOT EXISTS "
             "FOR (t:Token) ON (t.text_lc)", {}),
        ]

        def attempt() -> None:
            for s in stmts:
                self._commit([s])
            log.info("neo4j schema ensured at %s", self.base)

        connect_retry(attempt, retries=self._retries,
                      delay_s=self._retry_delay_s,
                      what=f"neo4j at {self.base}")

    def save_tokenized(self, msg: TokenizedTextMessage) -> int:
        """One transactional commit per document (main.rs:32-134). Returns
        the Document node's internal id."""
        stmts: List[Tuple[str, dict]] = [(
            "MERGE (d:Document {original_id: $original_id}) "
            "ON CREATE SET d.source_url = $source_url, "
            "d.processed_at_ms = $ts "
            "ON MATCH SET d.source_url = $source_url, "
            "d.processed_at_ms = $ts "
            "RETURN id(d)",
            {"original_id": msg.original_id, "source_url": msg.source_url,
             "ts": msg.timestamp_ms})]
        for order, sentence in enumerate(msg.sentences):
            if not sentence.strip():
                continue  # reference: main.rs:71-77
            stmts.append((
                # order inside the MERGE pattern (reference main.rs:82-88):
                # the same sentence text at two positions keeps two edges
                "MATCH (d:Document {original_id: $original_id}) "
                "MERGE (s:Sentence {text: $text}) "
                "MERGE (d)-[r:HAS_SENTENCE {order: $order}]->(s)",
                {"original_id": msg.original_id, "text": sentence,
                 "order": order}))
        for token in msg.tokens:
            token = token.strip()
            if not token:
                continue  # reference: main.rs:103-109
            stmts.append((
                "MATCH (d:Document {original_id: $original_id}) "
                "MERGE (t:Token {text_lc: $lc}) "
                "SET t.text_original_case = $orig "
                "MERGE (d)-[:CONTAINS_TOKEN]->(t)",
                {"original_id": msg.original_id, "lc": token.lower(),
                 "orig": token}))
        results = self._commit(stmts)
        try:
            return int(results[0]["data"][0]["row"][0])
        except (IndexError, KeyError, TypeError, ValueError):
            return -1

    def counts(self) -> Dict[str, int]:
        rows = self._commit([
            ("MATCH (d:Document) RETURN count(d)", {}),
            ("MATCH (s:Sentence) RETURN count(s)", {}),
            ("MATCH (t:Token) RETURN count(t)", {}),
        ])

        def first(i):
            try:
                return int(rows[i]["data"][0]["row"][0])
            except (IndexError, KeyError, TypeError, ValueError):
                return 0

        return {"Document": first(0), "Sentence": first(1), "Token": first(2)}

    def close(self) -> None:  # HTTP is stateless
        pass


def make_graph_store(config: GraphStoreConfig, resilience=None):
    """Backend selection: uri set → external Neo4j; else embedded sqlite.

    With a ResilienceConfig (and breakers enabled), the EXTERNAL backend is
    wrapped in a circuit breaker + document spill (resilience/stores.py):
    a mid-run Neo4j outage spools save_tokenized payloads locally and
    replays them on recovery instead of dropping them."""
    if config.uri:
        store = Neo4jGraphStore(config)
        if resilience is not None and resilience.breaker_enabled:
            from pathlib import Path

            from symbiont_tpu_torch.resilience.breaker import CircuitBreaker
            from symbiont_tpu_torch.resilience.stores import ResilientGraphStore

            return ResilientGraphStore(
                store,
                breaker=CircuitBreaker(
                    "graph_store",
                    failure_threshold=resilience.breaker_failure_threshold,
                    reset_timeout_s=resilience.breaker_reset_timeout_s),
                spill_path=str(Path(resilience.spill_dir)
                               / "graph.spill.jsonl"))
        return store
    from symbiont_tpu_torch.graph.store import GraphStore

    return GraphStore(config)
