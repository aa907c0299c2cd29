"""Knowledge-graph service — consumes the (restored) tokenized stream AND

Copy of the JAX package's `symbiont_tpu/services/knowledge_graph.py`.
serves graph-augmented search.

Parity with reference: services/knowledge_graph_service/src/main.rs:142-156
(handler) and :23-140 (save), over the embedded sqlite graph store instead of
external Neo4j. In the reference this consumer is orphaned — nothing publishes
its subject in v0.3.0 (SURVEY.md fact #3); here preprocessing publishes it,
and the limb is finally LOAD-BEARING end-to-end: the tokenized stream builds
the Document/Sentence/Token graph, and `tasks.search.graph.request` (behind
`POST /api/search/graph`) answers token-overlap document lookups over it —
entity extraction → graph upsert → graph-augmented search as one traced
scenario (bench/load.py drives it under the traffic simulator).
"""

from __future__ import annotations

import asyncio
import logging
import re

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.graph.store import GraphStore
from symbiont_tpu_torch.schema import TokenizedTextMessage, from_json
from symbiont_tpu_torch.services.base import Service
from symbiont_tpu_torch.utils.telemetry import child_headers, metrics, span

log = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


class KnowledgeGraphService(Service):
    name = "knowledge_graph"

    # documents scanned per query token before ranking; bounds the work a
    # single pathological query (every stopword in the corpus) can cause
    MAX_DOCS_PER_TOKEN = 256

    def __init__(self, bus, store: GraphStore, durable_stream=None):
        super().__init__(bus)
        self.store = store
        self.durable_stream = durable_stream

    async def _setup(self) -> None:
        # retry-at-startup parity (main.rs:253-284), in an executor: with an
        # external-Neo4j backend this is a blocking HTTP retry loop
        await asyncio.get_running_loop().run_in_executor(
            None, self.store.ensure_schema)
        await self._subscribe_loop(subjects.DATA_PROCESSED_TEXT_TOKENIZED,
                                   self._handle_tokenized,
                                   queue=subjects.QUEUE_KNOWLEDGE_GRAPH,
                                   durable_stream=self.durable_stream)
        await self._subscribe_loop(subjects.TASKS_SEARCH_GRAPH_REQUEST,
                                   self._handle_graph_search,
                                   queue=subjects.QUEUE_KNOWLEDGE_GRAPH)

    async def _handle_tokenized(self, msg: Msg) -> None:
        m = from_json(TokenizedTextMessage, msg.data)
        with span("knowledge_graph.save", msg.headers,
                  sentences=len(m.sentences), tokens=len(m.tokens)):
            await asyncio.get_running_loop().run_in_executor(
                None, self.store.save_tokenized, m)
        metrics.inc("knowledge_graph.documents_saved")

    # ------------------------------------------------ graph-augmented search

    def _graph_search(self, query_text: str, top_k: int) -> list:
        """Token-overlap document ranking over the graph: the query's
        tokens → Token nodes → CONTAINS_TOKEN edges → Documents, scored by
        matched-token count (ties by id, deterministic), each hit carrying
        its leading sentences as the snippet."""
        tokens = [t.lower() for t in _TOKEN_RE.findall(query_text)]
        seen, uniq = set(), []
        for t in tokens:
            if t not in seen:
                seen.add(t)
                uniq.append(t)
        match_counts: dict = {}
        matched_by_doc: dict = {}
        for token in uniq:
            for doc_id in self.store.documents_containing_token(
                    token, limit=self.MAX_DOCS_PER_TOKEN):
                match_counts[doc_id] = match_counts.get(doc_id, 0) + 1
                matched_by_doc.setdefault(doc_id, []).append(token)
        ranked = sorted(match_counts.items(), key=lambda kv: (-kv[1], kv[0]))
        hits = []
        for doc_id, n in ranked[:top_k]:
            sentences = self.store.document_sentences(doc_id)
            hits.append({
                "original_document_id": doc_id,
                "matched_tokens": matched_by_doc[doc_id],
                "match_count": n,
                "snippet": " ".join(sentences[:2]),
            })
        return hits

    async def _handle_graph_search(self, msg: Msg) -> None:
        """Request-reply: {"query_text": ..., "top_k": N} → {"results":
        [...], "error_message": null}. Plain JSON wire (engine-plane
        convention), NOT a schema dataclass — this subject is framework-
        internal, not part of the reference parity surface."""
        import json as _json

        if not msg.reply:
            log.warning("graph search task without reply inbox")
            return
        try:
            req = _json.loads(msg.data)
            query_text = req.get("query_text") or ""
            top_k = max(1, min(int(req.get("top_k", 5)), 100))
            if not isinstance(query_text, str) or not query_text.strip():
                raise ValueError("query_text must be a non-empty string")
            with span("knowledge_graph.search", msg.headers, top_k=top_k):
                if not hasattr(self.store, "documents_containing_token"):
                    raise RuntimeError(
                        "graph backend has no token-lookup surface "
                        "(external Neo4j adapter: use Cypher directly)")
                hits = await asyncio.get_running_loop().run_in_executor(
                    None, self._graph_search, query_text, top_k)
            body = {"results": hits, "error_message": None}
        except Exception as e:
            log.exception("graph search failed")
            body = {"results": [], "error_message": str(e)}
        await self.bus.publish(
            msg.reply, _json.dumps(body, ensure_ascii=False).encode(),
            headers=child_headers(msg.headers))
        metrics.inc("knowledge_graph.graph_searches")
