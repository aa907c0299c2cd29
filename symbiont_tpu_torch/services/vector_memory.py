"""Vector-memory service — bus adapter over the TPU-native vector store.

Copy of the JAX package's `symbiont_tpu/services/vector_memory.py`.

Parity with reference: services/vector_memory_service/src/main.rs:
- startup ensure_collection (main.rs:24-119);
- data.text.with_embeddings → one point per sentence, uuid ids, 6-field
  QdrantPointPayload (main.rs:121-228), ack-after-durable (wait=true, :196);
- tasks.search.semantic.request request-reply with typed error replies
  (main.rs:230-456).

Ingest hot path (ROADMAP item 3, the 5× host gap) — three departures from
the reference's per-message lockstep:
- ZERO-CHURN decode: frame-bearing messages go through
  `frames.decode_embeddings_lazy` (one json.loads + one zero-copy array
  view; no per-sentence dataclasses) and the store payload dicts are built
  directly — `dataclasses.asdict` is statically banned on this path
  (tests/test_pipeline_wiring.py). The dict keys ARE the 6-field
  QdrantPointPayload wire shape; test_store_wire_fixtures pins it.
- CROSS-MESSAGE coalescing (services/coalesce.py): rows from many messages
  land as ONE `upsert_rows` call; each durable delivery is acked only after
  the flush carrying its rows commits (ack-after-flush — a crashed flush
  redelivers every message it carried, and deterministic point ids make the
  retry idempotent).
- the store call runs on the dedicated bounded store executor, not the
  default pool the embed/tokenize stages share.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.memory.vector_store import VectorStore
from symbiont_tpu_torch.schema import (
    QdrantPointPayload,
    SemanticSearchNatsResult,
    SemanticSearchNatsTask,
    SemanticSearchResultItem,
    from_json,
    to_json_bytes,
)
from symbiont_tpu_torch.schema import frames
from symbiont_tpu_torch.services.base import Service
from symbiont_tpu_torch.services.coalesce import (
    UpsertCoalescer,
    store_executor,
    upsert_rows_or_points,
)
from symbiont_tpu_torch.utils.ids import (
    current_timestamp_ms,
    deterministic_point_id,
)
from symbiont_tpu_torch.utils.telemetry import child_headers, metrics, span

log = logging.getLogger(__name__)


class VectorMemoryService(Service):
    name = "vector_memory"

    def __init__(self, bus, store: VectorStore, durable_stream=None,
                 coalesce: bool = True, coalesce_max_rows: int = 512,
                 coalesce_max_age_ms: float = 25.0):
        super().__init__(bus)
        self.store = store
        self.durable_stream = durable_stream
        self._coalescer: Optional[UpsertCoalescer] = (
            UpsertCoalescer(self._store_upsert, max_rows=coalesce_max_rows,
                            max_age_ms=coalesce_max_age_ms,
                            name=self.name)
            if coalesce else None)

    async def start(self) -> None:
        if self._coalescer is not None:
            await self._coalescer.start()
        await super().start()

    async def drain(self) -> None:
        # drain protocol: flip the coalescer to immediate-flush FIRST, so
        # the in-flight handlers stop() waits on resolve their
        # ack-after-flush futures right away instead of waiting out a
        # long age window — then the shared stop path (detach durable
        # consumers → wait handlers → coalescer flush-on-stop) runs
        if self._coalescer is not None:
            self._coalescer.drain_mode()
        await super().drain()

    async def stop(self) -> None:
        # order matters: super().stop() drains in-flight handlers first
        # (their ack-waits resolve via the still-running age flush), THEN
        # the coalescer flush-on-stops anything that never hit a trigger
        await super().stop()
        if self._coalescer is not None:
            await self._coalescer.stop()

    async def _setup(self) -> None:
        # startup ensure (reference: create/ensure collection, main.rs:24-119)
        # in an executor: with an external-Qdrant backend this is a blocking
        # HTTP retry loop that must not freeze the event loop
        await asyncio.get_running_loop().run_in_executor(
            None, self.store.ensure_collection)
        await self._subscribe_loop(subjects.DATA_TEXT_WITH_EMBEDDINGS,
                                   self._handle_upsert,
                                   queue=subjects.QUEUE_VECTOR_MEMORY,
                                   durable_stream=self.durable_stream)
        await self._subscribe_loop(subjects.TASKS_SEARCH_SEMANTIC_REQUEST,
                                   self._handle_search,
                                   queue=subjects.QUEUE_VECTOR_MEMORY)
        # operational count surface: a multi-process deployment's load
        # generator (bench/load.py --multiproc) verifies EXACT zero-loss ingest from
        # outside this process through one request-reply hop
        await self._subscribe_loop(subjects.TASKS_MEMORY_COUNT,
                                   self._handle_count,
                                   queue=subjects.QUEUE_VECTOR_MEMORY)

    def _store_upsert(self, ids, rows, payloads) -> int:
        return upsert_rows_or_points(self.store, ids, rows, payloads)

    async def _handle_upsert(self, msg: Msg) -> None:
        # both wire forms (schema/frames), zero-churn: scalar metadata +
        # sentence texts + ONE [n, dim] row block — no per-sentence
        # dataclass, no per-float Python object
        m = frames.decode_embeddings_lazy(msg.data, msg.headers)
        now = current_timestamp_ms()
        ids, payloads = [], []
        for order, sentence in enumerate(m.sentences):
            # content-derived id: durable redelivery (and a re-coalesced
            # flush retry) overwrites the same point instead of duplicating
            # it (reference mints random uuids, main.rs:142-177 — safe only
            # at-most-once)
            ids.append(deterministic_point_id(m.original_id, order))
            # direct dict build — the 6 QdrantPointPayload wire fields;
            # keep in lockstep with the schema dataclass (pinned by
            # tests/test_store_wire_fixtures.py)
            payloads.append({
                "original_document_id": m.original_id,
                "source_url": m.source_url,
                "sentence_text": sentence,
                "sentence_order": order,
                "model_name": m.model_name,
                "processed_at_ms": now,
            })
        with span("vector_memory.upsert", msg.headers, points=len(ids)):
            if self._coalescer is not None:
                # ack-after-flush: resolves once the coalesced store call
                # carrying THESE rows committed (or raises what it raised —
                # the delivery then stays unacked for redelivery)
                n = await self._coalescer.add(ids, m.rows, payloads,
                                              headers=msg.headers)
            else:
                n = await asyncio.get_running_loop().run_in_executor(
                    store_executor(), self._store_upsert, ids, m.rows,
                    payloads)
        metrics.inc("vector_memory.points_upserted", n)

    async def _handle_count(self, msg: Msg) -> None:
        import json as _json

        if not msg.reply:
            return
        try:
            # executor: an external-Qdrant count is a blocking HTTP call
            n = await asyncio.get_running_loop().run_in_executor(
                None, self.store.count)
            payload = {"count": int(n), "error_message": None}
        except Exception as e:
            log.exception("count failed")
            payload = {"count": None, "error_message": str(e)}
        await self.bus.publish(msg.reply,
                               _json.dumps(payload).encode(),
                               headers=child_headers(msg.headers))

    async def _handle_search(self, msg: Msg) -> None:
        if not msg.reply:
            log.warning("search task without reply inbox")
            return
        try:
            task = from_json(SemanticSearchNatsTask, msg.data)
        except Exception as e:
            err = SemanticSearchNatsResult(request_id="unknown", results=[],
                                           error_message=f"bad request: {e}")
            await self.bus.publish(msg.reply, to_json_bytes(err))
            return
        try:
            # default pool, NOT the store executor: search is the latency
            # path and must never queue behind a bulk flush holding one of
            # the write pool's workers
            with span("vector_memory.search", msg.headers, top_k=task.top_k):
                hits = await asyncio.get_running_loop().run_in_executor(
                    None, self.store.search,
                    task.query_embedding, task.top_k)
            results = [
                SemanticSearchResultItem(
                    qdrant_point_id=h.id, score=h.score,
                    payload=QdrantPointPayload(**h.payload))
                for h in hits
            ]
            result = SemanticSearchNatsResult(request_id=task.request_id,
                                              results=results, error_message=None)
        except Exception as e:
            log.exception("search failed")
            result = SemanticSearchNatsResult(request_id=task.request_id,
                                              results=[], error_message=str(e))
        await self.bus.publish(msg.reply, to_json_bytes(result),
                               headers=child_headers(msg.headers))
        metrics.inc("vector_memory.searches")
