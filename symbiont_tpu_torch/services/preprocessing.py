"""Preprocessing service — the engine's bus frontend.

Copy of the JAX package's `symbiont_tpu/services/preprocessing.py`.

Parity with reference: services/preprocessing_service/src/main.rs, two roles:
1. pipeline: data.raw_text.discovered → clean/split/embed →
   data.text.with_embeddings (main.rs:126-171), with errors for empty text
   (main.rs:33-39);
2. query embedding request-reply on tasks.embedding.for_query with typed
   error replies even on bad input (main.rs:173-298).

Plus the deliberate un-orphaning (SURVEY.md fact #3): after embedding, the
tokenized form is published to data.processed_text.tokenized so the
knowledge-graph path is live again (the reference's CHANGELOG.md:57-60 left it
dead).

Embedding runs through the MicroBatcher — queries and bulk ingest share the
engine without the reference's concurrent-forward hazard (§5.2).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.engine.batcher import MicroBatcher
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.text import clean_text, split_sentences, tokenize_words
from symbiont_tpu_torch.schema import (
    QueryEmbeddingResult,
    QueryForEmbeddingTask,
    RawTextMessage,
    TokenizedTextMessage,
    from_json,
    to_json_bytes,
)
from symbiont_tpu_torch.schema import frames
from symbiont_tpu_torch.resilience import admission
from symbiont_tpu_torch.services.base import Service
from symbiont_tpu_torch.utils.ids import current_timestamp_ms
from symbiont_tpu_torch.utils.telemetry import child_headers, metrics

log = logging.getLogger(__name__)


class PreprocessingService(Service):
    name = "preprocessing"

    def __init__(self, bus, engine: TorchEngine,
                 batcher: Optional[MicroBatcher] = None,
                 publish_tokenized: bool = True,
                 durable_stream: Optional[str] = None,
                 use_frames: Optional[bool] = None):
        super().__init__(bus)
        self.engine = engine
        self.batcher = batcher or MicroBatcher(engine)
        self.publish_tokenized = publish_tokenized
        self.model_name = engine.config.model_name
        self.durable_stream = durable_stream
        # binary tensor frames on data.text.with_embeddings (schema/frames);
        # None → the SYMBIONT_FRAMES deployment knob (default on)
        self.use_frames = (frames.frames_enabled() if use_frames is None
                           else use_frames)

    async def start(self) -> None:
        await self.batcher.start()
        await super().start()

    async def stop(self) -> None:
        await super().stop()
        await self.batcher.close()

    async def _setup(self) -> None:
        await self._subscribe_loop(subjects.DATA_RAW_TEXT_DISCOVERED,
                                   self._handle_raw_text,
                                   queue=subjects.QUEUE_PREPROCESSING,
                                   durable_stream=self.durable_stream)
        await self._subscribe_loop(subjects.TASKS_EMBEDDING_FOR_QUERY,
                                   self._handle_query_embedding,
                                   queue=subjects.QUEUE_PREPROCESSING)

    # ------------------------------------------------------------- pipeline

    async def _handle_raw_text(self, msg: Msg) -> None:
        raw = from_json(RawTextMessage, msg.data)
        cleaned = clean_text(raw.raw_text)
        if not cleaned:
            metrics.inc("preprocessing.empty_text")
            log.warning("cleaned text empty for id %s", raw.id)
            return
        sentences = split_sentences(cleaned)
        # engine-plane fairness: the tenant header threaded from the edge
        # picks this document's lane in the micro-batcher — fairness holds
        # even when the API edge's admission plane is bypassed or restarted
        vectors = await self.batcher.embed(
            sentences, tenant=admission.tenant_of(msg.headers))
        # engine output → wire without a single per-float Python conversion:
        # frame mode appends the [n, dim] f32 block to the JSON metadata
        # (schema/frames); fallback mode emits the reference wire shape
        data, fheaders = frames.encode_embeddings_message(
            raw.id, raw.source_url, sentences, vectors, self.model_name,
            current_timestamp_ms(), use_frame=self.use_frames)
        headers = child_headers(msg.headers)
        # the frame header rides ONLY on the frame-bearing publish — the
        # tokenized publish below shares the trace context, not the frame
        await self.bus.publish(subjects.DATA_TEXT_WITH_EMBEDDINGS,
                               data, headers={**headers, **fheaders})
        metrics.inc("preprocessing.embedded_docs")
        metrics.inc("preprocessing.embedded_sentences", len(sentences))
        if self.publish_tokenized:
            tok = TokenizedTextMessage(
                original_id=raw.id, source_url=raw.source_url,
                tokens=tokenize_words(cleaned), sentences=sentences,
                timestamp_ms=current_timestamp_ms())
            await self.bus.publish(subjects.DATA_PROCESSED_TEXT_TOKENIZED,
                                   to_json_bytes(tok), headers=headers)

    # ------------------------------------------------------ query embedding

    async def _handle_query_embedding(self, msg: Msg) -> None:
        if not msg.reply:
            log.warning("query-embedding task without reply inbox")
            return
        try:
            task = from_json(QueryForEmbeddingTask, msg.data)
        except Exception as e:
            # typed error reply even on deserialize failure (main.rs:183-196)
            err = QueryEmbeddingResult(request_id="unknown", embedding=None,
                                       model_name=None,
                                       error_message=f"bad request: {e}")
            await self.bus.publish(msg.reply, to_json_bytes(err))
            return
        try:
            # interactive lane (batcher.interactive_lane): the query must
            # stride-interleave against this tenant's own bulk-ingest lane,
            # not FIFO behind it — a deep ingest backlog otherwise turns
            # every same-tenant search into a bus-timeout (load_ramp tier)
            from symbiont_tpu_torch.engine.batcher import interactive_lane

            vecs = await self.batcher.embed(
                [task.text_to_embed],
                tenant=interactive_lane(admission.tenant_of(msg.headers)))
            if frames.wants_frame(msg.headers):
                # negotiated reply frame (X-Symbiont-Accept-Frame): the
                # [1, dim] block rides appended to a schema-valid reply
                # whose embedding list is empty — no per-float JSON on the
                # reply hop. Requesters that never sent the header (the
                # reference-era C++ gateway included) keep getting float
                # lists below.
                arr = np.ascontiguousarray(
                    np.asarray(vecs[:1], np.float32))
                result = QueryEmbeddingResult(
                    request_id=task.request_id, embedding=[],
                    model_name=self.model_name, error_message=None)
                data, fheaders = frames.attach_frame(to_json_bytes(result),
                                                     arr)
                await self.bus.publish(
                    msg.reply, data,
                    headers={**child_headers(msg.headers), **fheaders})
                metrics.inc("preprocessing.query_embeddings")
                return
            result = QueryEmbeddingResult(
                request_id=task.request_id,
                embedding=np.asarray(vecs[0], np.float32).tolist(),
                model_name=self.model_name, error_message=None)
        except Exception as e:
            log.exception("query embedding failed")
            result = QueryEmbeddingResult(request_id=task.request_id,
                                          embedding=None, model_name=None,
                                          error_message=str(e))
        await self.bus.publish(msg.reply, to_json_bytes(result),
                               headers=child_headers(msg.headers))
        metrics.inc("preprocessing.query_embeddings")
