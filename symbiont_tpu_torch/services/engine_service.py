"""Engine service — the TPU-owning process's bus frontend.

Copy of the JAX package's `symbiont_tpu/services/engine_service.py`, with
one change: the JAX service pre-compiles the fused query's XLA programs in
the background (`_spawn_fused_warm` through the store's `warm_fused` and
`fused_warm_stale`) and re-warms when upserts cross a capacity block. The
port runs eagerly, so nothing is compiled and that path is gone; a CUDA
graph capture of the fused query would take its place (ROADMAP A16).

This is the "sun" of the architecture (SURVEY.md §7 design stance): exactly one
process owns the device (engine + LM + vector store + graph store), and every
other worker — Python or native C++ — reaches compute and storage through
request-reply on the `engine.*` subjects. The reference's equivalent decision
was to put candle *inside* preprocessing_service (reference:
services/preprocessing_service/src/embedding_generator.rs:9-14), which couples
every scale-out of the bus workers to a GPU context and creates the
concurrent-forward hazard SURVEY.md §5.2 documents. Splitting the plane here
means:

- native C++ shells (native/services/*.cpp) carry the bus/schema/business
  logic with zero Python in-process;
- all callers share ONE micro-batching queue in front of the device, so
  interactive queries and bulk ingest coexist (SURVEY.md §7 hard part #4);
- engine restart does not restart the pipeline workers (two-plane failure
  semantics, §7 hard part #6).

Payloads on this plane are plain JSON (framework-internal; the reference wire
schema from SURVEY.md §1-L3 is untouched). Every reply carries
`error_message: null | str` — the typed-error-reply convention the reference
uses on its request-reply paths (reference:
services/preprocessing_service/src/main.rs:183-196).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

import numpy as np

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.engine.batcher import MicroBatcher
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.schema import TokenizedTextMessage, from_dict
from symbiont_tpu_torch.schema import frames
from symbiont_tpu_torch.resilience import admission
from symbiont_tpu_torch.services.base import Service
from symbiont_tpu_torch.services.coalesce import (
    UpsertCoalescer,
    store_executor,
    upsert_rows_or_points,
)
from symbiont_tpu_torch.utils.telemetry import child_headers, metrics, span

log = logging.getLogger(__name__)

# request/reply key carrying a decoded tensor frame through the op plumbing
# (never serialized: _handle pops it off the wire, _reply re-attaches it)
_FRAME_KEY = "_frame"
# sibling key: the wire dtype the op chose for its reply frame (defaults to
# the full-width form when absent)
_FRAME_DTYPE_KEY = "_frame_dtype"


def _err(payload: dict) -> bytes:
    payload.setdefault("error_message", None)
    # compact separators (matching schema.to_json): every engine reply used
    # to carry json.dumps' default ", "/": " whitespace — pure wasted bytes
    # on the hottest reply path of the stack
    return json.dumps(payload, separators=(",", ":")).encode()


class EngineService(Service):
    name = "engine"

    def __init__(self, bus, engine: Optional[TorchEngine] = None,
                 batcher: Optional[MicroBatcher] = None, lm=None,
                 lm_batcher=None, vector_store=None, graph_store=None,
                 coalesce: bool = True, coalesce_max_rows: int = 512,
                 coalesce_max_age_ms: float = 25.0):
        super().__init__(bus)
        self.engine = engine
        self.batcher = batcher or (MicroBatcher(engine) if engine else None)
        self.lm = lm
        self.lm_batcher = lm_batcher
        self.vector_store = vector_store
        self.graph_store = graph_store
        # cross-REQUEST upsert coalescing (services/coalesce.py): the native
        # vector_memory shells each batch points per request, but N workers
        # × M in-flight requests still cost one store call (WAL fsync +
        # lock round-trip) each — here they merge into one. The reply to
        # each request is held until the flush carrying its rows commits,
        # so the shells' ack-after-reply contract is ack-after-flush
        # end to end.
        self._upsert_coalescer: Optional[UpsertCoalescer] = (
            UpsertCoalescer(self._store_upsert_rows,
                            max_rows=coalesce_max_rows,
                            max_age_ms=coalesce_max_age_ms, name=self.name)
            if coalesce and vector_store is not None else None)

    def _store_upsert_rows(self, ids, rows, payloads) -> int:
        return upsert_rows_or_points(self.vector_store, ids, rows, payloads)

    async def start(self) -> None:
        if self.batcher:
            await self.batcher.start()
        if self._upsert_coalescer is not None:
            await self._upsert_coalescer.start()
        await super().start()

    async def drain(self) -> None:
        # drain protocol (resilience/autoscale.py): immediate-flush mode
        # first so in-flight upsert requests' reply-after-flush waits
        # resolve without the age window — see VectorMemoryService.drain
        if self._upsert_coalescer is not None:
            self._upsert_coalescer.drain_mode()
        await super().drain()

    async def stop(self) -> None:
        await super().stop()
        if self._upsert_coalescer is not None:
            await self._upsert_coalescer.stop()
        if self.batcher:
            await self.batcher.close()

    async def _setup(self) -> None:
        q = subjects.QUEUE_ENGINE
        sub = self._subscribe_loop
        if self.engine is not None:
            await sub(subjects.ENGINE_EMBED_BATCH, self._embed_batch, queue=q)
            await sub(subjects.ENGINE_EMBED_QUERY, self._embed_query, queue=q)
            # subscribed even without a cross-encoder: a rerank request against
            # a rerank-disabled stack must get a fast typed error reply
            # ("no cross-encoder model loaded"), not a 10s caller timeout
            await sub(subjects.ENGINE_RERANK, self._rerank, queue=q)
        if self.lm is not None:
            await sub(subjects.ENGINE_GENERATE, self._generate, queue=q)
        if self.vector_store is not None:
            await sub(subjects.ENGINE_VECTOR_UPSERT, self._vec_upsert, queue=q)
            await sub(subjects.ENGINE_VECTOR_SEARCH, self._vec_search, queue=q)
        if (self.engine is not None and self.vector_store is not None
                and getattr(self.vector_store, "supports_fused", False)):
            # fused embed+top-k — only when this process holds both the model
            # and a device-resident corpus (external Qdrant backends don't)
            await sub(subjects.ENGINE_QUERY_SEARCH, self._query_search, queue=q)
        if self.graph_store is not None:
            await sub(subjects.ENGINE_GRAPH_SAVE, self._graph_save, queue=q)
        await sub(subjects.ENGINE_HEALTH, self._health, queue=q)

    # ------------------------------------------------------------- plumbing

    async def _reply(self, msg: Msg, payload: dict) -> None:
        if not msg.reply:
            return
        headers = child_headers(msg.headers)
        # an op that put an ndarray under _FRAME_KEY replies with the block
        # as a binary tensor frame appended to the JSON metadata, in the
        # wire dtype the op negotiated (_FRAME_DTYPE_KEY)
        frame = payload.pop(_FRAME_KEY, None)
        dtype = payload.pop(_FRAME_DTYPE_KEY, None)
        data = _err(payload)
        if frame is not None:
            data, fheaders = (frames.attach_frame(data, frame, dtype=dtype)
                              if dtype is not None
                              else frames.attach_frame(data, frame))
            headers.update(fheaders)
        await self.bus.publish(msg.reply, data, headers=headers)

    async def _handle(self, msg: Msg, op: str, fn) -> None:
        """Decode → run op → reply; typed error reply on any failure.
        A request-side tensor frame (schema/frames) is detached here and
        handed to the op as `req["_frame"]` (a zero-copy [n, dim] view)."""
        if not msg.reply:
            log.warning("engine op %s without reply inbox dropped", op)
            metrics.inc("engine.no_reply_inbox")
            return
        try:
            raw, frame = frames.detach_frame(msg.data or b"", msg.headers)
            req = json.loads(raw) if raw else {}
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            req.pop(_FRAME_KEY, None)  # reserved: only a real frame sets it
            if frame is not None:
                req[_FRAME_KEY] = frame
        except Exception as e:
            await self._reply(msg, {"error_message": f"bad request: {e}"})
            return
        try:
            with span(f"engine.{op}", msg.headers):
                payload = await fn(req)
            metrics.inc(f"engine.{op}")
        except Exception as e:
            log.exception("engine op %s failed", op)
            metrics.inc(f"engine.{op}.failed")
            payload = {"error_message": str(e)}
        await self._reply(msg, payload)

    async def _run_blocking(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    async def _run_store(self, fn, *args):
        """Blocking vector-store WRITES ride the dedicated bounded store
        executor (services/coalesce.py): a WAL fsync or breaker-degraded
        upsert must not steal default-pool threads from the embed forwards
        running concurrently. Reads (search/count) stay on the default
        pool — the latency path must not queue behind a bulk flush."""
        return await asyncio.get_running_loop().run_in_executor(
            store_executor(), fn, *args)

    # ------------------------------------------------------------- compute

    async def _embed_batch(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            texts = req["texts"]
            if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
                raise ValueError("texts must be a list of strings")
            # fairness lane from the bus tenant header (native shells thread
            # it verbatim via child_headers — common.hpp parity)
            vecs = await self.batcher.embed(
                texts, tenant=admission.tenant_of(msg.headers))
            encoding = req.get("encoding")
            if encoding in ("frame", "frame16"):
                # zero-copy reply for frame-capable callers: the [n, dim]
                # block rides as a binary tensor frame appended to the JSON
                # metadata (_reply attaches it; schema/frames). encoding
                # frame16 asks for the half-width dtype-2 form — the ONE
                # place a service maps a negotiated encoding to a frame
                # dtype (allowlisted in tests/test_pipeline_wiring.py; every
                # other dtype decision lives in schema/frames.py). An old
                # engine ignores either encoding value and answers with
                # JSON float lists — the fallback every caller accepts.
                arr = np.ascontiguousarray(np.asarray(vecs, np.float32))
                if arr.ndim == 1:  # zero texts edge: keep the 2-D contract
                    arr = arr.reshape(0, 0)
                return {"count": int(arr.shape[0]), "dim": int(arr.shape[1]),
                        "model_name": self.engine.config.model_name,
                        _FRAME_KEY: arr,
                        _FRAME_DTYPE_KEY: ("f16" if encoding == "frame16"
                                           else "f32")}
            if encoding == "b64":
                # compact reply for reference-era bulk callers: f32
                # little-endian rows base64'd is ~4.3 bytes per float vs
                # ~10 digits of JSON
                import base64

                arr = np.ascontiguousarray(np.asarray(vecs, np.float32))
                if arr.ndim == 1:  # zero texts edge: keep the 2-D contract
                    arr = arr.reshape(0, 0)
                return {"vectors_b64": base64.b64encode(arr.tobytes()).decode(
                            "ascii"),
                        "count": int(arr.shape[0]), "dim": int(arr.shape[1]),
                        "model_name": self.engine.config.model_name}
            # JSON fallback: ndarray.tolist() converts in C (no per-float
            # Python loop), same double-widened digits as before
            return {"vectors": np.asarray(vecs, np.float32).tolist(),
                    "model_name": self.engine.config.model_name}
        await self._handle(msg, "embed.batch", op)

    async def _embed_query(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            text = req["text"]
            if not isinstance(text, str):
                raise ValueError("text must be a string")
            # interactive lane: never FIFO a query behind the same
            # tenant's bulk backlog (see preprocessing._handle_query_
            # embedding; load_ramp measured the starvation)
            from symbiont_tpu_torch.engine.batcher import interactive_lane

            vecs = await self.batcher.embed(
                [text],
                tenant=interactive_lane(admission.tenant_of(msg.headers)))
            return {"vector": np.asarray(vecs[0], np.float32).tolist(),
                    "model_name": self.engine.config.model_name}
        await self._handle(msg, "embed.query", op)

    async def _rerank(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            scores = await self._run_blocking(
                self.engine.rerank, req["query"], req["passages"])
            return {"scores": [float(s) for s in scores]}
        await self._handle(msg, "rerank", op)

    async def _generate(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            prompt = req.get("prompt") or ""
            max_new = int(req.get("max_new_tokens", 50))
            temperature = req.get("temperature")
            temperature = None if temperature is None else float(temperature)
            top_k = req.get("top_k")
            top_k = None if top_k is None else int(top_k)
            if self.lm_batcher is not None:
                # shared micro-batcher: concurrent engine.generate callers
                # decode as one batch with the bus-surface requests
                text = await self.lm_batcher.generate(
                    prompt, max_new, temperature=temperature, top_k=top_k,
                    tenant=admission.tenant_of(msg.headers))
            else:
                text = await self._run_blocking(
                    lambda: self.lm.generate(prompt, max_new,
                                             temperature=temperature,
                                             top_k=top_k))
            name = self.lm.config.model_dir or f"symbiont-lm/{self.lm.config.arch}"
            return {"text": text, "model_name": name}
        await self._handle(msg, "generate", op)

    # ------------------------------------------------------------- storage

    async def _vec_upsert(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            rows = None
            if _FRAME_KEY in req:
                # tensor-frame ingest (the C++ vector_memory shell's frame
                # hop): the [n, dim] block arrived as a zero-copy view —
                # it goes into the store without touching JSON floats
                rows = req[_FRAME_KEY]
                ids = req["ids"]
                if rows.shape[0] != len(ids):
                    raise ValueError(
                        f"frame holds {rows.shape[0]} rows for "
                        f"{len(ids)} ids")
                if "dim" in req and rows.shape[1] != int(req["dim"]):
                    raise ValueError(
                        f"frame dim {rows.shape[1]} != declared "
                        f"dim {req['dim']}")
                payloads = req.get("payloads") or [{}] * len(ids)
                if len(payloads) != len(ids):
                    raise ValueError(
                        f"{len(payloads)} payloads for {len(ids)} ids")
            elif "vectors_b64" in req:
                # compact form from reference-era C++ shells: all vectors
                # in one base64 f32 block (framework-internal plane; the
                # data.text.with_embeddings wire schema is untouched)
                import base64

                dim = int(req["dim"])
                flat = np.frombuffer(base64.b64decode(req["vectors_b64"]),
                                     dtype=np.float32)
                ids = req["ids"]
                if dim <= 0 or flat.size != len(ids) * dim:
                    raise ValueError(
                        f"vectors_b64 holds {flat.size} floats for "
                        f"{len(ids)} ids of dim {dim}")
                rows = flat.reshape(len(ids), dim)
                payloads = req.get("payloads") or [{}] * len(ids)
                if len(payloads) != len(ids):
                    # zip would silently truncate and drop points
                    raise ValueError(
                        f"{len(payloads)} payloads for {len(ids)} ids")
            else:
                points = [(p["id"], p["vector"], p.get("payload", {}))
                          for p in req["points"]]
            if rows is not None:
                if self._upsert_coalescer is not None:
                    # reply-after-flush: resolves once the coalesced store
                    # call carrying THESE rows committed; a flush failure
                    # surfaces as this request's typed error reply
                    n = await self._upsert_coalescer.add(ids, rows, payloads,
                                                         headers=msg.headers)
                else:
                    n = await self._run_store(
                        self._store_upsert_rows, ids, rows, payloads)
            else:
                # legacy per-point JSON form (reference-era callers): rare
                # and small — straight through, no coalescing
                n = await self._run_store(self.vector_store.upsert,
                                          points)
            return {"upserted": n}
        await self._handle(msg, "vector.upsert", op)

    async def _vec_search(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            hits = await self._run_blocking(
                self.vector_store.search, req["vector"], int(req["top_k"]))
            return {"hits": [{"id": h.id, "score": float(h.score),
                              "payload": h.payload} for h in hits]}
        await self._handle(msg, "vector.search", op)

    async def _query_search(self, msg: Msg) -> None:
        """Fused interactive query: text → embed + cosine top-k in one device
        program (TorchEngine.embed_and_search). The latency path of SURVEY.md
        §3.2 collapsed to a single bus hop and a single device round-trip."""
        async def op(req: dict) -> dict:
            text = req["text"]
            if not isinstance(text, str):
                raise ValueError("text must be a string")
            hits = await self._run_blocking(
                self.vector_store.search_fused, self.engine, text,
                int(req["top_k"]))
            return {"hits": [{"id": h.id, "score": float(h.score),
                              "payload": h.payload} for h in hits],
                    "model_name": self.engine.config.model_name}
        await self._handle(msg, "query.search", op)

    async def _graph_save(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            m = from_dict(TokenizedTextMessage, req["message"])
            doc_id = await self._run_blocking(self.graph_store.save_tokenized, m)
            return {"document_db_id": doc_id}
        await self._handle(msg, "graph.save", op)

    # -------------------------------------------------------------- health

    async def _health(self, msg: Msg) -> None:
        async def op(req: dict) -> dict:
            out = {"ok": True, "backends": {
                "embed": self.engine is not None,
                "rerank": bool(self.engine is not None
                               and self.engine.cross_params is not None),
                "generate": self.lm is not None,
                "vector": self.vector_store is not None,
                "graph": self.graph_store is not None,
            }}
            if self.engine is not None:
                out["embedding_dim"] = self.engine.model_cfg.hidden_size
                out["model_name"] = self.engine.config.model_name
                out["stats"] = dict(self.engine.stats)
            if self.vector_store is not None:
                # executor: an external-Qdrant count is a blocking HTTP call
                out["vector_count"] = await self._run_blocking(
                    self.vector_store.count)
            return out
        await self._handle(msg, "health", op)
