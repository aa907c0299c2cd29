"""Text-generator service.

Copy of the JAX package's `symbiont_tpu/services/text_generator.py`.

Parity with reference: services/text_generator_service/src/main.rs:111-162:
consumes GenerateTextTask, generates, publishes GeneratedTextMessage to
events.text.generated. Two backends:

- Markov (default, reference parity) — but trained continuously on every
  ingested document (the reference trains once on one hardcoded sentence and
  ignores the prompt, main.rs:120-123,169-174);
- TPU LM (optional, BASELINE.md config #5): decoder LM via models/gpt with
  the prompt actually used.
"""

from __future__ import annotations

import asyncio
import logging

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.kv.pool import PoolExhausted
from symbiont_tpu_torch.models.markov import MarkovModel
from symbiont_tpu_torch.schema import (
    GeneratedTextChunk,
    GeneratedTextMessage,
    GenerateTextTask,
    RawTextMessage,
    from_json,
    to_json_bytes,
)
from symbiont_tpu_torch.resilience import admission
from symbiont_tpu_torch.services.base import Service
from symbiont_tpu_torch.utils.ids import current_timestamp_ms
from symbiont_tpu_torch.utils.telemetry import child_headers, metrics, span

log = logging.getLogger(__name__)

# the reference's single hardcoded training sentence (main.rs:170) — kept as
# the cold-start corpus so an empty system still generates
SEED_CORPUS = (
    "Это первое предложение для обучения нашей марковской модели оно простое"
)


class TextGeneratorService(Service):
    name = "text_generator"

    def __init__(self, bus, lm_generate=None, lm_batcher=None, lm_stream=None,
                 train_on_ingest: bool = True, state_path=None,
                 lm_trainer=None, lm_train_min_chars: int = 512,
                 lm_train_steps: int = 2, lm_buffer_max_chars: int = 1 << 20,
                 journal=None, lm_resume=None,
                 resume_max_attempts: int = 5,
                 resume_backoff_s: float = 0.25):
        super().__init__(bus)
        # persistence (SURVEY.md §5.4): restore the learned chain; the
        # reference rebuilds from one constant at every boot (main.rs:169-173)
        self._state_path = state_path
        self._dirty = False
        self._last_save = 0.0
        restored = self._load_state()
        if restored is not None:
            self.markov = restored  # seed transitions already in the chain —
            # re-training them would double-count into the multiset weights
        else:
            self.markov = MarkovModel()
            self.markov.train(SEED_CORPUS)
        self.lm_generate = lm_generate  # (prompt, max_new, *, temperature=,
        #                                  top_k=) -> str | None
        #                                 (LmEngine.generate's signature)
        self.lm_batcher = lm_batcher  # GenBatcher | None (batches concurrent
        #                               requests into one decode)
        self.lm_stream = lm_stream  # Callable[..., Iterator[str]] | None —
        # when set, deltas stream out on events.text.generated.partial while
        # decoding; the final full message still rides events.text.generated
        # generation-session durability (resilience/genlog.py): the engine
        # APPENDS chunk snapshots; this service owns terminal mark_done —
        # recorded only AFTER the result is published, so a crash anywhere
        # in the publish window still leaves a resumable tail. lm_resume is
        # the adoption callable (LmEngine.generate_stream's signature with
        # task_id/stream/resume) driven by _handle_resume.
        self.journal = journal
        self.lm_resume = lm_resume
        self._resume_max_attempts = int(resume_max_attempts)
        self._resume_backoff_s = float(resume_backoff_s)
        self._resume_tasks: set = set()  # pending backoff republishes
        # usage metering / durability: pass tenant + task_id through to the
        # engine when the stream callable takes them (LmEngine.generate_stream
        # does; duck-typed test stubs may not — probed once here)
        self._stream_params = self._probe_params(lm_stream)
        self._resume_params = self._probe_params(lm_resume)
        self.train_on_ingest = train_on_ingest
        # online LM fine-tune (train/online.OnlineLmTrainer | None): the LM
        # analog of Markov's continuous learning — ingested text buffers
        # until the threshold, then a few optimizer steps run off the event
        # loop and the serving engine picks up the updated params
        self.lm_trainer = lm_trainer
        self._lm_train_min_chars = lm_train_min_chars
        self._lm_train_steps = lm_train_steps
        # bounded backlog: if ingest sustainedly outruns device training the
        # buffer drops OLDEST docs past this budget (counted in metrics)
        # instead of growing host memory without limit
        self._lm_buffer_max_chars = lm_buffer_max_chars
        self._lm_buffer: list = []
        self._lm_buffer_chars = 0
        self._lm_train_lock = asyncio.Lock()
        self._lm_train_task: asyncio.Task | None = None
        # in-flight generations by task_id → cancel Event (overload plane):
        # a tasks.generation.cancel for a task this replica is decoding
        # frees its batch row / closes its stream at the next chunk boundary
        self._inflight: dict = {}
        # cancels that arrived BEFORE their generation task: under overload
        # — exactly when cancellation matters — generate tasks sit bus-queued
        # behind in-flight work, so the SSE reader can vanish (and its cancel
        # arrive) while the task is still undelivered. Tombstone the id
        # (with its arrival time) so registration observes it; bounded,
        # oldest ids expire first, and a stale tombstone (past the TTL) is
        # ignored — the cancel fans out to EVERY replica, so on the ones
        # that never see the task it would otherwise lie in wait for an
        # id-reusing resubmission forever.
        self._cancelled_early: dict = {}
        self._cancelled_early_ttl_s = 60.0
        # ...but a cancel for a task that already FINISHED here must not
        # tombstone (it would silently kill a resubmission reusing the id)
        self._completed_recent: dict = {}

    @staticmethod
    def _probe_params(fn) -> frozenset:
        """Keyword params a duck-typed engine callable accepts — real
        engines take tenant/task_id/stream/resume, minimal test stubs may
        take none; probed once so per-request calls stay reflection-free."""
        if fn is None:
            return frozenset()
        import inspect

        try:
            return frozenset(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            return frozenset()

    def _journal_done(self, task_id: str) -> None:
        """Terminal journal marker — called after the task's outcome is
        PUBLISHED (or it was cancelled), never earlier: a crash between
        decode finishing and the publish must still resume on a survivor."""
        if self.journal is not None and task_id:
            self.journal.mark_done(task_id)

    async def _setup(self) -> None:
        await self._subscribe_loop(subjects.TASKS_GENERATION_TEXT,
                                   self._handle_generate,
                                   queue=subjects.QUEUE_TEXT_GENERATOR)
        # cancels fan out to EVERY replica (no queue group): only the one
        # decoding the task acts; everyone else ignores the unknown id
        await self._subscribe_loop(subjects.TASKS_GENERATION_CANCEL,
                                   self._handle_cancel)
        # orphaned-session adoption (resilience/genlog.py): the supervisor
        # republishes a dead worker's journal tails here; the queue group
        # makes exactly one survivor adopt each
        await self._subscribe_loop(subjects.TASKS_GENERATION_RESUME,
                                   self._handle_resume,
                                   queue=subjects.QUEUE_TEXT_GENERATOR)
        if self.train_on_ingest or self.lm_trainer is not None:
            # continuous learning from the pipeline (no queue group: every
            # generator replica learns the full stream)
            await self._subscribe_loop(subjects.DATA_RAW_TEXT_DISCOVERED,
                                       self._handle_train)

    async def _handle_cancel(self, msg: Msg) -> None:
        import json as _json

        try:
            task_id = _json.loads(msg.data).get("task_id")
        except (ValueError, AttributeError):
            return
        ev = self._inflight.get(task_id)
        metrics.inc("text_generator.cancel_requests")
        if ev is not None and not ev.is_set():
            ev.set()
            metrics.inc("text_generator.cancelled")
            log.info("generation %s cancelled (client disconnected)", task_id)
        elif ev is None and task_id and task_id not in self._completed_recent:
            import time as _time

            self._cancelled_early[task_id] = _time.monotonic()
            while len(self._cancelled_early) > 256:
                self._cancelled_early.pop(next(iter(self._cancelled_early)))

    async def _handle_train(self, msg: Msg) -> None:
        raw = from_json(RawTextMessage, msg.data)
        if self.train_on_ingest:
            self.markov.train(raw.raw_text)
            metrics.inc("text_generator.trained_docs")
            self._dirty = True
            await self._maybe_save()
        if self.lm_trainer is not None:
            self._lm_buffer.append(raw.raw_text)
            self._lm_buffer_chars += len(raw.raw_text)
            while (self._lm_buffer_chars > self._lm_buffer_max_chars
                   and len(self._lm_buffer) > 1):
                dropped = self._lm_buffer.pop(0)
                self._lm_buffer_chars -= len(dropped)
                metrics.inc("text_generator.lm_train_dropped_docs")
                metrics.inc("text_generator.lm_train_dropped_chars",
                            len(dropped))
            # fire-and-forget: the handler must NOT await the pass — parked
            # handler tasks would exhaust the service's handler semaphore and
            # stall every subscription (incl. generation requests) behind a
            # multi-second training pass. One background task drains the
            # buffer in a loop; docs arriving mid-pass buffer for its next
            # iteration.
            if (self._lm_buffer_chars >= self._lm_train_min_chars
                    and not self._lm_train_lock.locked()):
                self._lm_train_task = asyncio.create_task(
                    self._lm_train_pass(), name="lm-ingest-train")
                # fire-and-forget tasks swallow exceptions unless retrieved;
                # log every pass's failure the moment it happens instead of
                # staying silent until the threshold next crosses
                self._lm_train_task.add_done_callback(self._log_train_failure)

    @staticmethod
    def _log_train_failure(task: "asyncio.Task") -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            log.error("online LM fine-tune pass failed", exc_info=exc)
            metrics.inc("text_generator.lm_train_failures")

    async def _lm_train_pass(self) -> None:
        """Drain buffered ingest through fine-tune passes, off the event
        loop, until the buffer is below the threshold."""
        async with self._lm_train_lock:
            while self._lm_buffer_chars >= self._lm_train_min_chars:
                texts, self._lm_buffer, self._lm_buffer_chars = \
                    self._lm_buffer, [], 0
                with span("text_generator.lm_train", None, docs=len(texts)):
                    out = await asyncio.get_running_loop().run_in_executor(
                        None, lambda: self.lm_trainer.train_on_texts(
                            texts, steps=self._lm_train_steps))
                metrics.inc("text_generator.lm_train_passes")
                metrics.inc("text_generator.lm_train_docs", len(texts))
                loss = (float("nan") if out["loss"] is None
                        else out["loss"])  # 0.0 is a real, healthy loss
                log.info("online LM fine-tune: %d docs, %d steps, loss %.4f",
                         len(texts), out["steps"], loss)

    async def stop(self) -> None:
        await super().stop()
        await self._maybe_save(force=True)  # flush unsaved learning
        if self._lm_train_task is not None and not self._lm_train_task.done():
            # let an in-flight fine-tune pass finish (it persists its own
            # state); buffered-but-untrained text is the only loss on stop.
            # A failing pass must not abort shutdown — the done-callback
            # already logged it with traceback; just swallow here.
            try:
                await self._lm_train_task
            except Exception:
                pass

    # ------------------------------------------------- markov persistence

    def _load_state(self):
        if not self._state_path:
            return None
        import json
        from pathlib import Path

        try:
            raw = Path(self._state_path).read_text(encoding="utf-8")
        except OSError:
            return None  # first boot
        try:
            model = MarkovModel.from_state(json.loads(raw))
            log.info("markov state restored from %s (%d chain keys)",
                     self._state_path, len(model.chain))
            return model
        except Exception:
            log.exception("corrupt markov state at %s; starting fresh",
                          self._state_path)
            return None

    async def _maybe_save(self, force: bool = False) -> None:
        """Debounced persist: at most one save per window (per-doc O(chain)
        serialization would make cumulative ingest cost quadratic), JSON dump
        + file I/O in an executor so the event loop never stalls behind a
        large chain. The snapshot is copied on the loop first — the chain
        mutates between handler awaits."""
        import time

        if not self._state_path or not self._dirty:
            return
        now = time.monotonic()
        if not force and now - self._last_save < 2.0:
            return
        state = self.markov.to_state()
        snapshot = {"chain": {k: list(v) for k, v in state["chain"].items()},
                    "starters": list(state["starters"])}
        self._dirty = False
        self._last_save = now
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, self._write_state, snapshot)
        except Exception:
            # failed write (disk full, permissions): the delta is NOT saved —
            # re-mark dirty so the next window retries instead of silently
            # dropping learned state until a future ingest re-dirties it
            self._dirty = True
            log.exception("markov state save failed; will retry")

    def _write_state(self, snapshot: dict) -> None:
        import json
        import os
        from pathlib import Path

        path = Path(self._state_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(snapshot, ensure_ascii=False),
                       encoding="utf-8")
        os.replace(tmp, path)  # atomic: a crash never leaves a torn file

    async def _handle_generate(self, msg: Msg) -> None:
        task = from_json(GenerateTextTask, msg.data)
        import time as _time

        cancel = asyncio.Event()
        tombstone = self._cancelled_early.pop(task.task_id, None)
        if (tombstone is not None
                and _time.monotonic() - tombstone
                <= self._cancelled_early_ttl_s
                and task.task_id not in self._completed_recent):
            # the cancel raced ahead of the task across the two subjects:
            # honor it now or the decode runs its full budget for a reader
            # that is already gone (stale tombstones are ignored — see
            # _cancelled_early above). The recently-completed guard covers
            # the RETRY path too: a cancel landing during a failed
            # delivery's backoff tombstones, but if the task meanwhile
            # completed (this replica published its text), the redelivery
            # must be a no-op-ish rerun, not a poisoned cancel — same rule
            # _handle_cancel already applies to live tombstoning.
            cancel.set()
            metrics.inc("text_generator.cancelled")
        self._inflight[task.task_id] = cancel
        try:
            with span("text_generator.generate", msg.headers,
                      max_length=task.max_length):
                if self.lm_stream is not None and task.stream:
                    # per-request opt-in: a stream decodes chunk-by-chunk
                    # (the engine lock is released between chunks,
                    # lm.py:328-336) but still can't share one batched
                    # executable with other requests, so only explicit
                    # stream=true requests take it — everything else rides
                    # the micro-batcher
                    text = await self._stream_generate(task, msg.headers,
                                                       cancel)
                elif self.lm_batcher is not None:
                    # cancel frees the request's decode row at the next
                    # chunk boundary (GenBatcher → BatchSession.cancel_tag);
                    # the tenant header picks the fairness lane; task_id
                    # keys the row's crash-resume journal snapshots
                    text = await self.lm_batcher.generate(
                        task.prompt or "", task.max_length,
                        temperature=task.temperature, top_k=task.top_k,
                        cancel=cancel,
                        tenant=admission.tenant_of(msg.headers),
                        task_id=task.task_id)
                elif self.lm_generate is not None:
                    text = await asyncio.get_running_loop().run_in_executor(
                        None, lambda: self.lm_generate(
                            task.prompt or "", task.max_length,
                            temperature=task.temperature, top_k=task.top_k))
                else:
                    # Markov backend has no sampling knobs: temperature/top_k
                    # are accepted on the wire but ignored (documented in
                    # schema)
                    text = self.markov.generate(task.max_length)
        finally:
            self._inflight.pop(task.task_id, None)
        # completion is only recorded on the NORMAL path: a raised handler
        # will be retried (services/base.py), and a cancel landing during
        # its backoff must still tombstone so the retry aborts
        self._completed_recent[task.task_id] = True
        while len(self._completed_recent) > 256:
            self._completed_recent.pop(next(iter(self._completed_recent)))
        if text is None or cancel.is_set():
            # cancelled mid-decode: nobody is listening — no final event,
            # and the journal tail is terminal (a cancelled task must never
            # resurrect as a resume after a later worker death)
            self._journal_done(task.task_id)
            return
        out = GeneratedTextMessage(original_task_id=task.task_id,
                                   generated_text=text,
                                   timestamp_ms=current_timestamp_ms())
        await self.bus.publish(subjects.EVENTS_TEXT_GENERATED,
                               to_json_bytes(out),
                               headers=child_headers(msg.headers))
        metrics.inc("text_generator.generated")
        # mark the journal tail done only now — the result is on the bus
        self._journal_done(task.task_id)

    async def _stream_generate(self, task: GenerateTextTask, headers,
                               cancel=None, resume=None):
        """Drive the decode generator in an executor thread; every text delta
        crossing back is published as a GeneratedTextChunk before the next
        chunk even starts decoding. Returns the accumulated full text — or
        None when `cancel` was set mid-stream (the generator is CLOSED at
        the next chunk boundary, which runs its finally block and releases
        its decode state; the terminal done-chunk still goes out so any
        remaining consumer sees a clean close).

        `resume` (a journal tail record — resilience/genlog.py) switches the
        call into orphan adoption: the engine re-prefills the dead worker's
        prompt+generated prefix and replays its last journaled chunk, so
        seq numbering CONTINUES from the record (the SSE hub dedupes the
        replayed chunk by seq — exactly-once at the edge) and the returned
        full text prepends the text the dead worker already emitted.
        Partials are only published when the originating task streamed."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        if resume is not None:
            fn, params = self.lm_resume, self._resume_params
        else:
            fn, params = self.lm_stream, self._stream_params
        kw = {}
        if "tenant" in params:
            kw["tenant"] = (resume.get("tenant") if resume is not None
                            else admission.tenant_of(headers))
        if "task_id" in params:
            kw["task_id"] = task.task_id
        if resume is not None:
            if "stream" in params:
                kw["stream"] = bool(resume.get("stream"))
            kw["resume"] = resume

        def produce() -> None:
            gen = fn(task.prompt or "", task.max_length,
                     temperature=task.temperature,
                     top_k=task.top_k, **kw)
            try:
                for delta in gen:
                    if cancel is not None and cancel.is_set():
                        # closing the generator runs its finally (stats
                        # flushed, device state dropped) — the decode stops
                        # at this chunk instead of running out the budget
                        gen.close()
                        loop.call_soon_threadsafe(queue.put_nowait,
                                                  ("cancelled", None))
                        return
                    loop.call_soon_threadsafe(queue.put_nowait, ("delta", delta))
                loop.call_soon_threadsafe(queue.put_nowait, ("end", None))
            except BaseException as e:  # surface decode errors to the handler
                loop.call_soon_threadsafe(queue.put_nowait, ("error", e))

        producer = loop.run_in_executor(None, produce)
        parts: list = []
        seq = int(resume.get("seq") or 0) if resume is not None else 0
        publish_partials = (resume is None) or bool(resume.get("stream"))
        cancelled = False
        suppress_close = False
        try:
            while True:
                kind, payload = await queue.get()
                if kind == "delta":
                    parts.append(payload)
                    if publish_partials:
                        await self.bus.publish(
                            subjects.EVENTS_TEXT_GENERATED_PARTIAL,
                            to_json_bytes(GeneratedTextChunk(
                                original_task_id=task.task_id,
                                text_delta=payload,
                                seq=seq, done=False,
                                timestamp_ms=current_timestamp_ms())),
                            headers=child_headers(headers))
                        metrics.inc("text_generator.stream_chunks")
                    seq += 1
                elif kind == "end":
                    break
                elif kind == "cancelled":
                    cancelled = True
                    break
                else:
                    if resume is not None and isinstance(payload,
                                                        PoolExhausted):
                        # transient admission refusal: the stream is NOT
                        # over — the requeued resume continues it; a done
                        # chunk here would close the waiting client early
                        suppress_close = True
                    raise payload
        finally:
            await producer
            if publish_partials and not suppress_close:
                # terminal chunk ALWAYS goes out — on a decode error too, so
                # stream consumers get a close signal instead of hanging
                await self.bus.publish(
                    subjects.EVENTS_TEXT_GENERATED_PARTIAL,
                    to_json_bytes(GeneratedTextChunk(
                        original_task_id=task.task_id, text_delta="", seq=seq,
                        done=True, timestamp_ms=current_timestamp_ms())),
                    headers=child_headers(headers))
        if cancelled:
            return None
        prefix = (resume.get("text") or "") if resume is not None else ""
        return prefix + "".join(parts)

    # ------------------------------------------ orphaned-session adoption

    async def _handle_resume(self, msg: Msg) -> None:
        """Adopt one orphaned generation session (docs/RESILIENCE.md
        "Durable generation sessions"): the supervisor republished a dead
        worker's journal tail as {"task_id", "record", "attempt"}. The
        engine re-prefills the journaled prompt+generated prefix and
        continues the stream with monotonic seq; the SSE hub dedupes the
        one replayed chunk — the client-observed token sequence stays
        exactly-once and (greedy) token-identical to an unkilled run."""
        import json as _json
        import time as _time

        try:
            payload = _json.loads(msg.data)
        except (ValueError, AttributeError):
            return
        rec = payload.get("record") or {}
        task_id = payload.get("task_id") or rec.get("task_id")
        attempt = int(payload.get("attempt") or 0)
        if not task_id:
            return
        if self.lm_resume is None or not rec.get("prompt_ids"):
            # no adoption-capable engine in this replica / torn record:
            # counted loudly — this is the stream staying lost
            metrics.inc("gen.resume_abandoned")
            log.warning("cannot adopt orphaned generation %s "
                        "(engine=%s, record ok=%s)", task_id,
                        self.lm_resume is not None,
                        bool(rec.get("prompt_ids")))
            return
        # resume-races-cancel: the client hung up before the worker died —
        # its cancel fanned out to every replica and tombstoned the id here.
        # Honor the tombstone: drop the resume instead of decoding for a
        # reader that is gone.
        tombstone = self._cancelled_early.pop(task_id, None)
        if (tombstone is not None
                and _time.monotonic() - tombstone
                <= self._cancelled_early_ttl_s):
            metrics.inc("gen.resume_dropped_cancelled")
            log.info("dropping resume for cancelled generation %s", task_id)
            return
        if task_id in self._completed_recent:
            # this replica already published the task's text (the orphan
            # was a journal tail whose done-marker died with the worker)
            metrics.inc("gen.resume_dropped_completed")
            return
        task = GenerateTextTask(
            task_id=task_id, prompt="",
            max_length=int(rec.get("max_new") or 1),
            stream=bool(rec.get("stream")),
            temperature=rec.get("temperature"), top_k=rec.get("top_k"))
        cancel = asyncio.Event()
        self._inflight[task_id] = cancel
        try:
            with span("text_generator.resume", msg.headers,
                      attempt=attempt, tokens=len(rec.get("tokens") or ())):
                text = await self._stream_generate(task, msg.headers,
                                                   cancel, resume=rec)
        except PoolExhausted:
            # resume-under-pressure: the adopting engine refused admission
            # (no KV headroom). Re-queue bounded-with-backoff — the orphan
            # outlives a pressure spike instead of dying to it.
            await self._requeue_resume(task_id, rec, attempt)
            return
        finally:
            self._inflight.pop(task_id, None)
        self._completed_recent[task_id] = True
        while len(self._completed_recent) > 256:
            self._completed_recent.pop(next(iter(self._completed_recent)))
        if text is None or cancel.is_set():
            self._journal_done(task_id)
            return
        await self.bus.publish(
            subjects.EVENTS_TEXT_GENERATED,
            to_json_bytes(GeneratedTextMessage(
                original_task_id=task_id, generated_text=text,
                timestamp_ms=current_timestamp_ms())),
            headers=child_headers(msg.headers))
        metrics.inc("text_generator.generated")
        self._journal_done(task_id)

    async def _requeue_resume(self, task_id: str, rec: dict,
                              attempt: int) -> None:
        """Bounded exponential-backoff republish of a pressure-refused
        resume. Fire-and-forget sleep task: parking the handler itself
        would eat a handler-semaphore slot for the whole backoff."""
        import json as _json

        if attempt + 1 >= self._resume_max_attempts:
            metrics.inc("gen.resume_abandoned")
            log.warning("orphaned generation %s abandoned after %d "
                        "pressure-refused resume attempts", task_id,
                        attempt + 1)
            return
        metrics.inc("gen.resume_requeued")
        delay = self._resume_backoff_s * (2 ** attempt)
        body = _json.dumps({"task_id": task_id, "record": rec,
                            "attempt": attempt + 1}).encode()

        async def later() -> None:
            await asyncio.sleep(delay)
            await self.bus.publish(subjects.TASKS_GENERATION_RESUME, body)

        t = asyncio.create_task(later(), name=f"gen-resume-requeue-{task_id}")
        self._resume_tasks.add(t)
        t.add_done_callback(self._resume_tasks.discard)
