"""Generation-session journal — the durability plane's write-ahead log.

Copy of the JAX package's `symbiont_tpu/resilience/genlog.py`.

Each generator role appends one self-contained JSONL snapshot per decode
chunk (engine/lm.py, at the chunk boundary's EXISTING device→host sync —
journaling adds no device syncs) to `<dir>/<role>.genlog`. The LAST record
per task is the full resume state: prompt token ids, sampling params, PRNG
key state, generated-so-far ids, and the stream's next SSE seq. When the
process supervisor declares the role dead (exit, hang verdict, or drain
deadline SIGKILL), it scans the file, rotates it aside, and republishes the
live tails as tasks.generation.resume — a surviving replica re-prefills the
prompt+generated prefix and continues the stream token-identically
(docs/RESILIENCE.md "Durable generation sessions").

Failure stance: a journal write error DISABLES the journal for this process
(counted gen.journal_errors, warned once) and generation continues — the
store being down degrades to today's lose-the-stream-on-kill behavior, it
never takes the decode path down with it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

# journal record fields (one dict per line; unknown fields tolerated):
#   task_id      str   — required; last record per task wins
#   done         bool  — terminal marker: the stream finished/cancelled here
#   tenant       str
#   stream       bool  — original task wanted chunk deltas (vs batch-only)
#   prompt_ids   [int] — EXACT post-trim prompt ids the prefill consumed
#   max_new      int   — the request's total new-token budget
#   temperature  float
#   top_k        int
#   tokens       [int] — ALL generated ids so far, incl. the latest chunk
#   chunk_start  int   — index in `tokens` where the latest chunk begins
#                        (resume re-emits exactly that chunk's text delta:
#                        duplicates are deduped by seq at the SSE hub, so a
#                        delta the client never saw is never lost)
#   text         str   — emitted text BEFORE the latest chunk's delta (lets
#                        the adopting replica reassemble the full final text
#                        without re-decoding from token 0)
#   seq          int   — the SSE seq the latest chunk's delta carries
#   key          [int] — PRNG key_data (uint32) of the stream's BASE key;
#                        None for greedy / batch-session rows
#   key_splits   int   — chunk-splits consumed on that base so far (resume
#                        re-derives the live key host-side: wrap + advance —
#                        no per-chunk key transfer rides the decode loop)
#   ts           int   — wall-clock ms (observability only)


class GenJournal:
    """Bounded append-only JSONL WAL with an in-memory tail mirror.

    Thread-safe: appends come from engine executor threads (the stream
    producer and BatchSession.step run off the event loop). Compaction is
    piggybacked on append — past max_bytes the file is rewritten keeping
    only live tasks' tail records; past max_tasks the oldest live task is
    evicted (counted)."""

    def __init__(self, path, max_bytes: int = 8 * 1024 * 1024,
                 max_tasks: int = 512, fsync: bool = False):
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.max_tasks = int(max_tasks)
        self.fsync = bool(fsync)
        self.enabled = True
        self._lock = threading.Lock()
        self._tails: Dict[str, dict] = {}  # live task -> last record
        self._bytes = 0
        # reload survivors from a previous incarnation of THIS role (crash
        # between supervisor scan windows); they stay until done/evicted
        existing = _read_tails(self.path)
        if existing:
            self._tails.update(existing)
            try:
                self._bytes = self.path.stat().st_size
            except OSError:
                self._bytes = 0
            log.warning("gen journal %s: %d live session(s) recovered",
                        self.path, len(existing))
        metrics.gauge_set("gen.journal_tasks", len(self._tails))
        metrics.gauge_set("gen.journal_bytes", self._bytes)

    # ------------------------------------------------------------- writes

    def append(self, record: dict) -> None:
        """Persist one chunk-boundary snapshot. Must carry task_id."""
        if not self.enabled:
            return
        task_id = record.get("task_id")
        if not task_id:
            return
        record.setdefault("ts", int(time.time() * 1000))
        with self._lock:
            try:
                self._write_line(record)
            except OSError:
                self._degrade()
                return
            self._tails[task_id] = record
            # keep insertion order ≈ recency so eviction drops the oldest
            self._tails[task_id] = self._tails.pop(task_id)
            while len(self._tails) > self.max_tasks:
                victim, _ = next(iter(self._tails.items()))
                self._tails.pop(victim)
                metrics.inc("gen.journal_evicted")
            if self._bytes > self.max_bytes:
                try:
                    self._compact()
                except OSError:
                    self._degrade()
                    return
        metrics.inc("gen.journal_appends")
        metrics.gauge_set("gen.journal_tasks", len(self._tails))
        metrics.gauge_set("gen.journal_bytes", self._bytes)

    def mark_done(self, task_id: str) -> None:
        """Terminal marker: the stream finished (or was cancelled) here —
        the task must never be resumed from this journal."""
        if not self.enabled or not task_id:
            return
        with self._lock:
            if task_id not in self._tails:
                return
            self._tails.pop(task_id, None)
            try:
                self._write_line({"task_id": task_id, "done": True})
            except OSError:
                self._degrade()
                return
        metrics.gauge_set("gen.journal_tasks", len(self._tails))
        metrics.gauge_set("gen.journal_bytes", self._bytes)

    def live_tails(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._tails)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tails)

    # ------------------------------------------------------------ innards

    def _write_line(self, record: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self._bytes += len(line.encode("utf-8"))

    def _compact(self) -> None:
        """Rewrite keeping only live tails (atomic replace — a crash mid-
        compaction leaves either the old or the new file, never a torn
        one)."""
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        size = 0
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in self._tails.values():
                line = json.dumps(rec, separators=(",", ":")) + "\n"
                f.write(line)
                size += len(line.encode("utf-8"))
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._bytes = size
        metrics.inc("gen.journal_compactions")

    def _degrade(self) -> None:
        """Journal store down ⇒ keep generating WITHOUT durability (the
        pre-journal behavior), loudly."""
        self.enabled = False
        metrics.inc("gen.journal_errors")
        log.exception("gen journal %s write failed; generation-session "
                      "durability DISABLED for this process (streams killed "
                      "from here on are lost, pre-journal behavior)",
                      self.path)

    # ----------------------------------------------------- supervisor side

    @staticmethod
    def take_orphans(path) -> Dict[str, dict]:
        """Scan a dead role's journal for live session tails and rotate the
        file aside (so the restarted role starts fresh and a later scan
        cannot double-republish). Returns {task_id: tail record}. Pure
        blocking file I/O — callers on an event loop must run it in an
        executor."""
        path = Path(path)
        tails = _read_tails(path)
        if path.exists():
            try:
                os.replace(path, path.with_suffix(path.suffix + ".orphaned"))
            except OSError:
                log.warning("gen journal %s: rotate-aside failed", path,
                            exc_info=True)
        return tails


def _read_tails(path) -> Dict[str, dict]:
    """Last record per task, done-marked tasks removed; corrupt lines (a
    torn final append from the SIGKILL itself) are skipped."""
    path = Path(path)
    tails: Dict[str, dict] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    log.warning("gen journal %s: skipping corrupt line %d",
                                path, ln)
                    continue
                task_id = rec.get("task_id")
                if not task_id:
                    continue
                if rec.get("done"):
                    tails.pop(task_id, None)
                else:
                    tails[task_id] = rec
    except OSError:
        return {}
    return tails
