"""Dead-letter quarantine: the bounded, inspectable store behind

Copy of the JAX package's `symbiont_tpu/resilience/dlq.py`.
`GET /api/dlq`.

A durable delivery that exhausts `max_deliver` is poison — redelivering it
forever would wedge the consumer group (SURVEY.md §5.3: the reference's
answer is to drop it on the floor). Instead the inproc durable layer
publishes it to `dlq.<original-subject>` with failure headers AND parks the
full message here, where an operator can list, inspect, and replay it after
fixing the handler.

Bounded ring (oldest quarantined entry evicted first, with a counter — a
poison flood must not OOM the process). Metrics: `dlq.quarantined` /
`dlq.replayed` / `dlq.evicted` counters (subject-labeled) and a `dlq.size`
gauge.
"""

from __future__ import annotations

import base64
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from symbiont_tpu_torch.utils.ids import current_timestamp_ms
from symbiont_tpu_torch.utils.telemetry import metrics

# headers stamped on the dlq.<subject> publication and on replayed messages
REASON_HEADER = "X-Symbiont-DLQ-Reason"
STREAM_HEADER = "X-Symbiont-DLQ-Stream"
GROUP_HEADER = "X-Symbiont-DLQ-Group"
DELIVERIES_HEADER = "X-Symbiont-DLQ-Deliveries"
REPLAY_HEADER = "X-Symbiont-Replayed"


@dataclass
class DeadLetter:
    id: int
    subject: str
    data: bytes
    headers: Dict[str, str]
    reason: str
    stream: str
    group: str
    deliveries: int
    quarantined_at_ms: int = field(default_factory=current_timestamp_ms)

    def summary(self, preview_bytes: int = 256) -> dict:
        """JSON-safe view: payload as a bounded UTF-8 preview plus full
        base64 (binary payloads must survive the round trip)."""
        return {
            "id": self.id,
            "subject": self.subject,
            "reason": self.reason,
            "stream": self.stream,
            "group": self.group,
            "deliveries": self.deliveries,
            "quarantined_at_ms": self.quarantined_at_ms,
            "data_preview": self.data[:preview_bytes].decode(
                "utf-8", errors="replace"),
            "data_b64": base64.b64encode(self.data).decode("ascii"),
            "headers": dict(self.headers),
        }


class DeadLetterStore:
    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("dlq capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, DeadLetter]" = OrderedDict()
        self._next_id = 1

    def quarantine(self, subject: str, data: bytes,
                   headers: Optional[Dict[str, str]], *, reason: str,
                   stream: str = "", group: str = "",
                   deliveries: int = 0) -> DeadLetter:
        with self._lock:
            entry = DeadLetter(self._next_id, subject, bytes(data),
                               dict(headers or {}), reason, stream, group,
                               deliveries)
            self._next_id += 1
            self._entries[entry.id] = entry
            while len(self._entries) > self.capacity:
                old_id, old = self._entries.popitem(last=False)
                metrics.inc("dlq.evicted", labels={"subject": old.subject})
            size = len(self._entries)
        metrics.inc("dlq.quarantined", labels={"subject": subject})
        metrics.gauge_set("dlq.size", size)
        return entry

    def get(self, entry_id: int) -> Optional[DeadLetter]:
        with self._lock:
            return self._entries.get(entry_id)

    def list(self) -> List[DeadLetter]:
        with self._lock:
            return list(self._entries.values())

    def remove(self, entry_id: int) -> Optional[DeadLetter]:
        with self._lock:
            entry = self._entries.pop(entry_id, None)
            size = len(self._entries)
        if entry is not None:
            metrics.gauge_set("dlq.size", size)
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    async def replay(self, bus, entry_id: Optional[int] = None) -> int:
        """Republish quarantined message(s) to their ORIGINAL subject —
        with the stream still capturing it, a replayed message re-enters
        the durable flow with a fresh delivery budget. Entries are removed
        only after the publish succeeds. Returns the replay count."""
        targets = ([e for e in (self.get(entry_id),) if e is not None]
                   if entry_id is not None else self.list())
        replayed = 0
        for entry in targets:
            headers = {k: v for k, v in entry.headers.items()
                       if not k.startswith("X-Symbiont-DLQ")}
            headers[REPLAY_HEADER] = "1"
            await bus.publish(entry.subject, entry.data, headers=headers)
            self.remove(entry.id)
            metrics.inc("dlq.replayed", labels={"subject": entry.subject})
            replayed += 1
        return replayed
