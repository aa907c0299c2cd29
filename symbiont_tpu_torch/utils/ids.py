"""ID + timestamp helpers.

Copy of the JAX package's `symbiont_tpu/utils/ids.py`.

Parity with the reference's two shared helpers
(reference: libs/shared_models/src/lib.rs:112-121).
"""

from __future__ import annotations

import time
import uuid


def current_timestamp_ms() -> int:
    """Milliseconds since the Unix epoch (u64 semantics in the wire schema)."""
    return int(time.time() * 1000)


def generate_uuid() -> str:
    """Random UUIDv4 string, the id format used on every wire message."""
    return str(uuid.uuid4())


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def deterministic_point_id(doc_id: str, order: int) -> str:
    """Deterministic UUID-shaped id for a (document, sentence_order) pair.

    The reference mints a random uuid per point per upsert attempt
    (reference: services/vector_memory_service/src/main.rs:142-177), which is
    fine at-most-once but duplicates points when a durable stream redelivers
    an embeddings message whose ack was lost. A content-derived id makes the
    upsert idempotent: the retry overwrites the same point. Implemented
    identically in C++ (native/services/common.hpp) so mixed-language workers
    in one queue group converge on the same ids.
    """
    key = f"{doc_id}\x00{order}".encode()
    hi = _fnv1a64(key)
    lo = _fnv1a64(key + b"\x01")
    hi = (hi & 0xFFFFFFFFFFFF0FFF) | 0x0000000000005000  # version 5 nibble
    lo = (lo & 0x3FFFFFFFFFFFFFFF) | 0x8000000000000000  # variant 10
    return (f"{hi >> 32:08x}-{(hi >> 16) & 0xFFFF:04x}-{hi & 0xFFFF:04x}-"
            f"{lo >> 48:04x}-{(lo >> 32) & 0xFFFF:04x}{lo & 0xFFFFFFFF:08x}")
