"""Single-source wire schema.

Copy of the JAX package's `symbiont_tpu/schema/__init__.py`.

The reference keeps its wire schema in Rust serde structs
(reference: libs/shared_models/src/lib.rs:3-110) and hand-duplicates the same
shapes as TypeScript interfaces in the frontend
(reference: frontend/src/app/page.tsx:7-48) — an acknowledged hand-sync hazard.
Here the schema has exactly ONE source (these dataclasses); the C++ header and
TS interfaces are *generated* from it (see symbiont_tpu_torch.schema.codegen), so the
sync bug class cannot exist.

All 13 wire structs from the reference are present with identical field names
and JSON shapes, so the reference frontend and any NATS-speaking peer remain
wire-compatible. Optional fields serialize as JSON null (serde's Option
behavior).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

# Registry of all wire structs, in reference declaration order
# (reference: libs/shared_models/src/lib.rs:3-110).
WIRE_TYPES: list[type] = []


def wire(cls: type) -> type:
    """Register a dataclass as a wire struct (adds JSON round-trip methods)."""
    cls = dataclass(cls)
    cls.__wire_hints__ = typing.get_type_hints(cls)  # cached: decode hot path
    WIRE_TYPES.append(cls)
    return cls


_U64_SAFE_MAX = 2**53  # double-mantissa bound shared with the C++ decoder


def _encode(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _encode(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, int) and not isinstance(value, bool):
        # wire ints are u64 (serde side); enforce at the producer so a bad
        # value fails here, not in a remote C++ worker's as_u64()
        if not 0 <= value < _U64_SAFE_MAX:
            raise ValueError(f"integer {value} outside u64-safe range [0, 2^53)")
    return value


def _decode(tp: Any, value: Any) -> Any:
    origin = get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _decode(args[0], value)
    if origin in (list, List):
        if not isinstance(value, list):
            raise ValueError(f"expected array, got {type(value).__name__}")
        (elem,) = get_args(tp)
        return [_decode(elem, v) for v in value]
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if tp is float:
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise ValueError(f"expected number, got {type(value).__name__}")
        return float(value)
    if tp is int:
        if not isinstance(value, int) or isinstance(value, bool):
            raise ValueError(f"expected integer, got {type(value).__name__}")
        if not 0 <= value < _U64_SAFE_MAX:
            raise ValueError(f"integer {value} outside u64-safe range [0, 2^53)")
        return value
    if tp is bool:
        if not isinstance(value, bool):
            raise ValueError(f"expected boolean, got {type(value).__name__}")
        return value
    if tp is str and not isinstance(value, str):
        raise ValueError(f"expected string, got {type(value).__name__}")
    return value


def from_dict(cls: Type[T], data: dict) -> T:
    """Strict decode: unknown fields rejected, missing non-optional fields raise."""
    hints = getattr(cls, "__wire_hints__", None) or typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _decode(hints[f.name], data[f.name])
        elif _is_optional(hints[f.name]):
            kwargs[f.name] = None
        else:
            raise ValueError(f"{cls.__name__}: missing required field {f.name!r}")
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**kwargs)


def _is_optional(tp: Any) -> bool:
    return get_origin(tp) is typing.Union and type(None) in get_args(tp)


def to_json(msg: Any) -> str:
    # allow_nan=False: a NaN/Inf embedding value must fail at the producer,
    # not poison the bus for serde_json/C++ consumers.
    return json.dumps(_encode(msg), ensure_ascii=False, separators=(",", ":"),
                      allow_nan=False)


def to_json_bytes(msg: Any) -> bytes:
    return to_json(msg).encode("utf-8")


def from_json(cls: Type[T], raw: str | bytes) -> T:
    if isinstance(raw, (bytes, bytearray)):
        raw = raw.decode("utf-8")
    return from_dict(cls, json.loads(raw))


# ---------------------------------------------------------------------------
# The 13 wire structs (reference: libs/shared_models/src/lib.rs:3-110)
# ---------------------------------------------------------------------------


@wire
class PerceiveUrlTask:
    """reference: libs/shared_models/src/lib.rs:4-6"""

    url: str


@wire
class RawTextMessage:
    """reference: libs/shared_models/src/lib.rs:9-14"""

    id: str
    source_url: str
    raw_text: str
    timestamp_ms: int


@wire
class TokenizedTextMessage:
    """reference: libs/shared_models/src/lib.rs:17-23"""

    original_id: str
    source_url: str
    tokens: List[str]
    sentences: List[str]
    timestamp_ms: int


@wire
class GenerateTextTask:
    """reference: libs/shared_models/src/lib.rs:26-30

    `stream`, `temperature` and `top_k` are this framework's additions:
    when true (and an LM backend with streaming is active), `stream` sends
    token deltas out on events.text.generated.partial while decoding;
    `temperature`/`top_k` override the LM engine's sampling defaults per
    request (temperature 0 = greedy; ignored by the Markov backend, which
    has no sampling knobs). All optional, so reference-era clients (which
    omit them) remain wire-compatible — and unstreamed requests keep riding
    the generation micro-batcher."""

    task_id: str
    prompt: Optional[str]
    max_length: int
    stream: Optional[bool] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None


@wire
class GeneratedTextMessage:
    """reference: libs/shared_models/src/lib.rs:33-37"""

    original_task_id: str
    generated_text: str
    timestamp_ms: int


@wire
class SentenceEmbedding:
    """reference: libs/shared_models/src/lib.rs:40-43"""

    sentence_text: str
    embedding: List[float]


@wire
class TextWithEmbeddingsMessage:
    """reference: libs/shared_models/src/lib.rs:46-52"""

    original_id: str
    source_url: str
    embeddings_data: List[SentenceEmbedding]
    model_name: str
    timestamp_ms: int


@wire
class SemanticSearchApiRequest:
    """reference: libs/shared_models/src/lib.rs:55-58

    `rerank` is this framework's addition (BASELINE.md config #4): when true,
    the gateway reranks the top-k hits with the cross-encoder and replaces
    each hit's score with the cross-encoder relevance score. Optional, so
    reference-era clients (which omit it) remain wire-compatible.
    """

    query_text: str
    top_k: int
    rerank: Optional[bool] = None


@wire
class QueryForEmbeddingTask:
    """reference: libs/shared_models/src/lib.rs:61-64"""

    request_id: str
    text_to_embed: str


@wire
class QueryEmbeddingResult:
    """reference: libs/shared_models/src/lib.rs:67-72"""

    request_id: str
    embedding: Optional[List[float]]
    model_name: Optional[str]
    error_message: Optional[str]


@wire
class QdrantPointPayload:
    """reference: libs/shared_models/src/lib.rs:75-82

    Name kept for wire parity even though our vector store is TPU-native
    (symbiont_tpu_torch.memory), not Qdrant.
    """

    original_document_id: str
    source_url: str
    sentence_text: str
    sentence_order: int
    model_name: str
    processed_at_ms: int


@wire
class SemanticSearchNatsTask:
    """reference: libs/shared_models/src/lib.rs:85-89"""

    request_id: str
    query_embedding: List[float]
    top_k: int


@wire
class SemanticSearchResultItem:
    """reference: libs/shared_models/src/lib.rs:92-96"""

    qdrant_point_id: str
    score: float
    payload: QdrantPointPayload


@wire
class SemanticSearchNatsResult:
    """reference: libs/shared_models/src/lib.rs:99-103"""

    request_id: str
    results: List[SemanticSearchResultItem]
    error_message: Optional[str]


@wire
class SemanticSearchApiResponse:
    """reference: libs/shared_models/src/lib.rs:106-110"""

    search_request_id: str
    results: List[SemanticSearchResultItem]
    error_message: Optional[str]


@wire
class GeneratedTextChunk:
    """This framework's addition (no reference equivalent): a streaming
    delta on events.text.generated.partial. The final full text still goes
    out as GeneratedTextMessage on events.text.generated, so reference-era
    consumers are unaffected; streaming clients append deltas by
    (original_task_id, seq) and stop at done=true."""

    original_task_id: str
    text_delta: str
    seq: int
    done: bool
    timestamp_ms: int


__all__ = [t.__name__ for t in WIRE_TYPES] + [
    "WIRE_TYPES",
    "to_json",
    "to_json_bytes",
    "from_json",
    "from_dict",
]
