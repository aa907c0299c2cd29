"""Binary tensor frames — the zero-copy bulk-float data plane on the bus.

Copy of the JAX package's `symbiont_tpu/schema/frames.py`.

docs/PERF.md attributes the 5.5× gap between full-stack ingest and the
engine-plane bulk number largely to host-side (de)serialization: every
embedding hop used to JSON-encode 384 floats per sentence, and each f32
that rode through Python `float()` serialized as the ~17-digit shortest
round-trip of its DOUBLE widening (~19-20 bytes per float on the wire).
The accelerator-feeding literature makes the same point (Demystifying
BERT, arxiv 2104.08335; LightSeq, arxiv 2010.13887): for small encoder
models, host serialization and data movement — not the forward pass — is
where throughput dies.

A tensor frame is a fixed 16-byte header + packed little-endian f32 rows:

    offset 0   magic  b"SYTF"
    offset 4   u8     version (1)
    offset 5   u8     dtype   (1 = f32 little-endian, 2 = f16 little-endian)
    offset 6   u16le  reserved (0)
    offset 8   u32le  rows
    offset 12  u32le  cols
    offset 16  rows * cols * elem_size bytes, row-major (elem_size 4 for
               f32, 2 for the half-width f16 form; consumers upcast on
               ingest — VectorStore.upsert_rows takes any float dtype)

The frame rides APPENDED to the ordinary JSON message body; the
`X-Symbiont-Frame` content-type header (`tensor/f32;off=<n>`, where `n`
is the JSON prefix length in bytes) announces it. JSON metadata — ids,
sentence texts, source url — stays in the JSON prefix, which remains a
schema-valid message whose per-sentence `embedding` lists are empty.
Decode is `np.frombuffer` — a zero-copy view, no per-float Python
object is ever materialized.

Negotiation and the fallback contract:

- request-reply (engine plane): the REQUESTER opts in per call with
  `"encoding": "frame"`; an old engine ignores the unknown value and
  replies with JSON float lists, which every caller still accepts.
- pub/sub (data.text.with_embeddings): a broadcast has no per-consumer
  negotiation, so the publisher side is a deployment knob —
  `SYMBIONT_FRAMES` (default on; set `0` when a reference-era JSON-only
  consumer shares the subject). With frames off, the encoder emits the
  exact reference wire shape (float lists), byte-compatible with any
  serde_json peer. Frame-capable consumers accept BOTH forms always, so
  mixed old/new fleets interoperate in either direction.

The native C++ mirror of this codec lives in native/services/common.hpp
(make_frame / split_frame); tests/test_frames.py pins the byte layout
with golden fixtures shared by both implementations.
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from symbiont_tpu_torch.schema import (
    SentenceEmbedding,
    TextWithEmbeddingsMessage,
    from_json,
    to_json_bytes,
)
from symbiont_tpu_torch.utils.telemetry import metrics

FRAME_HEADER = "X-Symbiont-Frame"
# Request-reply negotiation for REPLY frames on reference-parity schema
# subjects (tasks.embedding.for_query): the requester announces frame
# capability with this HEADER instead of a schema field — the wire body
# stays byte-identical for reference-era peers, and a peer that has never
# heard of the header simply ignores it and replies JSON float lists (the
# fallback every caller accepts). Engine-plane subjects keep their in-body
# `"encoding": "frame"` negotiation (framework-internal JSON, no parity
# constraint).
ACCEPT_FRAME_HEADER = "X-Symbiont-Accept-Frame"
FRAME_MAGIC = b"SYTF"
FRAME_VERSION = 1
DTYPE_F32 = 1
DTYPE_F16 = 2  # IEEE half — half the bytes/embedding on every frame hop
# magic, version, dtype, reserved, rows, cols — 16 bytes, little-endian
_HDR = struct.Struct("<4sBBHII")
FRAME_HDR_LEN = _HDR.size

# ONE home for the dtype registry: name ↔ header byte ↔ numpy dtype ↔
# content type. Services never hard-code any of these (statically banned
# outside one allowlisted encoder — tests/test_pipeline_wiring.py); a new
# dtype is added HERE and nowhere else.
_DTYPE_BY_NAME = {"f32": DTYPE_F32, "f16": DTYPE_F16}
_NAME_BY_DTYPE = {v: k for k, v in _DTYPE_BY_NAME.items()}
_NP_BY_DTYPE = {DTYPE_F32: "<f4", DTYPE_F16: "<f2"}
_SIZE_BY_DTYPE = {DTYPE_F32: 4, DTYPE_F16: 2}
_CONTENT_TYPE_BY_DTYPE = {code: f"tensor/{name}"
                          for name, code in _DTYPE_BY_NAME.items()}
_KNOWN_CONTENT_TYPES = set(_CONTENT_TYPE_BY_DTYPE.values())


class FrameError(ValueError):
    """Malformed frame or frame/metadata mismatch (handler-fatal: the
    delivery stays unacked for redelivery / DLQ, never silently dropped)."""


def wants_frame(headers: Optional[Dict[str, str]]) -> bool:
    """True when the requester announced frame capability for the REPLY
    (ACCEPT_FRAME_HEADER: "1"). Absent/other → reply JSON float lists."""
    return (headers or {}).get(ACCEPT_FRAME_HEADER) == "1"


def frames_mode(default: str = "f32") -> str:
    """Publisher-side deployment knob for the pub/sub hops, now three-way:
    "off" (reference wire JSON), "f32" (the default frame form every
    frame-capable peer decodes), or "f16" (half-width rows — deploy only
    when every consumer on the subject decodes dtype 2; an f32-only
    consumer FrameErrors the delivery into redelivery/DLQ rather than
    ingesting garbage, see docs/QUANTIZATION.md). Request-reply paths
    negotiate per call instead (`encoding` / ACCEPT_FRAME_HEADER)."""
    v = os.environ.get("SYMBIONT_FRAMES", "").strip().lower()
    if not v:
        return default
    if v in ("0", "false", "no", "off"):
        return "off"
    if v in _DTYPE_BY_NAME:
        return v
    return "f32"


def frames_enabled(default: bool = True) -> bool:
    """Back-compat boolean view of frames_mode (the pre-f16 knob)."""
    return frames_mode("f32" if default else "off") != "off"


def _estimate_json_bytes_per_float() -> float:
    """Measured-once estimate of what one embedding float costs as wire
    JSON (the `frame.json_equiv_bytes` counter's multiplier): a seeded f32
    sample through the exact legacy path (f32 → Python float → json.dumps),
    which serializes as the shortest round-trip of the DOUBLE widening.
    The serialization bench tier measures the real ratio per run; this
    constant only feeds the obs counters."""
    rng = np.random.default_rng(0)
    sample = rng.standard_normal(64).astype(np.float32).tolist()
    return (len(json.dumps(sample, separators=(",", ":"))) - 1) / len(sample)


JSON_BYTES_PER_FLOAT_EST = _estimate_json_bytes_per_float()


# ----------------------------------------------------------------- raw codec

def encode_frame(rows: np.ndarray, dtype: str = "f32") -> bytes:
    """Pack a [rows, cols] float array as one frame (header + packed
    little-endian rows in `dtype`: "f32" or the half-width "f16")."""
    code = _DTYPE_BY_NAME.get(dtype)
    if code is None:
        raise FrameError(f"unsupported frame dtype {dtype!r} "
                         f"(known: {sorted(_DTYPE_BY_NAME)})")
    with np.errstate(over="ignore"):  # overflow handled explicitly below
        arr = np.ascontiguousarray(np.asarray(rows,
                                              dtype=_NP_BY_DTYPE[code]))
    if arr.ndim != 2:
        raise FrameError(f"frame payload must be 2-D, got shape {arr.shape}")
    if code == DTYPE_F16 and np.isinf(arr).any():
        src = np.asarray(rows)
        if (np.isinf(arr) & np.isfinite(src)).any():
            # a finite value beyond ±65504 became inf in the half cast:
            # refuse to frame rather than ship silent corruption (an inf
            # row poisons every cosine against it downstream). Same
            # loud-failure stance as an undecodable dtype byte.
            raise FrameError(
                "value(s) exceed the f16 range (|x| > 65504): refusing to "
                "encode a half-width frame that would overflow to inf — "
                "use the f32 form for unnormalized payloads")
    t0 = time.perf_counter()
    out = _HDR.pack(FRAME_MAGIC, FRAME_VERSION, code, 0,
                    arr.shape[0], arr.shape[1]) + arr.tobytes()
    labels = {"dtype": dtype}
    metrics.inc("frame.encoded", labels=labels)
    metrics.inc("frame.bytes", len(out), labels=labels)
    metrics.inc("frame.json_equiv_bytes",
                arr.size * JSON_BYTES_PER_FLOAT_EST, labels=labels)
    metrics.observe("frame.encode_s", time.perf_counter() - t0)
    return out


def decode_frame(buf: bytes, offset: int = 0) -> np.ndarray:
    """Decode a frame starting at `offset` into a zero-copy read-only
    [rows, cols] view over `buf` (f32, or f16 for dtype-2 frames — the
    store upcasts on ingest). A dtype byte this peer does not implement
    raises FrameError — the delivery stays unacked for redelivery/DLQ,
    never silently misparsed."""
    t0 = time.perf_counter()
    if len(buf) - offset < FRAME_HDR_LEN:
        raise FrameError("frame truncated before header")
    magic, version, dtype, _, rows, cols = _HDR.unpack_from(buf, offset)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if dtype not in _NP_BY_DTYPE:
        raise FrameError(
            f"unsupported frame dtype {dtype} (this peer implements "
            f"{sorted(_NAME_BY_DTYPE.values())})")
    need = rows * cols * _SIZE_BY_DTYPE[dtype]
    body = offset + FRAME_HDR_LEN
    if len(buf) - body < need:
        raise FrameError(f"frame payload truncated: need {need} bytes, "
                         f"have {len(buf) - body}")
    arr = np.frombuffer(buf, dtype=_NP_BY_DTYPE[dtype], count=rows * cols,
                        offset=body).reshape(rows, cols)
    metrics.inc("frame.decoded", labels={"dtype": _NAME_BY_DTYPE[dtype]})
    metrics.observe("frame.decode_s", time.perf_counter() - t0)
    return arr


# ------------------------------------------------------------ bus attachment

def attach_frame(json_bytes: bytes, rows: np.ndarray,
                 dtype: str = "f32") -> Tuple[bytes, Dict[str, str]]:
    """JSON body + frame → (wire data, headers to merge into the publish)."""
    data = bytes(json_bytes) + encode_frame(rows, dtype=dtype)
    content = _CONTENT_TYPE_BY_DTYPE[_DTYPE_BY_NAME[dtype]]
    return data, {FRAME_HEADER: f"{content};off={len(json_bytes)}"}


def frame_offset(headers: Optional[Dict[str, str]]) -> Optional[int]:
    """Parse the X-Symbiont-Frame header; None when the message carries no
    frame. Raises FrameError on a malformed header value (the binary dtype
    byte stays authoritative — the content type only gates known names)."""
    value = (headers or {}).get(FRAME_HEADER)
    if value is None:
        return None
    parts = value.split(";")
    if parts[0].strip() not in _KNOWN_CONTENT_TYPES:
        raise FrameError(f"unknown frame content type {parts[0]!r}")
    for p in parts[1:]:
        k, _, v = p.strip().partition("=")
        if k == "off":
            try:
                off = int(v)
            except ValueError:
                raise FrameError(f"bad frame offset {v!r}") from None
            if off < 0:
                raise FrameError(f"negative frame offset {off}")
            return off
    raise FrameError(f"frame header missing off=: {value!r}")


def detach_frame(data: bytes, headers: Optional[Dict[str, str]]
                 ) -> Tuple[bytes, Optional[np.ndarray]]:
    """Split a possibly-frame-bearing body into (json bytes, rows-or-None).
    A frameless message passes through untouched — the JSON fallback."""
    off = frame_offset(headers)
    if off is None:
        return data, None
    if off > len(data):
        raise FrameError(f"frame offset {off} beyond body ({len(data)} bytes)")
    return data[:off], decode_frame(data, off)


# ------------------------------------------- data.text.with_embeddings codec

def encode_embeddings_message(original_id: str, source_url: str,
                              sentences: Sequence[str],
                              vectors, model_name: str, timestamp_ms: int,
                              use_frame: Optional[bool] = None,
                              wire_dtype: Optional[str] = None
                              ) -> Tuple[bytes, Dict[str, str]]:
    """Build the data.text.with_embeddings wire form. Frame mode keeps the
    floats out of JSON entirely (`wire_dtype` "f32" or half-width "f16";
    None resolves the SYMBIONT_FRAMES knob at publish time); fallback mode
    (`use_frame=False` or SYMBIONT_FRAMES=0) emits the exact reference wire
    shape so a JSON-only peer ingests it unchanged."""
    if use_frame is None:
        use_frame = frames_enabled()
    if wire_dtype is None:
        mode = frames_mode()
        wire_dtype = mode if mode in _DTYPE_BY_NAME else "f32"
    arr = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
    if arr.ndim != 2 or arr.shape[0] != len(sentences):
        raise FrameError(
            f"vectors shape {arr.shape} does not match {len(sentences)} "
            "sentences")
    if use_frame:
        embeddings: List[SentenceEmbedding] = [
            SentenceEmbedding(sentence_text=s, embedding=[])
            for s in sentences]
    else:
        # ndarray.tolist() converts in C — no per-float Python loop even on
        # the fallback path (same double-widened digits as the old
        # `[float(x) for x in v]`, so the bytes stay wire-identical)
        embeddings = [
            SentenceEmbedding(sentence_text=s, embedding=row)
            for s, row in zip(sentences, arr.tolist())]
    out = TextWithEmbeddingsMessage(
        original_id=original_id, source_url=source_url,
        embeddings_data=embeddings, model_name=model_name,
        timestamp_ms=timestamp_ms)
    body = to_json_bytes(out)
    if not use_frame:
        return body, {}
    return attach_frame(body, arr, dtype=wire_dtype)


class LazyEmbeddingsMessage:
    """Zero-churn view over a data.text.with_embeddings body: scalar
    metadata + sentence texts pulled straight out of the parsed JSON dict,
    and the embedding block as ONE [n, dim] f32 ndarray — no per-sentence
    SentenceEmbedding/TextWithEmbeddingsMessage dataclasses are ever
    materialized. On the ingest hot path the consumer builds store payload
    dicts directly from these fields (services/vector_memory.py), so a
    message costs one json.loads and one array view, not 2n+1 Python
    object constructions."""

    __slots__ = ("original_id", "source_url", "model_name", "timestamp_ms",
                 "sentences", "rows")

    def __init__(self, original_id: str, source_url: str, model_name: str,
                 timestamp_ms: int, sentences: List[str], rows: np.ndarray):
        self.original_id = original_id
        self.source_url = source_url
        self.model_name = model_name
        self.timestamp_ms = timestamp_ms
        self.sentences = sentences
        self.rows = rows


def decode_embeddings_lazy(data: bytes,
                           headers: Optional[Dict[str, str]] = None
                           ) -> LazyEmbeddingsMessage:
    """Decode either wire form WITHOUT the per-sentence dataclass churn of
    `decode_embeddings_message`. Frame-bearing messages hand back the
    zero-copy row view; the JSON fallback converts its float lists to one
    f32 block (a single C-level np.asarray, no per-float Python loop).
    Malformed bodies raise (KeyError/TypeError/FrameError) — handler-fatal,
    same stance as from_json: the delivery stays unacked for redelivery."""
    json_bytes, rows = detach_frame(data, headers)
    d = json.loads(json_bytes)
    emb = d["embeddings_data"]
    sentences = [e["sentence_text"] for e in emb]
    if rows is None:
        lists = [e["embedding"] for e in emb]
        rows = (np.asarray(lists, dtype=np.float32) if lists
                else np.zeros((0, 0), np.float32))
        if rows.ndim != 2:
            raise FrameError(
                "embedding lists are ragged or non-numeric: cannot form "
                f"a [{len(lists)}, dim] block")
    elif rows.shape[0] != len(sentences):
        raise FrameError(
            f"frame carries {rows.shape[0]} rows for "
            f"{len(sentences)} sentences")
    return LazyEmbeddingsMessage(
        original_id=d["original_id"], source_url=d["source_url"],
        model_name=d["model_name"], timestamp_ms=int(d["timestamp_ms"]),
        sentences=sentences, rows=rows)


def decode_embeddings_message(data: bytes,
                              headers: Optional[Dict[str, str]] = None
                              ) -> Tuple[TextWithEmbeddingsMessage,
                                         Optional[np.ndarray]]:
    """Decode either wire form. Returns (message, rows): `rows` is the
    zero-copy [n_sentences, dim] view when a frame rode along (the
    message's `embedding` lists are empty then), or None for the JSON
    fallback (floats live in the message as usual)."""
    json_bytes, rows = detach_frame(data, headers)
    msg = from_json(TextWithEmbeddingsMessage, json_bytes)
    if rows is not None and rows.shape[0] != len(msg.embeddings_data):
        raise FrameError(
            f"frame carries {rows.shape[0]} rows for "
            f"{len(msg.embeddings_data)} sentences")
    return msg, rows
