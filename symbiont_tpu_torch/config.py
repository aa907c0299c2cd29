"""Engine, LM and vector-store configuration of the port.

Own copies of `symbiont_tpu.config`'s `QUANTIZE_MODES`, `EngineConfig`,
`LmConfig`, `VectorStoreConfig` and `validate_spec_draft`, with the same
fields, defaults and checks, so code written against the JAX package's
configs constructs these unchanged. Fields that steer parts of the JAX
engines the port has not taken over yet (the mesh data-parallel split, the
executable cache, the host prep pipeline; for the LM tensor-parallel decode
and the online trainer) are kept for that reason and say so; `LmEngine`
refuses the settings that would switch those parts on.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

# Weight-quantization modes of the JAX package (docs/QUANTIZATION.md).
QUANTIZE_MODES = ("none", "f16", "int8", "fp8")


@dataclass
class EngineConfig:
    model_name: str = "sentence-transformers/paraphrase-multilingual-mpnet-base-v2"
    # local HF checkpoint dir (config.json + model.safetensors, sharded or
    # not, or pytorch_model.bin; tokenizer.json when present), read by
    # models/convert.py
    model_dir: Optional[str] = None
    embedding_dim: int = 768
    # run on the CPU instead of the CUDA device (device.resolve_device)
    force_cpu: bool = False
    dtype: str = "bfloat16"
    # attention backend: "auto" → plain torch attention ("xla" in the JAX
    # package's naming, kept so configs carry over); "flash" → the
    # hand-written CUDA flash-attention kernel (ops/flash_attention.py)
    attn_impl: str = "auto"
    length_buckets: List[int] = field(default_factory=lambda: [32, 64, 128, 256, 512])
    batch_buckets: List[int] = field(default_factory=lambda: [1, 8, 32, 128])
    max_batch: int = 128
    flush_deadline_ms: float = 5.0
    max_inflight_flushes: int = 2
    tenant_lane_depth: int = 4096
    # mesh data parallelism: not ported (ROADMAP Queue A: multi-device)
    data_parallel: bool = True
    # the JAX engine's compiled-executable cache bound; the port runs
    # eagerly and keeps no cache
    executable_cache_size: int = 64
    # the JAX engine's background tokenization chunk; the port tokenizes a
    # call's texts in one pass
    host_prep_chunk: int = 2048
    # cross-encoder checkpoint dir (pooler and classifier head included)
    cross_model_dir: Optional[str] = None
    # synthetic cross-encoder (random weights, embedder geometry) when no
    # cross_model_dir is given
    rerank_enabled: bool = False
    # weight storage: "none" | "f16" (bf16 matrices) | "int8" | "fp8"
    # (per-channel codes, models/quant.py)
    quantize: str = "none"

    def __post_init__(self) -> None:
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"engine.quantize must be one of {QUANTIZE_MODES}, "
                f"got {self.quantize!r}")
        if self.tenant_lane_depth < 0:
            raise ValueError("engine.tenant_lane_depth must be >= 0")


@dataclass
class LmConfig:
    """Decoder-LM generation (BASELINE.md config #5), the JAX package's
    fields and defaults. Synthetic mode (no `model_dir`) is a byte-level
    llama of the width below with random weights."""

    enabled: bool = False
    model_dir: Optional[str] = None  # GPT-2/Llama checkpoint dir
    # run on the CPU instead of the CUDA device (device.resolve_device)
    force_cpu: bool = False
    # synthetic-mode geometry (used when model_dir is None; byte-level vocab)
    arch: str = "llama"
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    intermediate_size: int = 1536
    max_positions: int = 2048
    dtype: str = "bfloat16"
    # "auto" → plain torch attention ("xla"); "flash" → the prefill runs the
    # CUDA flash-attention kernel, causal, GQA inside; decode steps always
    # read the cache with plain attention
    attn_impl: str = "auto"
    # tensor-parallel decode over a mesh: not ported (ROADMAP A15); "on"
    # is refused by LmEngine, "auto" and "off" decode on one device
    tensor_parallel: str = "auto"
    # one shape set per (prompt bucket, new-token bucket) pair
    prompt_buckets: List[int] = field(default_factory=lambda: [16, 64, 256, 1024])
    new_token_buckets: List[int] = field(default_factory=lambda: [16, 64, 128, 256, 1024])
    temperature: float = 0.8
    top_k: int = 40
    seed: int = 0
    # the generation batcher's flush window and tenant lanes
    # (engine/batcher.py), the rows a session reserves for admissions and
    # the decode steps per streaming or session chunk
    gen_max_batch: int = 8
    gen_flush_deadline_ms: float = 30.0
    gen_tenant_lane_depth: int = 1024
    session_min_rows: int = 4
    stream_chunk: int = 16
    # weight storage: "none" | "f16" | "int8" | "fp8" (models/quant.py),
    # applied after the cast to the compute dtype
    quantize: str = "none"
    # KV-cache storage: "none" keeps compute-dtype slabs, "int8" per-vector
    # int8 codes with float32 scales
    kv_quant: str = "none"
    # KV layout of sessions: "dense" keeps one max-length slab per row;
    # "paged" keeps K/V in pages of kv_page_tokens tokens (which must divide
    # every prompt bucket) drawn from one preallocated pool of kv_pool_pages
    # pages (0 = one session batch at the largest buckets, x2, + scratch),
    # with the radix prefix cache over committed prompt pages (kv_radix)
    kv_layout: str = "dense"
    kv_page_tokens: int = 16
    kv_pool_pages: int = 0
    kv_radix: bool = True
    # speculative decoding: a drafter checkpoint dir (its tokenizer and
    # vocab must match the target's, `validate_spec_draft`; a missing dir
    # disables speculation with a warning) proposing spec_k tokens a round
    spec_draft_model: Optional[str] = None
    spec_k: int = 8
    # online fine-tune over ingested text: not ported (ROADMAP A14)
    ingest_train: bool = False
    ingest_train_steps: int = 2
    ingest_train_min_chars: int = 512
    ingest_train_seq_len: int = 64
    ingest_train_batch: int = 8
    ingest_train_lr: float = 1e-4
    train_state_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.tensor_parallel not in ("auto", "on", "off"):
            raise ValueError(
                f"tensor_parallel must be auto|on|off, got {self.tensor_parallel!r}")
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"lm.quantize must be one of {QUANTIZE_MODES}, got {self.quantize!r}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(f"lm.kv_quant must be none|int8, got {self.kv_quant!r}")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"lm.kv_layout must be dense|paged, got {self.kv_layout!r}")
        if self.kv_layout == "paged":
            if self.kv_page_tokens < 1:
                raise ValueError("lm.kv_page_tokens must be >= 1")
            bad = [b for b in self.prompt_buckets if b % self.kv_page_tokens]
            if bad:
                raise ValueError(
                    f"kv_page_tokens={self.kv_page_tokens} must divide every prompt "
                    f"bucket; offending buckets: {bad}")
            if self.kv_pool_pages < 0:
                raise ValueError("lm.kv_pool_pages must be >= 0 (0 = auto)")
        if self.gen_tenant_lane_depth < 0:
            raise ValueError("lm.gen_tenant_lane_depth must be >= 0")
        if self.spec_k < 1:
            raise ValueError(f"lm.spec_k must be >= 1, got {self.spec_k}")
        if self.stream_chunk > 0:
            bad = [b for b in self.new_token_buckets
                   if b > self.stream_chunk and b % self.stream_chunk]
            if bad:
                raise ValueError(
                    f"stream_chunk={self.stream_chunk} must divide every "
                    f"new_token_bucket larger than it; offending buckets: {bad}")


def validate_spec_draft(target_dir: str, draft_dir: str) -> None:
    """Drafter/target compatibility, read from the two checkpoint dirs
    before any weight is loaded: `config.json` vocab_size parity (required:
    verification compares token ids directly), and, where both dirs carry
    one, the same tokenizer file (`tokenizer.json`, else `vocab.json`) by
    content hash. Raises ValueError on a mismatch; whether draft_dir exists
    is the caller's concern (the engine warns and decodes plain)."""
    def vocab(d: str) -> int:
        p = Path(d) / "config.json"
        try:
            return int(json.loads(p.read_text()).get("vocab_size", -1))
        except (OSError, ValueError) as e:
            raise ValueError(f"spec_draft_model compat: cannot read {p}: {e}")

    tv, dv = vocab(target_dir), vocab(draft_dir)
    if tv != dv:
        raise ValueError(
            f"spec_draft_model vocab mismatch: target {target_dir!r} has vocab_size={tv} but "
            f"draft {draft_dir!r} has vocab_size={dv}; speculative verification compares "
            "token ids directly, so drafter and target must share one tokenizer/vocab")

    def tok_fingerprint(d: str) -> Optional[str]:
        for name in ("tokenizer.json", "vocab.json"):
            p = Path(d) / name
            if p.is_file():
                return name + ":" + hashlib.sha256(p.read_bytes()).hexdigest()
        return None

    tf, df = tok_fingerprint(target_dir), tok_fingerprint(draft_dir)
    if tf is not None and df is not None and tf != df:
        raise ValueError(
            f"spec_draft_model tokenizer mismatch: target {target_dir!r} and draft "
            f"{draft_dir!r} carry different tokenizer files ({tf.split(':')[0]} fingerprints "
            "differ); draft token ids would not mean the same strings under the target")


@dataclass
class VectorStoreConfig:
    uri: Optional[str] = None
    collection: str = "symbiont_document_embeddings"
    dim: int = 768
    distance: str = "cosine"
    data_dir: str = "data/vector_store"
    device_resident: bool = True  # corpus matrix lives in device memory
    shard_capacity: int = 65536  # rows per device-resident block
    warm_top_k: int = 16
    coalesce: bool = True
    coalesce_max_rows: int = 512
    coalesce_max_age_ms: float = 25.0

    def __post_init__(self) -> None:
        if self.coalesce_max_rows < 1:
            raise ValueError("vector_store.coalesce_max_rows must be >= 1")
        if self.coalesce_max_age_ms <= 0:
            raise ValueError(
                "vector_store.coalesce_max_age_ms must be positive")
