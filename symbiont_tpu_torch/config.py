"""Engine and vector-store configuration of the port.

Own copies of `symbiont_tpu.config`'s `QUANTIZE_MODES`, `EngineConfig` and
`VectorStoreConfig`, with the same fields and defaults, so code written
against the JAX package's configs constructs these unchanged. Fields that
steer parts of the JAX engine the port has not taken over yet (the mesh
data-parallel split, the executable cache, the host prep pipeline, weight
quantization) are kept for that reason and say so.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# Weight-quantization modes of the JAX package (docs/QUANTIZATION.md).
QUANTIZE_MODES = ("none", "f16", "int8", "fp8")


@dataclass
class EngineConfig:
    model_name: str = "sentence-transformers/paraphrase-multilingual-mpnet-base-v2"
    # local checkpoint dir (safetensors + config); loading one is not ported
    # yet (ROADMAP Queue A: model_dir checkpoint loading)
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
    cross_model_dir: Optional[str] = None
    # synthetic cross-encoder (random weights, embedder geometry) when no
    # cross_model_dir is given
    rerank_enabled: bool = False
    # only "none" is ported (ROADMAP Queue A: quantization)
    quantize: str = "none"

    def __post_init__(self) -> None:
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"engine.quantize must be one of {QUANTIZE_MODES}, "
                f"got {self.quantize!r}")
        if self.quantize != "none":
            raise NotImplementedError(
                f"engine.quantize={self.quantize!r} is not ported to "
                "symbiont_tpu_torch yet (ROADMAP Queue A: quantization)")
        if self.tenant_lane_depth < 0:
            raise ValueError("engine.tenant_lane_depth must be >= 0")


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
