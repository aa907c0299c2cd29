"""Typed configuration of the port: defaults < config file < environment.

Copy of the JAX package's `symbiont_tpu/config.py`: every section,
`SymbiontConfig` and `load_config` with the same fields, defaults, checks
and `SYMBIONT_<SECTION>_<FIELD>` env names (reference-era aliases such as
`NATS_URL` and `FORCE_CPU` included), so code written against the JAX
package's configs constructs these unchanged. `LmConfig` has one field of
its own, `force_cpu`. Fields that steer parts of the JAX
engines the port has not taken over yet (the mesh data-parallel split, the
executable cache, the host prep pipeline; for the LM tensor-parallel decode
and the online trainer) are kept for that reason and say so; `LmEngine`
refuses the settings that would switch those parts on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional

# Weight-quantization modes of the JAX package (docs/QUANTIZATION.md).
QUANTIZE_MODES = ("none", "f16", "int8", "fp8")


@dataclass
class BusConfig:
    # reference default: nats://localhost:4222 (services) / nats://cs-nats:4222
    # (api_service) — reference: services/api_service/src/main.rs:519-524.
    # Ours defaults to the in-process bus (single-process stack needs no
    # broker); set symbus://host:port to go through the native broker.
    url: str = "inproc://"
    request_timeout_embed_s: float = 15.0  # reference: api_service/src/main.rs:310
    request_timeout_search_s: float = 20.0  # reference: api_service/src/main.rs:430
    # rerank hop (our addition — the reference has no rerank stage)
    request_timeout_rerank_s: float = 10.0
    # engine.health hop behind GET /api/health/engine (our addition)
    request_timeout_health_s: float = 5.0
    # at-least-once pipeline: durable streams on the native broker (SURVEY.md
    # §5.3 — the reference's core NATS silently loses in-flight work). Only
    # effective on symbus:// transports; the in-proc bus stays at-most-once.
    durable: bool = False
    durable_ack_wait_s: float = 60.0
    durable_max_deliver: int = 5

    def __post_init__(self) -> None:
        if self.durable_ack_wait_s <= 0:
            raise ValueError("bus.durable_ack_wait_s must be positive")
        if self.durable_max_deliver < 1:
            raise ValueError("bus.durable_max_deliver must be >= 1")


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
    # the executable cache bound (`TorchEngine._get_executable`), as the
    # JAX engine's compiled-executable cache
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


@dataclass
class GraphStoreConfig:
    data_dir: str = "data/graph_store"
    # External Neo4j backend (reference-migration deployments): set uri to
    # the Neo4j HTTP API endpoint (http://host:7474) and the runner swaps in
    # the Neo4j adapter; the embedded sqlite store is the default.
    # Reference env aliases NEO4J_URI/USER/PASSWORD map here.
    uri: Optional[str] = None
    user: str = "neo4j"
    password: str = "password"
    database: str = "neo4j"


@dataclass
class ApiConfig:
    # reference: API_SERVER_HOST/PORT (reference: api_service/src/main.rs:545-547)
    host: str = "127.0.0.1"
    port: int = 8080
    sse_keepalive_s: float = 15.0  # reference: api_service/src/main.rs:190-213
    sse_channel_capacity: int = 32  # reference: api_service/src/main.rs:537
    max_gen_length: int = 1000  # reference: api_service/src/main.rs:133
    # try the fused embed+top-k engine hop first (one device round-trip);
    # fall back to the reference's 2-hop embed→search orchestration when the
    # fused subject isn't served (engine and store in separate processes)
    fused_search: bool = True
    fused_search_timeout_s: float = 5.0
    # after a fused timeout, skip the fused probe for this long (the subject
    # is unserved when engine and store are not co-located)
    fused_search_down_s: float = 60.0
    # fused serves the interactive small-k range its executables are
    # pre-warmed for; larger top_k goes straight to the 2-hop path instead
    # of paying a cold XLA compile inside the probe timeout and tripping the
    # negative cache. Raise together with VectorStoreConfig.warm_top_k —
    # the engine warms every power-of-two k bucket up to that value
    fused_search_max_top_k: int = 16


@dataclass
class TextGeneratorConfig:
    """Markov-backend persistence (SURVEY.md §5.4): the reference rebuilds
    its chain from one hardcoded sentence at every boot, losing all learned
    state (reference: text_generator_service/src/main.rs:169-173). Here the
    chain persists across restarts; None disables."""

    markov_state_path: Optional[str] = "data/markov_state.json"


@dataclass
class PerceptionConfig:
    scrape_timeout_s: float = 15.0  # reference: perception_service/src/main.rs:89-91
    user_agent: str = "SymbiontTPU/0.1 (+research crawler)"


@dataclass
class ParallelConfig:
    """The live stack's device mesh (docs/SCALING.md, ROADMAP item 1).

    The runner builds ONE mesh from this section at stack start and threads
    it through TpuEngine (DP embed over 'data'), LmEngine (TP decode over
    'tensor') and the embedded vector store (corpus rows sharded over
    'data') — going multi-chip is a config change, not a code change.
    SYMBIONT_PARALLEL_MESH_SHAPE='[4, 2]' is the env spelling of dp4xtp2."""

    # serve from a mesh at all; off → every engine gets mesh=None (the
    # pre-mesh single-chip behavior, byte-identical executables)
    enabled: bool = True
    # Mesh axes: data / tensor. PP/SP axes are pluggable (SURVEY.md §2 table).
    mesh_shape: Optional[List[int]] = None  # None → (n_devices, 1)
    axis_names: List[str] = field(default_factory=lambda: ["data", "tensor"])

    def __post_init__(self) -> None:
        if self.mesh_shape is not None:
            if (not self.mesh_shape
                    or any(int(s) < 1 for s in self.mesh_shape)):
                raise ValueError(
                    f"parallel.mesh_shape must be positive ints, "
                    f"got {self.mesh_shape!r}")
            if len(self.mesh_shape) != len(self.axis_names):
                raise ValueError(
                    f"parallel.mesh_shape {self.mesh_shape} must name one "
                    f"size per axis in {self.axis_names}")


@dataclass
class ObsConfig:
    """Observability (symbiont_tpu_torch/obs/): flight-recorder sizing and the
    SLO watchdog. Thresholds are "span.name=p99_ms" entries, e.g.
    SYMBIONT_OBS_SLO_P99_MS='["api.search=500", "preprocessing.handle=2000"]'
    — the watchdog task only runs when at least one is configured."""

    # span records kept in the in-process flight recorder ring
    trace_capacity: int = 4096
    # Tail-based trace retention (obs/trace_store.py): errored /
    # SLO-breach-exemplar / slowest-decile traces PIN into a bounded
    # keep-set the ring's FIFO churn cannot evict (up to trace_keep_traces
    # of them), while healthy traces sample at trace_sample_rate (1.0 =
    # record every trace, the historical behavior; 0.1 = every 10th new
    # trace — pinned traces always record in full).
    trace_sample_rate: float = 1.0
    trace_keep_traces: int = 64
    # Decode-plane flight recorder (obs/engine_timeline.py): per-step
    # engine events kept in the bounded timeline ring (0 disables
    # recording), and how many recent prompt prefixes the admission-time
    # prefix-share probe compares against (lm.prefix_share_ratio).
    timeline_capacity: int = 2048
    timeline_prompt_window: int = 64
    # Per-tenant usage metering (obs/usage.py): distinct tenant identities
    # the ledger tracks — past the bound, new identities share the
    # "(overflow)" ledger (the admission plane's resolve_tenant stance).
    usage_max_tenants: int = 1024
    # seconds between SLO evaluations
    slo_interval_s: float = 10.0
    # two-window burn rates on SLO breach events (obs/watchdog.py): the
    # fast window catches a blip, the slow window proves a sustained burn
    # — the discriminator the elastic autoscaler's SLO signal reads
    slo_burn_fast_s: float = 60.0
    slo_burn_slow_s: float = 600.0
    # "span_name=p99_ms" entries evaluated against span.<name>.ms histograms
    slo_p99_ms: List[str] = field(default_factory=list)
    # cumulative-bucket upper bounds (`le`, in ms) for the span-duration
    # histogram family on /metrics; empty keeps
    # telemetry.DEFAULT_BUCKET_BOUNDS_MS. Applied by the runner at boot —
    # bounds are fixed per histogram at first observation.
    histogram_buckets_ms: List[float] = field(default_factory=list)
    # Fleet telemetry plane (obs/fleet.py, docs/OBSERVABILITY.md "Fleet
    # telemetry"): when this process runs as a named role in a supervised
    # multi-process deployment (runner.role set, or heartbeats on), it
    # publishes bounded metric-snapshot deltas + completed span records on
    # `_sys.telemetry.{metrics,spans}.<role>` every fleet_publish_s; the
    # API-role process hosts the FleetAggregator that merges them into one
    # federated /metrics exposition (role label), stitched cross-process
    # traces, and GET /api/fleet. Telemetry is SAMPLED under backpressure
    # and dropped-with-a-counter, never queued unboundedly — it must not
    # compete with the data path.
    fleet_export: bool = True
    fleet_publish_s: float = 2.0
    # spans carried per publish; the pending ring holds fleet_pending_max
    # finished spans between publishes (overflow counted in
    # fleet.spans_dropped — sampling, not queueing)
    fleet_spans_max: int = 256
    fleet_pending_max: int = 2048
    # metric delta entries per publish (overflow counted + retried next
    # round via the delta mechanism itself)
    fleet_metrics_max: int = 4096
    # every Nth metrics publish is a FULL snapshot (a late-joining
    # aggregator converges within full_every x publish_s)
    fleet_full_every: int = 15
    # distinct roles the aggregator tracks; past the bound new roles are
    # counted in fleet.role_overflow and ignored (client-suppliable role
    # names must not grow unbounded state)
    fleet_roles_max: int = 64
    # Compute-plane profiler (obs/xprof.py): the per-executable dispatch
    # ledger behind xla.dispatches_total / GET /api/engine/executables
    # (xprof_enabled=False turns every note into a cheap early return),
    # its LRU bound on distinct executables tracked, and the on-demand
    # device trace capture (POST /api/profile/device): hard cap on one
    # capture window and where trace artifacts land.
    xprof_enabled: bool = True
    xprof_executables: int = 256
    xprof_trace_max_s: float = 30.0
    xprof_trace_dir: str = "/tmp/symbiont_xprof"
    # HBM attribution plane (obs/hbm.py): the subsystem byte ledger /
    # live-array census behind GET /api/memory (+ /census) and the OOM
    # forensics postmortems (hbm_enabled=False disables ledger rows and
    # postmortem writes; engine.oom_total still counts). census_groups
    # bounds (shape, dtype, sharding) rows carried per census response;
    # postmortems land in postmortem_dir, newest postmortem_max kept.
    hbm_enabled: bool = True
    hbm_census_groups: int = 64
    hbm_postmortem_dir: str = "/tmp/symbiont_hbm"
    hbm_postmortem_max: int = 4

    def __post_init__(self) -> None:
        if self.trace_capacity < 1:
            raise ValueError("obs.trace_capacity must be >= 1")
        if not 0.0 < self.trace_sample_rate <= 1.0:
            raise ValueError("obs.trace_sample_rate must be in (0, 1]")
        if self.trace_keep_traces < 1:
            raise ValueError("obs.trace_keep_traces must be >= 1")
        if self.timeline_capacity < 0:
            raise ValueError("obs.timeline_capacity must be >= 0")
        if self.timeline_prompt_window < 1:
            raise ValueError("obs.timeline_prompt_window must be >= 1")
        if self.usage_max_tenants < 1:
            raise ValueError("obs.usage_max_tenants must be >= 1")
        if self.slo_interval_s <= 0:
            raise ValueError("obs.slo_interval_s must be positive")
        if self.slo_burn_fast_s <= 0 \
                or self.slo_burn_slow_s < self.slo_burn_fast_s:
            raise ValueError(
                "obs.slo_burn_fast_s must be positive and <= "
                "obs.slo_burn_slow_s")
        if self.fleet_publish_s <= 0:
            raise ValueError("obs.fleet_publish_s must be positive")
        for name in ("fleet_spans_max", "fleet_pending_max",
                     "fleet_metrics_max", "fleet_full_every",
                     "fleet_roles_max"):
            if getattr(self, name) < 1:
                raise ValueError(f"obs.{name} must be >= 1")
        if self.histogram_buckets_ms:
            b = self.histogram_buckets_ms
            if any(x <= 0 for x in b) or list(b) != sorted(set(b)):
                raise ValueError(
                    "obs.histogram_buckets_ms must be positive and "
                    "strictly increasing")
        if self.xprof_executables < 1:
            raise ValueError("obs.xprof_executables must be >= 1")
        if self.xprof_trace_max_s <= 0:
            raise ValueError("obs.xprof_trace_max_s must be positive")
        if not self.xprof_trace_dir:
            raise ValueError("obs.xprof_trace_dir must be non-empty")
        if self.hbm_census_groups < 1:
            raise ValueError("obs.hbm_census_groups must be >= 1")
        if self.hbm_postmortem_max < 1:
            raise ValueError("obs.hbm_postmortem_max must be >= 1")
        if not self.hbm_postmortem_dir:
            raise ValueError("obs.hbm_postmortem_dir must be non-empty")
        # malformed SLO entries fail at boot, not silently never fire
        from symbiont_tpu_torch.obs.watchdog import parse_thresholds

        parse_thresholds(self.slo_p99_ms)


@dataclass
class ResilienceConfig:
    """Resilience plane (symbiont_tpu_torch/resilience/, docs/RESILIENCE.md):
    handler timeouts/retries, store circuit breakers with WAL spill, the
    dead-letter quarantine, and loop-supervisor backoff."""

    # per-handler deadline; the handler is CANCELLED at the deadline and a
    # durable delivery stays unacked for redelivery. 0 disables (default:
    # first-call XLA compiles can legitimately take minutes on a cold
    # engine; production deployments should set an explicit budget).
    handler_timeout_s: float = 0.0
    # in-process retries for a FAILED (not timed-out) handler, with
    # full-jitter exponential backoff between attempts
    handler_retries: int = 0
    handler_backoff_base_s: float = 0.05
    handler_backoff_max_s: float = 2.0
    # circuit breakers around the EXTERNAL store backends (Qdrant/Neo4j):
    # after `breaker_failure_threshold` consecutive failures the breaker
    # opens, writes spill to a local WAL (replayed on recovery), and a
    # half-open probe is admitted every `breaker_reset_timeout_s`
    breaker_enabled: bool = True
    breaker_failure_threshold: int = 5
    breaker_reset_timeout_s: float = 30.0
    # spill WAL directory for breaker-degraded writes
    spill_dir: str = "data/resilience"
    # dead-letter quarantine ring size (inproc durable bus; GET /api/dlq)
    dlq_capacity: int = 256
    # restart backoff for crashed service dispatch loops
    supervisor_backoff_base_s: float = 0.5
    supervisor_backoff_max_s: float = 30.0

    def __post_init__(self) -> None:
        if self.handler_timeout_s < 0:
            raise ValueError("resilience.handler_timeout_s must be >= 0")
        if self.handler_retries < 0:
            raise ValueError("resilience.handler_retries must be >= 0")
        if (self.handler_backoff_base_s <= 0
                or self.handler_backoff_max_s < self.handler_backoff_base_s):
            raise ValueError(
                "resilience.handler_backoff_base_s must be positive and "
                "<= handler_backoff_max_s")
        if self.breaker_failure_threshold < 1:
            raise ValueError(
                "resilience.breaker_failure_threshold must be >= 1")
        if self.breaker_reset_timeout_s <= 0:
            raise ValueError(
                "resilience.breaker_reset_timeout_s must be positive")
        if self.dlq_capacity < 1:
            raise ValueError("resilience.dlq_capacity must be >= 1")
        if (self.supervisor_backoff_base_s <= 0
                or self.supervisor_backoff_max_s
                < self.supervisor_backoff_base_s):
            raise ValueError(
                "resilience.supervisor_backoff_base_s must be positive and "
                "<= supervisor_backoff_max_s")


@dataclass
class AdmissionConfig:
    """Overload-protection plane (resilience/admission.py,
    docs/RESILIENCE.md overload rows): per-tenant token-bucket quotas per
    request class, the weighted-fair search queue, edge-minted deadlines,
    capacity-aware generation admission, and the SLO shed ladder. Tenant
    identity comes from the `X-Symbiont-Tenant` HTTP header (default
    tenant otherwise); quotas are PER TENANT, so one hot tenant is clamped
    to its own budget instead of starving everyone."""

    enabled: bool = True
    # per-tenant token buckets: sustained requests/second + burst headroom,
    # one bucket per (tenant, class). Exhaustion answers 429 with
    # Retry-After at the HTTP edge — the queue never grows unboundedly.
    ingest_rate: float = 200.0
    ingest_burst: float = 400.0
    search_rate: float = 100.0
    search_burst: float = 200.0
    generate_rate: float = 20.0
    generate_burst: float = 40.0
    # weighted-fair search scheduling: shared concurrency budget, bounded
    # per-tenant wait queues (full queue → 429), stride weights like
    # "gold=4,free=1" (unlisted tenants weigh 1)
    search_concurrency: int = 32
    max_queue_per_tenant: int = 64
    fair_weights: str = ""
    # distinct tenant identities the edge will track: the tenant header is
    # client-supplied, so past this bound every NEW identity shares one
    # overflow bucket/queue (quota-bypass-by-fresh-tenant and unbounded
    # per-tenant state/metric cardinality both stop here)
    max_tenants: int = 1024
    # deadlines minted at the API edge (X-Symbiont-Deadline, absolute epoch
    # ms), threaded through every bus hop by telemetry.child_headers;
    # expired work is dropped before the handler runs (never retried,
    # never DLQ'd). 0 disables minting for that class; a client-supplied
    # deadline always passes through (and can only TIGHTEN a minted one).
    # INGEST defaults to NO minted deadline: the edge already answered 200
    # "submitted successfully", and an expiring deadline would silently
    # drop accepted data during a redelivery storm — violating the plane's
    # own ingest-is-never-shed / zero-loss invariant. Opt in only if your
    # clients treat submit-url as best-effort.
    deadline_ingest_ms: float = 0.0
    deadline_search_ms: float = 10000.0
    deadline_generate_ms: float = 60000.0
    # capacity-aware generation admission: refuse new generation streams
    # (429) once the LM's allocated KV rows across live decode sessions
    # reach this bound (LmEngine.can_admit); 0 = unbounded (the pre-plane
    # behavior)
    max_kv_rows: int = 0
    # shed-ladder hysteresis (resilience/admission.DegradationLadder):
    # dwell time between level changes and consecutive breach-free
    # watchdog passes required to step down — an oscillating breach parks
    # the ladder instead of flapping it
    shed_recovery_passes: int = 3
    shed_hold_s: float = 5.0
    # degraded-search rung: top-k clamp (rerank is skipped outright)
    degraded_top_k: int = 3

    def __post_init__(self) -> None:
        for name in ("ingest", "search", "generate"):
            if (getattr(self, f"{name}_rate") <= 0
                    or getattr(self, f"{name}_burst") <= 0):
                raise ValueError(
                    f"admission.{name}_rate/_burst must be positive")
        if self.search_concurrency < 1 or self.max_queue_per_tenant < 1:
            raise ValueError(
                "admission.search_concurrency and max_queue_per_tenant "
                "must be >= 1")
        if self.max_tenants < 1:
            raise ValueError("admission.max_tenants must be >= 1")
        if self.shed_recovery_passes < 1:
            raise ValueError("admission.shed_recovery_passes must be >= 1")
        if self.shed_hold_s < 0:
            raise ValueError("admission.shed_hold_s must be >= 0")
        if self.degraded_top_k < 1:
            raise ValueError("admission.degraded_top_k must be >= 1")
        if self.max_kv_rows < 0:
            raise ValueError("admission.max_kv_rows must be >= 0")
        # malformed weights fail at boot, not silently weight 1
        from symbiont_tpu_torch.resilience.admission import parse_weights

        parse_weights(self.fair_weights)


@dataclass
class AutoscaleConfig:
    """SLO-driven elastic autoscaling (resilience/autoscale.py,
    docs/RESILIENCE.md "Elastic autoscaling"): the ProcessSupervisor's
    policy engine that grows and shrinks role-split fleets from the
    pressure signals the admission plane and fleet telemetry already
    measure. Off by default — a fixed-size deployment behaves exactly as
    before. Scale-in always retires through the drain protocol (the
    worker detaches its durable consumers, flushes its coalescer,
    finishes in-flight work, beats `draining: true`, and exits), with
    `drain_deadline_s` + SIGKILL + durable redelivery as the safety net."""

    enabled: bool = False
    # elastic roles and their replica bounds: "embed=1:4,decode=1:2".
    # Every listed role must exist as a supervised worker; the base
    # replica (index 1) is never retired, so min >= 1.
    roles: str = ""
    # seconds between policy evaluations
    eval_s: float = 2.0
    # scale-out pressure: per-replica engine queue depth (the federated
    # `batcher.queue_depth` + `batcher.tenant_depth` gauges) above
    # queue_high is full pressure; below queue_low counts as a clean
    # (scale-in-eligible) pass
    queue_high: float = 64.0
    queue_low: float = 4.0
    # KV-occupancy pressure for decode roles: allocated KV rows
    # (`lm.kv_rows_allocated`) above this is full pressure; 0 disables
    kv_high_rows: float = 0.0
    # breaker-style hysteresis (the DegradationLadder shape): a scale-out
    # needs out_dwell_s since the role's last change; a scale-in needs
    # in_clean_passes CONSECUTIVE low-pressure evaluations AND
    # in_dwell_s — a flapping signal parks the fleet at its size instead
    # of thrashing spawn/drain cycles
    out_dwell_s: float = 10.0
    in_dwell_s: float = 60.0
    in_clean_passes: int = 5
    # global scale budget: at most budget_ops scale operations (out or
    # in, all roles together) per budget_window_s — a runaway signal or
    # crash-looping role cannot thrash the box
    budget_ops: int = 6
    budget_window_s: float = 300.0
    # drain enforcement: a retiring worker that has not exited this many
    # seconds after the drain request is SIGKILLed (its unacked durable
    # deliveries redeliver to the surviving replicas — zero loss either
    # way)
    drain_deadline_s: float = 30.0

    def __post_init__(self) -> None:
        for name in ("eval_s", "out_dwell_s", "budget_window_s",
                     "drain_deadline_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"autoscale.{name} must be positive")
        if self.in_dwell_s < 0 or self.kv_high_rows < 0:
            raise ValueError(
                "autoscale.in_dwell_s and kv_high_rows must be >= 0")
        if self.queue_high <= 0 or self.queue_low < 0 \
                or self.queue_low >= self.queue_high:
            raise ValueError(
                "autoscale.queue_low must be >= 0 and < queue_high")
        if self.in_clean_passes < 1 or self.budget_ops < 1:
            raise ValueError(
                "autoscale.in_clean_passes and budget_ops must be >= 1")
        # malformed role bounds fail at boot, not silently never scale
        from symbiont_tpu_torch.resilience.autoscale import parse_role_bounds

        parse_role_bounds(self.roles)


@dataclass
class GenJournalConfig:
    """Generation-session durability plane (docs/RESILIENCE.md "Durable
    generation sessions"): a per-role write-ahead journal of in-flight
    decode state, appended at the stream's existing chunk-boundary host
    syncs. When a generator worker dies mid-stream (SIGKILL, hang verdict,
    drain deadline) the supervisor republishes the journal tails as
    tasks.generation.resume, and a surviving replica continues the stream
    token-identically (greedy; sampled streams restore the journaled PRNG
    state). Off by default: journaling is a per-deployment durability
    opt-in, not a hot-path tax."""

    enabled: bool = False
    # journal directory; each role writes `<dir>/<role>.genlog` (JSONL, one
    # self-contained snapshot per chunk — the last record per task is the
    # full resume state)
    dir: str = "data/genlog"
    # compaction threshold: past this many bytes the file is rewritten
    # keeping only live tasks' tail records
    max_bytes: int = 8 * 1024 * 1024
    # live-task bound: oldest tasks are evicted (counted) past this — a
    # leak in done-marking cannot grow the journal without limit
    max_tasks: int = 512
    # fsync every append. Durability vs throughput: the default rides the
    # OS page cache (survives process SIGKILL, the failure mode this plane
    # targets; not a host power cut)
    fsync: bool = False
    # resume-under-pressure: a resume refused by admission (PoolExhausted /
    # can_admit false) re-queues with exponential backoff up to this many
    # attempts before it is abandoned (counted gen.resume_abandoned)
    resume_max_attempts: int = 5
    resume_backoff_s: float = 0.25

    def __post_init__(self) -> None:
        if self.max_bytes < 4096:
            raise ValueError("gen_journal.max_bytes must be >= 4096")
        if self.max_tasks < 1:
            raise ValueError("gen_journal.max_tasks must be >= 1")
        if self.resume_max_attempts < 0 or self.resume_backoff_s < 0:
            raise ValueError("gen_journal.resume_max_attempts and "
                             "resume_backoff_s must be >= 0")


@dataclass
class RunnerConfig:
    """Which services this process hosts (SYMBIONT_RUNNER_SERVICES).

    "all", or a comma list among: perception, preprocessing, vector_memory,
    knowledge_graph, text_generator, api, engine. "engine" is the engine.*
    request-reply plane (services/engine_service.py) that the native C++
    worker shells call into — a deployment of native workers runs a Python
    process with just `engine` plus the C++ binaries against the broker.
    """

    services: str = "all"
    # process-failure plane (resilience/procsup.py): when heartbeat_s > 0
    # the stack publishes a liveness heartbeat to `_sys.heartbeat.<role>`
    # every heartbeat_s seconds — the signal the process supervisor uses to
    # detect a HUNG (SIGSTOPped, deadlocked) worker that an exit code can't
    # reveal. `role` names this process in heartbeats and procsup metrics;
    # empty = derived from the services list.
    role: str = ""
    heartbeat_s: float = 0.0

    def __post_init__(self) -> None:
        if self.heartbeat_s < 0:
            raise ValueError("runner.heartbeat_s must be >= 0")


@dataclass
class SymbiontConfig:
    bus: BusConfig = field(default_factory=BusConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    lm: LmConfig = field(default_factory=LmConfig)
    vector_store: VectorStoreConfig = field(default_factory=VectorStoreConfig)
    graph_store: GraphStoreConfig = field(default_factory=GraphStoreConfig)
    api: ApiConfig = field(default_factory=ApiConfig)
    text_generator: TextGeneratorConfig = field(
        default_factory=TextGeneratorConfig)
    perception: PerceptionConfig = field(default_factory=PerceptionConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    runner: RunnerConfig = field(default_factory=RunnerConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    gen_journal: GenJournalConfig = field(default_factory=GenJournalConfig)

    def __post_init__(self) -> None:
        # cross-section invariant: every top_k the gateway routes to the
        # fused path must land in a pre-warmed k bucket, or the first such
        # query pays a cold XLA compile inside the probe timeout and trips
        # the negative cache for everyone. Fail at startup, not in that
        # degraded 60s window. (The standalone C++ gateway reads
        # SYMBIONT_API_FUSED_SEARCH_MAX_TOP_K with the same default; keep
        # them in lockstep in deployment env.)
        if self.api.fused_search_max_top_k > self.vector_store.warm_top_k:
            raise ValueError(
                f"api.fused_search_max_top_k ({self.api.fused_search_max_top_k})"
                f" must be <= vector_store.warm_top_k "
                f"({self.vector_store.warm_top_k}): fused queries above the "
                f"warmed k buckets would compile cold inside the probe timeout")


# Reference-era env aliases → (section, field) (reference: .env.example:1-12).
_ENV_ALIASES = {
    "NATS_URL": ("bus", "url"),
    "QDRANT_URI": ("vector_store", "uri"),
    "NEO4J_URI": ("graph_store", "uri"),
    "NEO4J_USER": ("graph_store", "user"),
    "NEO4J_PASSWORD": ("graph_store", "password"),
    "API_SERVER_HOST": ("api", "host"),
    "API_SERVER_PORT": ("api", "port"),
    "FORCE_CPU": ("engine", "force_cpu"),
    "EMBEDDING_MODEL_NAME": ("engine", "model_name"),
}


def _coerce(tp: Any, raw: str) -> Any:
    if tp is bool or tp == Optional[bool]:
        return raw.lower() in ("1", "true", "yes", "on")
    if tp is int or tp == Optional[int]:
        return int(raw)
    if tp is float or tp == Optional[float]:
        return float(raw)
    if tp in (List[int], List[str], List[float], Optional[List[int]]):
        parsed = json.loads(raw)
        return parsed
    return raw


def _apply_overrides(cfg: SymbiontConfig, env: dict[str, str]) -> None:
    import typing

    hints_by_section = {
        f.name: typing.get_type_hints(type(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
    }
    # Legacy reference-era aliases apply FIRST so canonical SYMBIONT_* vars win
    # when both are set.
    for alias, (sec, fld) in _ENV_ALIASES.items():
        if alias in env:
            setattr(getattr(cfg, sec), fld, _coerce(hints_by_section[sec][fld], env[alias]))
    for section_field in dataclasses.fields(cfg):
        section = getattr(cfg, section_field.name)
        hints = hints_by_section[section_field.name]
        for f in dataclasses.fields(section):
            key = f"SYMBIONT_{section_field.name.upper()}_{f.name.upper()}"
            if key in env:
                setattr(section, f.name, _coerce(hints[f.name], env[key]))


def _check_type(key: str, tp: Any, v: Any) -> Any:
    """Validate a config-file value against the field's declared type."""
    import typing

    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        if v is None:
            return None
        inner = [a for a in typing.get_args(tp) if a is not type(None)][0]
        return _check_type(key, inner, v)
    if origin is list:
        if not isinstance(v, list):
            raise ValueError(f"config key {key!r}: expected list, got {type(v).__name__}")
        (elem,) = typing.get_args(tp)
        return [_check_type(key, elem, x) for x in v]
    if tp is float:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"config key {key!r}: expected number, got {type(v).__name__}")
        return float(v)
    if tp in (int, str, bool):
        if not isinstance(v, tp) or (tp is int and isinstance(v, bool)):
            raise ValueError(
                f"config key {key!r}: expected {tp.__name__}, got {type(v).__name__}")
        return v
    return v


def _merge_dict(cfg_obj: Any, data: dict) -> None:
    import typing

    hints = typing.get_type_hints(type(cfg_obj))
    for k, v in data.items():
        if not hasattr(cfg_obj, k):
            raise ValueError(f"unknown config key {k!r} for {type(cfg_obj).__name__}")
        cur = getattr(cfg_obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_dict(cur, v)
        else:
            setattr(cfg_obj, k, _check_type(k, hints[k], v))


def load_config(
    path: str | Path | None = None, env: dict[str, str] | None = None
) -> SymbiontConfig:
    """defaults < json config file < env vars (legacy aliases below SYMBIONT_*)."""
    cfg = SymbiontConfig()
    env_map = os.environ if env is None else env
    explicit = path is not None
    if path is None:
        path = env_map.get("SYMBIONT_CONFIG")
    if path is not None:
        if Path(path).exists():
            _merge_dict(cfg, json.loads(Path(path).read_text()))
        elif explicit:
            raise FileNotFoundError(f"config file not found: {path}")
    _apply_overrides(cfg, env_map)
    _validate(cfg)
    return cfg


def _validate(cfg: SymbiontConfig) -> None:
    """Re-run every dataclass __post_init__ validator AFTER file/env
    overrides: _merge_dict/_apply_overrides mutate the already-constructed
    sections via setattr, which bypasses dataclass construction — without
    this, the validators only ever see defaults."""
    for section_field in dataclasses.fields(cfg):
        section = getattr(cfg, section_field.name)
        post = getattr(section, "__post_init__", None)
        if post is not None:
            post()
    cfg.__post_init__()
