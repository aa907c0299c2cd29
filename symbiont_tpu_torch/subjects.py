"""Bus subject table — the system's internal API surface.

Copy of the JAX package's `symbiont_tpu/subjects.py`.

Parity with the reference's eight NATS subjects (SURVEY.md §1-L3; producers and
consumers cited there). Unlike the reference, which hardcodes each subject
string inside each service (e.g. reference: services/api_service/src/main.rs:20-24),
these are one configurable table shared by every service and by the native C++
workers (exported through the generated header).

The reference's `data.processed_text.tokenized` subject is ORPHANED in v0.3.0 —
knowledge_graph_service subscribes (reference:
services/knowledge_graph_service/src/main.rs:9,201) but nothing publishes
(reference: CHANGELOG.md:57-60). This framework deliberately restores the
producer: our preprocessing service publishes it (SURVEY.md fact #3).
"""

from __future__ import annotations

# pipeline (fire-and-forget pub/sub)
TASKS_PERCEIVE_URL = "tasks.perceive.url"
DATA_RAW_TEXT_DISCOVERED = "data.raw_text.discovered"
DATA_TEXT_WITH_EMBEDDINGS = "data.text.with_embeddings"
DATA_PROCESSED_TEXT_TOKENIZED = "data.processed_text.tokenized"  # un-orphaned here
TASKS_GENERATION_TEXT = "tasks.generation.text"
EVENTS_TEXT_GENERATED = "events.text.generated"
# streaming deltas (our addition — SURVEY.md §7 hard part #5 "streaming
# tokens back out through NATS→SSE"); the final full message still rides
# EVENTS_TEXT_GENERATED for reference-era consumers
EVENTS_TEXT_GENERATED_PARTIAL = "events.text.generated.partial"
# generation cancellation (overload-protection plane): published by the API
# gateway when an SSE client that was following a task disconnects
# mid-generation; the text generator frees the task's decode row / closes
# its stream so a vanished reader can never pin a KV slot
TASKS_GENERATION_CANCEL = "tasks.generation.cancel"
# generation-session durability plane (resilience/genlog.py, docs/RESILIENCE.md
# "Durable generation sessions"): when a generator worker dies mid-stream
# (heartbeat verdict, exit, or drain-deadline SIGKILL), the process supervisor
# republishes its journal tails here as plain-JSON resume tasks
# {"task_id", "record", "attempt"}; generator replicas consume under the
# text-generator queue group, so exactly one survivor adopts each orphaned
# session and continues its token stream from `record`'s snapshot
TASKS_GENERATION_RESUME = "tasks.generation.resume"

# process-failure plane (resilience/procsup.py): every supervised runner
# process publishes a liveness heartbeat under `_sys.heartbeat.<role>`; the
# supervisor subscribes the wildcard and declares a worker HUNG (SIGKILL +
# restart) when its heartbeats stall — the liveness signal a SIGSTOPped or
# deadlocked process cannot fake, unlike an exit code. The `_` prefix keeps
# heartbeats out of durable-stream capture by convention.
SYS_HEARTBEAT = "_sys.heartbeat"

# elastic-autoscaler drain protocol (resilience/autoscale.py +
# resilience/procsup.py scale_role): the supervisor publishes
# `_sys.drain.<role>` to retire one replica gracefully — the runner stops
# pulling new durable deliveries (detaching its consumers so unacked work
# redelivers to the surviving group members), flushes its UpsertCoalescer,
# finishes in-flight work, publishes a final heartbeat with
# `draining: true`, and exits. The supervisor enforces a deadline: a hung
# drain is SIGKILLed, and durable redelivery still loses nothing.
SYS_DRAIN = "_sys.drain"

# fleet telemetry plane (obs/fleet.py): each supervised role publishes
# bounded, periodic metric-snapshot deltas and completed span records under
# these prefixes (+ ".<role>"); the FleetAggregator in the API-role process
# (and the ProcessSupervisor) subscribes the wildcards and merges them into
# the federated `GET /metrics` exposition, the stitched cross-process
# flight-recorder traces, and the `GET /api/fleet` roll-up. Same `_` prefix
# convention as heartbeats: telemetry never enters durable-stream capture
# and never competes with the data path.
SYS_TELEMETRY_METRICS = "_sys.telemetry.metrics"
SYS_TELEMETRY_SPANS = "_sys.telemetry.spans"

# request-reply (query path)
TASKS_EMBEDDING_FOR_QUERY = "tasks.embedding.for_query"
TASKS_SEARCH_SEMANTIC_REQUEST = "tasks.search.semantic.request"
# graph-augmented search (the reference's knowledge-graph limb, finally
# load-bearing end-to-end: entity extraction → graph upsert → THIS query
# surface): token-overlap document lookup over the graph store, served by
# knowledge_graph behind POST /api/search/graph
TASKS_SEARCH_GRAPH_REQUEST = "tasks.search.graph.request"
# vector-store point count (request-reply, served by vector_memory): the
# operational surface a multi-process deployment needs to verify zero-loss
# ingest from OUTSIDE the store-owning process (bench/load.py --multiproc)
TASKS_MEMORY_COUNT = "tasks.memory.count"

ALL_SUBJECTS = [
    TASKS_PERCEIVE_URL,
    DATA_RAW_TEXT_DISCOVERED,
    DATA_TEXT_WITH_EMBEDDINGS,
    DATA_PROCESSED_TEXT_TOKENIZED,
    TASKS_GENERATION_TEXT,
    EVENTS_TEXT_GENERATED,
    EVENTS_TEXT_GENERATED_PARTIAL,
    TASKS_GENERATION_CANCEL,
    TASKS_GENERATION_RESUME,
    TASKS_EMBEDDING_FOR_QUERY,
    TASKS_SEARCH_SEMANTIC_REQUEST,
    TASKS_SEARCH_GRAPH_REQUEST,
]

# engine plane (framework-internal, not part of the reference's wire surface):
# request-reply subjects fronting the TPU-owning engine process, so native C++
# worker shells stay thin (SURVEY.md §2 checklist item 4: "C++ worker talks to
# it over [RPC]"). Riding the bus instead of a separate RPC port means every
# engine op gets queue-group fan-in, trace headers, and micro-batching across
# all callers for free.
ENGINE_EMBED_BATCH = "engine.embed.batch"
ENGINE_EMBED_QUERY = "engine.embed.query"
ENGINE_RERANK = "engine.rerank"
ENGINE_GENERATE = "engine.generate"
ENGINE_VECTOR_UPSERT = "engine.vector.upsert"
ENGINE_VECTOR_SEARCH = "engine.vector.search"
# fused interactive query: embed + cosine top-k in ONE device program (served
# only when the engine process co-hosts the vector store; the api gateway
# falls back to the 2-hop embed→search orchestration otherwise)
ENGINE_QUERY_SEARCH = "engine.query.search"
ENGINE_GRAPH_SAVE = "engine.graph.save"
ENGINE_HEALTH = "engine.health"

# queue groups: the reference uses plain subscribe() with no queue groups, so a
# second replica would double-process every message (SURVEY.md §1-L3 notes).
# Every pipeline consumer here subscribes under a queue group so workers scale
# out horizontally.
QUEUE_PERCEPTION = "q.perception"
QUEUE_PREPROCESSING = "q.preprocessing"
QUEUE_VECTOR_MEMORY = "q.vector_memory"
QUEUE_KNOWLEDGE_GRAPH = "q.knowledge_graph"
QUEUE_TEXT_GENERATOR = "q.text_generator"
QUEUE_ENGINE = "q.engine"
