"""symbiont_tpu_torch — the PyTorch/CUDA port of symbiont_tpu.

The JAX package `symbiont_tpu` is the reference; this package re-implements
its parts in PyTorch for one NVIDIA H100 and is held against it on the same
weights and inputs (tests/test_torch_*.py). It imports nothing of
`symbiont_tpu` and never imports `jax`: host-only modules it needs are kept
as its own copies under the same module names.

Ported so far: the embedding path (SURVEY.md fact 1) — text → tokenizer →
length/batch buckets → BERT encoder → masked mean pool → cosine top-k over a
device-resident corpus, plus the cross-encoder rerank; the encoder
fine-tune (contrastive train step) through the flash-attention backward;
text generation from GPT-2 and Llama checkpoints (streams, continuous
batching, paged KV, speculation, journalled streams that resume on
another worker); and the stack around the engines (bus, services,
gateway, runner), in one process or as supervised processes over a TCP
bus and broker.

config    : every section of the JAX config, SymbiontConfig and
            load_config (same fields, defaults and SYMBIONT_* names)
device    : the one device resolver (CUDA unless the caller asks for the CPU)
engine    : TorchEngine (embed / fused query search / rerank), LmEngine
            (generation), bucketing, tokenizer
models    : BERT encoder + cross-encoder, GPT-2/Llama decoder, checkpoint
            conversion, quantization, and the bridge from JAX param trees
ops       : hand-written CUDA kernels (flash-attention forward and
            backward) and the nvcc/ctypes build that loads them
train     : contrastive train step (AdamW on float32 masters) and
            checkpoints in the JAX package's format
memory    : VectorStore with a CUDA-resident corpus, the external Qdrant
            backend
kv        : the paged KV pool and the radix prefix cache
graph     : the embedded sqlite knowledge-graph store, the external Neo4j
            backend
bus       : the in-process message bus (pub/sub, request-reply, durable
            streams with a dead-letter store), the TCP client and the
            Python broker it talks to
schema    : the wire structs and the binary embeddings frame
services  : perception, preprocessing, vector memory, knowledge graph,
            text generator, the engine plane and the HTTP/SSE gateway
resilience: admission control, the dead-letter store, fault injection,
            loop supervision, circuit breakers and store spills, the
            process supervisor, the autoscaler and its drains, the
            generation journal
obs       : device memory, dispatch ledger, engine timeline, usage, the
            span flight recorder and its Prometheus, Chrome-trace and
            critical-path renderings, the fleet telemetry plane, the SLO
            watchdog
runner    : SymbiontStack, the whole stack in one process or one role of
            a supervised deployment
lint      : the contract linter over the port's tree, with the port's own
            allowlist (the host-sync inventory `obs/xprof` reads)
deploy    : the offline compose-topology validator and the live-store
            compat check
"""

__version__ = "0.1.0"
