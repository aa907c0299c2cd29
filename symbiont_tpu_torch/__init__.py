"""symbiont_tpu_torch — the PyTorch/CUDA port of symbiont_tpu.

The JAX package `symbiont_tpu` is the reference; this package re-implements
its parts in PyTorch for one NVIDIA H100 and is held against it on the same
weights and inputs (tests/test_torch_*.py). It imports nothing of
`symbiont_tpu` and never imports `jax`: host-only modules it needs are kept
as its own copies under the same module names.

Ported so far: the embedding path (SURVEY.md fact 1) — text → tokenizer →
length/batch buckets → BERT encoder → masked mean pool → cosine top-k over a
device-resident corpus, plus the cross-encoder rerank.

config    : EngineConfig / VectorStoreConfig (same fields and defaults)
device    : the one device resolver (CUDA unless the caller asks for the CPU)
engine    : TorchEngine (embed / fused query search / rerank), bucketing,
            tokenizer
models    : BERT encoder + cross-encoder, and the bridge from JAX param trees
ops       : hand-written CUDA kernels (flash-attention forward) and the
            nvcc/ctypes build that loads them
memory    : VectorStore with a CUDA-resident corpus
"""

__version__ = "0.1.0"
