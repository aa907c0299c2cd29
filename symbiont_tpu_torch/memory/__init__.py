"""Vector memory of the port: the JAX package's store with a CUDA-resident
corpus (memory/vector_store.py), and `make_vector_store`, the port's
counterpart of `symbiont_tpu/memory/qdrant_backend.py`'s factory for the
embedded store only."""


def make_vector_store(config, device=None):
    """The embedded store on `device` (the engine's). An external Qdrant
    backend (`vector_store.uri`), with its breaker and spill wrapper, is not
    ported yet (ROADMAP A8 stage 2) and raises by name."""
    if config.uri:
        raise ValueError(
            f"vector_store.uri={config.uri!r}: the external Qdrant backend "
            "is not ported yet (ROADMAP A8 stage 2)")
    from symbiont_tpu_torch.memory.vector_store import VectorStore

    return VectorStore(config, device=device)
