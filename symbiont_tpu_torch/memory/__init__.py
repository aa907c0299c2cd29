"""Vector memory of the port: the JAX package's store with a CUDA-resident
corpus (memory/vector_store.py) and the external Qdrant backend with the
factory that picks between them (memory/qdrant_backend.py,
`make_vector_store`)."""
