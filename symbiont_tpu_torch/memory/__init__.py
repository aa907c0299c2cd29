"""Vector memory of the port: the JAX package's store with a CUDA-resident
corpus (memory/vector_store.py)."""
