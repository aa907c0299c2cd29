"""Worker services — the orbit around the TPU engine.

Copy of the JAX package's `symbiont_tpu/services/__init__.py`.

Each reference worker (one Rust binary + NATS loop, SURVEY.md §1-L2) maps to a
service class here with the same subjects and payloads; the runner
(symbiont_tpu_torch.runner) hosts any subset in one process over the in-proc bus, or
each can run against the native broker for multi-process deployments. Native
C++ counterparts for the bus-and-glue services live under native/.
"""
