"""Embedded knowledge-graph store (Neo4j-parity semantics, sqlite-backed).

Copy of the JAX package's `symbiont_tpu/graph/__init__.py`, with
`make_graph_store` for the embedded store.

The reference stores graph data in an external Neo4j over Bolt (reference:
services/knowledge_graph_service/src/main.rs). That path is ORPHANED in
v0.3.0 — no producer publishes its input subject (SURVEY.md fact #3). Here the
graph store is embedded in the framework and the producing side is restored
(preprocessing publishes data.processed_text.tokenized).
"""

from symbiont_tpu_torch.graph.store import GraphStore

__all__ = ["GraphStore", "make_graph_store"]


def make_graph_store(config):
    """The embedded sqlite store: the port's counterpart of
    `symbiont_tpu/graph/neo4j_backend.py`'s factory. An external Neo4j
    backend (`graph_store.uri`), with its breaker and spill wrapper, is not
    ported yet (ROADMAP A8 stage 2) and raises by name."""
    if config.uri:
        raise ValueError(
            f"graph_store.uri={config.uri!r}: the external Neo4j backend is "
            "not ported yet (ROADMAP A8 stage 2)")
    return GraphStore(config)
