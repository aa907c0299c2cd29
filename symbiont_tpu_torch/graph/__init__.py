"""Embedded knowledge-graph store (Neo4j-parity semantics, sqlite-backed).

Copy of the JAX package's `symbiont_tpu/graph/__init__.py`.

The reference stores graph data in an external Neo4j over Bolt (reference:
services/knowledge_graph_service/src/main.rs). That path is ORPHANED in
v0.3.0 — no producer publishes its input subject (SURVEY.md fact #3). Here the
graph store is embedded in the framework and the producing side is restored
(preprocessing publishes data.processed_text.tokenized).
"""

from symbiont_tpu_torch.graph.store import GraphStore

__all__ = ["GraphStore"]
