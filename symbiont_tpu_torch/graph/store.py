"""Property-graph store with MERGE semantics, persisted in sqlite (stdlib).

Copy of the JAX package's `symbiont_tpu/graph/store.py`.

Schema parity with the reference's Neo4j usage (reference:
services/knowledge_graph_service/src/main.rs:23-140):

- Document nodes, unique on original_id (constraint ensured at startup,
  main.rs:158-173), MERGE ON CREATE/ON MATCH updates source_url +
  processed_at_ms;
- Sentence nodes unique on text; (d)-[:HAS_SENTENCE {order}]->(s) edges;
  empty sentences skipped (main.rs:70-93);
- Token nodes unique on lowercase text (index on text_lc, main.rs:166-168),
  original case stored/updated as a property; (d)-[:CONTAINS_TOKEN]->(t)
  edges deduped; empty tokens skipped (main.rs:100-125);
- the whole document save is one transaction (main.rs:32-134).

sqlite gives the single-file durability Neo4j volumes gave the reference
(SURVEY.md §5.4 DB-as-truth), without an external server.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from symbiont_tpu_torch.config import GraphStoreConfig
from symbiont_tpu_torch.schema import TokenizedTextMessage

_SCHEMA = """
CREATE TABLE IF NOT EXISTS nodes (
  node_id INTEGER PRIMARY KEY AUTOINCREMENT,
  label TEXT NOT NULL,
  merge_key TEXT NOT NULL,
  props TEXT NOT NULL DEFAULT '{}',
  created_at_ms INTEGER NOT NULL,
  UNIQUE (label, merge_key)
);
CREATE INDEX IF NOT EXISTS idx_nodes_label_key ON nodes(label, merge_key);
CREATE TABLE IF NOT EXISTS edges (
  src INTEGER NOT NULL REFERENCES nodes(node_id),
  dst INTEGER NOT NULL REFERENCES nodes(node_id),
  type TEXT NOT NULL,
  props TEXT NOT NULL DEFAULT '{}',
  UNIQUE (src, dst, type, props)
);
CREATE INDEX IF NOT EXISTS idx_edges_src ON edges(src, type);
"""


class GraphStore:
    def __init__(self, config: Optional[GraphStoreConfig] = None,
                 path: Optional[str] = None):
        self.config = config or GraphStoreConfig()
        if path is None:
            root = Path(self.config.data_dir)
            root.mkdir(parents=True, exist_ok=True)
            path = str(root / "graph.sqlite3")
        self._lock = threading.RLock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self.ensure_schema()

    def ensure_schema(self) -> None:
        """Idempotent constraint/index setup (reference: main.rs:158-173)."""
        with self._lock, self._db:
            self._db.executescript(_SCHEMA)

    # ------------------------------------------------------------ primitives

    def _merge_node(self, cur, label: str, key: str, props: Dict) -> int:
        """MERGE: create with props if absent, else update props (ON MATCH)."""
        now = int(time.time() * 1000)
        row = cur.execute(
            "SELECT node_id, props FROM nodes WHERE label=? AND merge_key=?",
            (label, key)).fetchone()
        if row is None:
            cur.execute(
                "INSERT INTO nodes (label, merge_key, props, created_at_ms) "
                "VALUES (?,?,?,?)",
                (label, key, json.dumps(props, ensure_ascii=False), now))
            return cur.lastrowid
        node_id, old = row
        merged = {**json.loads(old), **props}
        cur.execute("UPDATE nodes SET props=? WHERE node_id=?",
                    (json.dumps(merged, ensure_ascii=False), node_id))
        return node_id

    def _merge_edge(self, cur, src: int, dst: int, etype: str, props: Dict) -> None:
        cur.execute(
            "INSERT OR IGNORE INTO edges (src, dst, type, props) VALUES (?,?,?,?)",
            (src, dst, etype, json.dumps(props, sort_keys=True)))

    # ------------------------------------------------------------- document

    def save_tokenized(self, msg: TokenizedTextMessage) -> int:
        """Single-transaction document save (reference: save_to_neo4j,
        main.rs:23-140). Returns the Document node id."""
        with self._lock, self._db:
            cur = self._db.cursor()
            doc_id = self._merge_node(cur, "Document", msg.original_id, {
                "original_id": msg.original_id,
                "source_url": msg.source_url,
                "processed_at_ms": msg.timestamp_ms,
            })
            for order, sentence in enumerate(msg.sentences):
                if not sentence.strip():
                    continue  # reference: main.rs:71-77
                s_id = self._merge_node(cur, "Sentence", sentence, {"text": sentence})
                self._merge_edge(cur, doc_id, s_id, "HAS_SENTENCE", {"order": order})
            for token in msg.tokens:
                token = token.strip()
                if not token:
                    continue  # reference: main.rs:103-109
                t_id = self._merge_node(cur, "Token", token.lower(), {
                    "text_lc": token.lower(),
                    "text_original_case": token,
                })
                self._merge_edge(cur, doc_id, t_id, "CONTAINS_TOKEN", {})
            return doc_id

    # --------------------------------------------------------------- queries

    def get_document(self, original_id: str) -> Optional[dict]:
        with self._lock:
            row = self._db.execute(
                "SELECT node_id, props FROM nodes WHERE label='Document' "
                "AND merge_key=?", (original_id,)).fetchone()
            if row is None:
                return None
            return {"node_id": row[0], **json.loads(row[1])}

    def document_sentences(self, original_id: str) -> List[str]:
        """Sentences of a document in HAS_SENTENCE order."""
        doc = self.get_document(original_id)
        if doc is None:
            return []
        with self._lock:
            rows = self._db.execute(
                "SELECT n.props, e.props FROM edges e "
                "JOIN nodes n ON n.node_id = e.dst "
                "WHERE e.src=? AND e.type='HAS_SENTENCE'", (doc["node_id"],)
            ).fetchall()
        pairs = [(json.loads(ep).get("order", 0), json.loads(np_)["text"])
                 for np_, ep in rows]
        return [text for _, text in sorted(pairs)]

    def documents_containing_token(self, token: str,
                                   limit: int = 0) -> List[str]:
        """original_ids of documents containing a token (case-insensitive),
        sorted. limit > 0 bounds the rows INSIDE the query — a stopword
        matching the whole corpus must not materialize and sort every
        document id just to be sliced by the caller."""
        q = ("SELECT DISTINCT d.merge_key FROM nodes t "
             "JOIN edges e ON e.dst = t.node_id AND e.type='CONTAINS_TOKEN' "
             "JOIN nodes d ON d.node_id = e.src "
             "WHERE t.label='Token' AND t.merge_key=? "
             "ORDER BY d.merge_key")
        args: tuple = (token.lower(),)
        if limit > 0:
            q += " LIMIT ?"
            args += (limit,)
        with self._lock:
            rows = self._db.execute(q, args).fetchall()
        return [r[0] for r in rows]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {}
            for label in ("Document", "Sentence", "Token"):
                out[label] = self._db.execute(
                    "SELECT COUNT(*) FROM nodes WHERE label=?", (label,)).fetchone()[0]
            out["edges"] = self._db.execute("SELECT COUNT(*) FROM edges").fetchone()[0]
            return out

    def close(self) -> None:
        with self._lock:
            self._db.close()
