"""Offline deployment-topology validation.

Copy of the JAX package's `symbiont_tpu/deploy.py`, over the port's
`subjects`, config layer (`config._ENV_ALIASES`, `SymbiontConfig`), store
backends (`memory/qdrant_backend.QdrantStore`,
`graph/neo4j_backend.Neo4jGraphStore`) and `schema.TokenizedTextMessage`.

Without docker, deploy/docker-compose.yml cannot be *executed* — but nearly everything that goes wrong in a compose topology is
statically checkable, and one class of bug is historically load-bearing: the
reference shipped v0.3.0 with `knowledge_graph_service` subscribed to a
subject NO service publishes (reference: knowledge_graph_service/src/main.rs:9,
CHANGELOG.md:57-60 — the orphaned `data.processed_text.tokenized`). The
orphan check below makes that bug class impossible to ship in a compose file.

Checks:
  1. YAML parses; every service has image or build; build dockerfiles exist.
  2. Native-image `command:` entrypoints name real native binaries.
  3. Every SYMBIONT_* env var matches a real config field (catches typos —
     the config system ignores unknown env, so a typo'd var silently noops).
  4. depends_on targets exist.
  5. Subject topology: every consumed bus subject has a producer and vice
     versa, derived from the role→subject tables mirroring SURVEY.md §1-L3.

Usage:  python -m symbiont_tpu_torch.deploy deploy/docker-compose.yml
Exit 0 clean, 1 with one problem per line on stderr.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Dict, List, Set, Tuple

from symbiont_tpu_torch import subjects as S

NATIVE_BINARIES = {"symbus_broker", "perception", "preprocessing",
                   "vector_memory", "knowledge_graph", "text_generator",
                   "api_gateway"}

# role → (produces, consumes) over pipeline + request-reply subjects
# (request-reply: the requester "consumes" the service's reply inline, so the
# responder side is modeled as the producer of the reply service).
_PIPELINE: Dict[str, Tuple[Set[str], Set[str]]] = {
    "gateway": ({S.TASKS_PERCEIVE_URL, S.TASKS_GENERATION_TEXT},
                {S.EVENTS_TEXT_GENERATED}),
    "perception": ({S.DATA_RAW_TEXT_DISCOVERED}, {S.TASKS_PERCEIVE_URL}),
    "preprocessing": ({S.DATA_TEXT_WITH_EMBEDDINGS,
                       S.DATA_PROCESSED_TEXT_TOKENIZED},
                      {S.DATA_RAW_TEXT_DISCOVERED}),
    "vector_memory": (set(), {S.DATA_TEXT_WITH_EMBEDDINGS}),
    "knowledge_graph": (set(), {S.DATA_PROCESSED_TEXT_TOKENIZED}),
    "text_generator": ({S.EVENTS_TEXT_GENERATED}, {S.TASKS_GENERATION_TEXT}),
    # the engine plane serves request-reply only (engine.*): no pipeline edges
    "engine": (set(), set()),
}

# compose service name / runner service name → topology role
_ROLE_BY_NAME = {"gateway": "gateway", "api": "gateway",
                 "api_gateway": "gateway"}


def _known_env_keys() -> Set[str]:
    """Every env var the config layer actually reads (canonical + aliases),
    plus process-level vars consumed outside the config tree."""
    from symbiont_tpu_torch.config import _ENV_ALIASES, SymbiontConfig

    cfg = SymbiontConfig()
    keys = set(_ENV_ALIASES)
    for section_field in dataclasses.fields(cfg):
        section = getattr(cfg, section_field.name)
        for f in dataclasses.fields(section):
            keys.add(f"SYMBIONT_{section_field.name.upper()}_{f.name.upper()}")
    # read directly by services/tools, not through the config tree
    keys |= {"SYMBIONT_BUS_URL", "SYMBIONT_FRONTEND_PATH",
             "SYMBIONT_COORDINATOR", "SYMBIONT_NUM_PROCESSES",
             "SYMBIONT_PROCESS_ID", "SYMBIONT_MODEL_DIR"}
    return keys


def _env_dict(svc: dict) -> Dict[str, str]:
    """Normalize compose `environment:` — both the list form
    (["KEY=value", ...]) and the mapping form ({KEY: value}) are valid
    compose syntax and must be validated identically."""
    env = svc.get("environment") or {}
    if isinstance(env, dict):
        return {str(k): "" if v is None else str(v) for k, v in env.items()}
    out: Dict[str, str] = {}
    for e in env:
        if isinstance(e, str):
            k, _, v = e.partition("=")
            out[k] = v
    return out


def _service_roles(name: str, svc: dict) -> List[str]:
    """Topology roles a compose service plays."""
    cmd = svc.get("command") or []
    entry = cmd[0] if isinstance(cmd, list) and cmd else (
        cmd.split()[0] if isinstance(cmd, str) and cmd else "")
    if entry in _PIPELINE:
        return [entry]
    if entry in _ROLE_BY_NAME:
        return [_ROLE_BY_NAME[entry]]
    # python runner container: roles from SYMBIONT_RUNNER_SERVICES
    wanted = _env_dict(svc).get("SYMBIONT_RUNNER_SERVICES")
    if wanted:
        if wanted == "all":
            return [r for r in _PIPELINE]
        return [_ROLE_BY_NAME.get(w.strip(), w.strip())
                for w in wanted.split(",") if w.strip()]
    if name in _PIPELINE or name in _ROLE_BY_NAME:
        return [_ROLE_BY_NAME.get(name, name)]
    return []


def validate_compose(path: str | Path) -> List[str]:
    import yaml

    path = Path(path)
    problems: List[str] = []
    try:
        doc = yaml.safe_load(path.read_text())
    except yaml.YAMLError as e:
        return [f"YAML parse error: {e}"]
    services = (doc or {}).get("services")
    if not isinstance(services, dict) or not services:
        return ["no services defined"]

    known_env = _known_env_keys()
    roles: List[str] = []
    for name, svc in services.items():
        svc = svc or {}
        build, image = svc.get("build"), svc.get("image")
        if not build and not image:
            problems.append(f"{name}: neither build nor image")
        if build:
            # string form `build: <context>` is compose shorthand for
            # context-only with Dockerfile at the context root
            if isinstance(build, str):
                build = {"context": build}
            ctx = (path.parent / build.get("context", ".")).resolve()
            df = ctx / build.get("dockerfile", "Dockerfile")
            if not df.exists():
                problems.append(f"{name}: dockerfile {df} does not exist")
        cmd = svc.get("command") or []
        entry = cmd[0] if isinstance(cmd, list) and cmd else (
            cmd.split()[0] if isinstance(cmd, str) and cmd else "")
        if build and entry and entry not in NATIVE_BINARIES \
                and entry not in ("python", "python3"):
            problems.append(f"{name}: command {entry!r} is not a native "
                            f"binary ({sorted(NATIVE_BINARIES)}) or python")
        for key in _env_dict(svc):
            if key.startswith("SYMBIONT_") and key not in known_env:
                problems.append(f"{name}: unknown env var {key} "
                                "(typo? config would silently ignore it)")
        deps = svc.get("depends_on") or {}
        dep_names = deps if isinstance(deps, list) else list(deps)
        for d in dep_names:
            if d not in services:
                problems.append(f"{name}: depends_on unknown service {d!r}")
        if not svc.get("profiles"):  # optional-profile services excluded
            roles.extend(_service_roles(name, svc))

    # subject orphan check over the default-profile topology
    produced: Set[str] = set()
    consumed: Set[str] = set()
    for r in roles:
        if r in _PIPELINE:
            p, c = _PIPELINE[r]
            produced |= p
            consumed |= c
    for subj in sorted(consumed - produced):
        problems.append(f"orphaned subject: {subj} is consumed but no "
                        "service in the topology produces it "
                        "(the reference's v0.3.0 knowledge-graph bug class)")
    for subj in sorted(produced - consumed):
        problems.append(f"dead-end subject: {subj} is produced but no "
                        "service in the topology consumes it")
    return problems


# ---------------------------------------------------------------------------
# Live-store compatibility check
#
# The adapters (memory/qdrant_backend.py, graph/neo4j_backend.py) are
# validated offline against recorded wire fixtures and fake servers — but the
# reference runs REAL Qdrant/Neo4j. This suite is the one-command check a
# migrating deployment runs against its live stores on first deployment:
#
#   python -m symbiont_tpu_torch.deploy --compat qdrant=http://host:6333 \
#                                          neo4j=http://host:7474
#
# Neo4j credentials ride the reference's env aliases (NEO4J_USER /
# NEO4J_PASSWORD) or SYMBIONT_GRAPH_USER / SYMBIONT_GRAPH_PASSWORD.
# Every check runs in a throwaway namespace (fresh collection name /
# namespaced document ids) and cleans up after itself — safe against a
# store that also holds production data.
# ---------------------------------------------------------------------------


def _qdrant_compat(uri: str, say) -> List[str]:
    import os
    import time
    import urllib.error

    import numpy as np

    from symbiont_tpu_torch.config import VectorStoreConfig
    from symbiont_tpu_torch.memory.qdrant_backend import QdrantStore

    failures: List[str] = []

    def check(name: str, fn) -> None:
        try:
            fn()
            say(f"  ok   qdrant: {name}")
        except Exception as e:
            failures.append(f"qdrant: {name}: {e}")
            say(f"  FAIL qdrant: {name}: {e}")

    coll = f"symbiont_compat_{os.getpid()}_{int(time.time())}"
    dim = 384
    cfg = VectorStoreConfig(uri=uri, dim=dim, collection=coll)
    store = QdrantStore(cfg, retries=2, retry_delay_s=1.0)
    rng = np.random.default_rng(0)

    check("connect + create collection (dim 384, cosine)",
          store.ensure_collection)
    check("ensure is idempotent", store.ensure_collection)

    def dim_conflict():
        other = QdrantStore(VectorStoreConfig(uri=uri, dim=128,
                                              collection=coll),
                            retries=1, retry_delay_s=0.1)
        try:
            other.ensure_collection()
        except ValueError:
            return  # expected: fail-fast on dim mismatch
        raise AssertionError("dim-mismatched ensure did not fail fast")
    check("dim conflict fails fast with a typed error", dim_conflict)

    vecs = rng.normal(size=(8, dim)).astype(np.float32)
    payload = {"sentence_text": "héllo wörld — 多言語", "sentence_order": 1,
               "model_name": "compat", "nested": {"k": [1, 2, 3]}}
    pts = [(f"00000000-0000-4000-8000-{i:012d}", vecs[i], dict(payload))
           for i in range(8)]

    def small_roundtrip():
        assert store.upsert(pts) == 8
        assert store.count() == 8, store.count()
        hits = store.search(vecs[3], 3)
        assert hits and hits[0].id == pts[3][0], hits
        assert hits[0].score > 0.99, hits[0].score
        assert hits[0].payload["sentence_text"] == payload["sentence_text"]
        assert hits[0].payload["nested"] == payload["nested"]
    check("upsert + exact count + self-match search + unicode payload "
          "round-trip", small_roundtrip)

    big_n = 1100  # 3 chunks of UPSERT_CHUNK=512; >10 MB of JSON total
    big = [(f"00000000-0000-4000-9000-{i:012d}",
            rng.normal(size=dim).astype(np.float32),
            {"sentence_text": "x" * 4096, "sentence_order": i})
           for i in range(big_n)]

    def big_upsert():
        assert store.upsert(big) == big_n
        assert store.count() == 8 + big_n, store.count()
    check(f"chunked >10MB upsert ({big_n} points, wait=true)", big_upsert)

    def idempotent():
        store.upsert(pts)
        assert store.count() == 8 + big_n, store.count()
    check("re-upsert of same ids is idempotent (no duplicates)", idempotent)

    def error_shape():
        ghost = QdrantStore(VectorStoreConfig(uri=uri, dim=dim,
                                              collection=coll + "_missing"),
                            retries=1, retry_delay_s=0.1)
        try:
            ghost.search(vecs[0], 1)
        except urllib.error.HTTPError:
            return  # expected: surfaced as a typed HTTP error
        raise AssertionError("search on a missing collection did not error")
    check("missing-collection search surfaces an HTTP error", error_shape)

    def cleanup():
        store._call("DELETE", f"/collections/{coll}")
    check("cleanup: delete compat collection", cleanup)
    return failures


def _neo4j_compat(uri: str, say) -> List[str]:
    import os
    import time

    from symbiont_tpu_torch.config import GraphStoreConfig
    from symbiont_tpu_torch.graph.neo4j_backend import Neo4jGraphStore
    from symbiont_tpu_torch.schema import TokenizedTextMessage

    failures: List[str] = []

    def check(name: str, fn) -> None:
        try:
            fn()
            say(f"  ok   neo4j: {name}")
        except Exception as e:
            failures.append(f"neo4j: {name}: {e}")
            say(f"  FAIL neo4j: {name}: {e}")

    user = (os.environ.get("SYMBIONT_GRAPH_USER")
            or os.environ.get("NEO4J_USER") or "neo4j")
    password = (os.environ.get("SYMBIONT_GRAPH_PASSWORD")
                or os.environ.get("NEO4J_PASSWORD") or "")
    store = Neo4jGraphStore(GraphStoreConfig(uri=uri, user=user,
                                             password=password),
                            retries=2, retry_delay_s=1.0)
    ns = f"symbiont-compat-{os.getpid()}-{int(time.time())}"

    check("connect + ensure schema (constraint + index)", store.ensure_schema)
    check("ensure_schema is idempotent", store.ensure_schema)

    msg = TokenizedTextMessage(
        original_id=f"{ns}-doc-1", source_url="http://compat",
        sentences=["Première phrase — 多言語.", "  ", "Second one."],
        tokens=["Alpha", "beta", " ", "ALPHA", "多言語"],
        timestamp_ms=int(time.time() * 1000))

    def save():
        doc_id = store.save_tokenized(msg)
        assert isinstance(doc_id, int), doc_id
    check("save_tokenized (unicode, skip-empty, MERGE semantics)", save)
    check("re-save of the same document is idempotent (MERGE)", save)

    big = TokenizedTextMessage(
        original_id=f"{ns}-doc-big", source_url="http://compat",
        sentences=[f"Sentence number {i} of the large document."
                   for i in range(200)],
        tokens=[f"token{i}" for i in range(2000)],
        timestamp_ms=int(time.time() * 1000))
    check("large single-transaction save (200 sentences, 2000 tokens)",
          lambda: store.save_tokenized(big))

    def counts():
        c = store.counts()
        assert all(isinstance(v, int) for v in c.values()), c
    check("counts() returns integer node counts", counts)

    def cleanup():
        store._commit([(
            "MATCH (d:Document) WHERE d.original_id STARTS WITH $p "
            "DETACH DELETE d", {"p": ns})])
    check("cleanup: detach-delete compat documents", cleanup)
    return failures


def compat_check(targets: Dict[str, str], say=print) -> List[str]:
    """Run the live-store compat suites for every given target
    ("qdrant"/"neo4j" → base URI). Returns the list of failures."""
    failures: List[str] = []
    for kind, uri in targets.items():
        say(f"compat: {kind} at {uri}")
        if kind == "qdrant":
            failures += _qdrant_compat(uri, say)
        elif kind == "neo4j":
            failures += _neo4j_compat(uri, say)
        else:
            failures.append(f"unknown compat target {kind!r} "
                            "(expected qdrant=... or neo4j=...)")
    return failures


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("--help", "-h"):
        # --help must not fall through to validate_compose("--help") and
        # die with a FileNotFoundError traceback
        print(__doc__, file=sys.stderr)
        return 0 if argv else 2
    if argv[0] == "--compat":
        targets: Dict[str, str] = {}
        for arg in argv[1:]:
            if "=" not in arg:
                print(f"--compat arguments must be kind=uri, got {arg!r}",
                      file=sys.stderr)
                return 2
            kind, uri = arg.split("=", 1)
            if kind in targets:
                # a silent overwrite would check only B of `qdrant=A
                # qdrant=B` while the operator believed both were covered
                print(f"--compat target {kind!r} given twice "
                      f"({targets[kind]!r} then {uri!r}) — pass each kind "
                      "once", file=sys.stderr)
                return 2
            targets[kind] = uri
        if not targets:
            print("--compat needs at least one of qdrant=URI neo4j=URI",
                  file=sys.stderr)
            return 2
        failures = compat_check(targets)
        if failures:
            print(f"{len(failures)} compat check(s) FAILED", file=sys.stderr)
            return 1
        print("all compat checks passed")
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not Path(argv[0]).exists():
        print(f"compose file {argv[0]!r} does not exist", file=sys.stderr)
        return 2
    problems = validate_compose(argv[0])
    for p in problems:
        print(f"TOPOLOGY: {p}", file=sys.stderr)
    if not problems:
        print(f"{argv[0]}: topology OK")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
