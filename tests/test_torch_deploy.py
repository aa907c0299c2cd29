"""The port's deployment tools (symbiont_tpu_torch/deploy.py) against the
JAX package's (symbiont_tpu/deploy.py).

The cases of tests/test_deploy_artifacts.py, repeated on the port: the
shipped `deploy/docker-compose.yml` validated statically (YAML, dockerfiles
and their COPY sources, env vars against the port's config layer, the
subject-topology orphan check), the CLI, and the live-store `--compat`
suite against the fake Qdrant and Neo4j servers. Then parity: the port's
`validate_compose` gives JAX's problem list on the shipped compose and on
each broken copy of it.
"""

import re
from pathlib import Path

import pytest

yaml = pytest.importorskip("yaml")

from symbiont_tpu.deploy import validate_compose as jax_validate  # noqa: E402
from symbiont_tpu_torch.deploy import main, validate_compose  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COMPOSE = REPO / "deploy" / "docker-compose.yml"


def _doc():
    return yaml.safe_load(COMPOSE.read_text())


def _dump(doc, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(doc))
    return path


# each broken copy: (edit of the compose doc, path under tmp it is written to)
def _no_preprocessing(doc, tmp):
    del doc["services"]["preprocessing"]
    return tmp / "compose.yml"


def _env_typo(doc, tmp):
    doc["services"]["engine"]["environment"].append("SYMBIONT_ENGINE_MODELDIR=/oops")
    return tmp / "compose.yml"


def _mapping_env(doc, tmp):
    doc["services"]["engine"]["environment"] = {
        "SYMBIONT_ENGINE_MODELDIR": "/oops",  # typo'd key, mapping form
        "SYMBIONT_RUNNER_SERVICES": "engine",
        "SYMBIONT_BUS_URL": "symbus://broker:4233"}
    return tmp / "compose.yml"


def _string_build(doc, tmp):
    doc["services"]["broker"]["build"] = str(tmp / "nodir")
    return tmp / "compose.yml"


def _bad_depends_and_dockerfile(doc, tmp):
    doc["services"]["gateway"]["depends_on"] = {"nonexistent": {
        "condition": "service_started"}}
    doc["services"]["broker"]["build"]["dockerfile"] = "deploy/Nope"
    # keep the ../ build context resolvable from the tmp copy
    doc["services"]["broker"]["build"]["context"] = str(REPO)
    doc["services"]["gateway"]["build"]["context"] = str(REPO)
    return tmp / "deploy" / "compose.yml"


BROKEN = {"no_preprocessing": _no_preprocessing, "env_typo": _env_typo,
          "mapping_env": _mapping_env, "string_build": _string_build,
          "bad_depends_and_dockerfile": _bad_depends_and_dockerfile}


def _broken(name, tmp_path) -> Path:
    doc = _doc()
    return _dump(doc, BROKEN[name](doc, tmp_path))


def test_shipped_compose_is_clean():
    assert validate_compose(COMPOSE) == []


@pytest.mark.parametrize("name", ["shipped"] + sorted(BROKEN))
def test_problems_equal_jax(tmp_path, name):
    path = COMPOSE if name == "shipped" else _broken(name, tmp_path)
    assert validate_compose(path) == jax_validate(path)


def test_compose_covers_reference_bringup():
    svcs = _doc()["services"]
    for required in ("broker", "engine", "perception", "preprocessing", "vector_memory",
                     "knowledge_graph", "text_generator", "gateway"):
        assert required in svcs, required
        assert not svcs[required].get("profiles"), f"{required} must be in the default profile"
    assert svcs["qdrant"]["profiles"] == ["external-stores"]
    assert svcs["qdrant"]["image"] == "qdrant/qdrant:v1.14.0"
    assert svcs["neo4j"]["image"] == "neo4j:5.18.0"
    assert "healthcheck" in svcs["broker"] and "healthcheck" in svcs["gateway"]
    for w in ("perception", "preprocessing", "vector_memory", "knowledge_graph",
              "text_generator", "engine"):
        assert svcs[w]["depends_on"]["broker"]["condition"] == "service_healthy", w


def test_dockerfile_copy_sources_exist():
    for df in ("Dockerfile.native", "Dockerfile.engine"):
        text = (REPO / "deploy" / df).read_text()
        assert text.lstrip().startswith(("#", "ARG", "FROM"))
        assert "FROM" in text
        for m in re.finditer(r"^COPY (?!--from)([^\n]+)", text, re.M):
            *sources, _dest = m.group(1).split()
            for src in sources:
                assert (REPO / src).exists(), f"{df}: COPY source {src} missing"


def test_orphaned_subject_detected(tmp_path):
    problems = validate_compose(_broken("no_preprocessing", tmp_path))
    assert any("orphaned subject: data.text.with_embeddings" in x for x in problems), problems
    assert any("dead-end subject: data.raw_text.discovered" in x for x in problems), problems


def test_env_typo_detected(tmp_path):
    problems = validate_compose(_broken("env_typo", tmp_path))
    assert any("SYMBIONT_ENGINE_MODELDIR" in x for x in problems), problems


def test_mapping_style_environment_also_validated(tmp_path):
    problems = validate_compose(_broken("mapping_env", tmp_path))
    assert any("SYMBIONT_ENGINE_MODELDIR" in x for x in problems), problems
    assert all("subject" not in x for x in problems), problems


def test_string_form_build_checks_dockerfile(tmp_path):
    problems = validate_compose(_broken("string_build", tmp_path))
    assert any("broker" in x and "does not exist" in x for x in problems), problems


def test_bad_depends_on_and_missing_dockerfile_detected(tmp_path):
    problems = validate_compose(_broken("bad_depends_and_dockerfile", tmp_path))
    assert any("depends_on unknown service 'nonexistent'" in x for x in problems), problems
    assert any("Nope does not exist" in x for x in problems), problems


def test_known_env_keys_read_the_ports_config():
    """Every SYMBIONT_* name the port's config layer reads is known: JAX's
    set plus the one field only the port's config has (`lm.force_cpu`)."""
    from symbiont_tpu.deploy import _known_env_keys as jax_keys
    from symbiont_tpu_torch.deploy import _known_env_keys

    assert _known_env_keys() - jax_keys() == {"SYMBIONT_LM_FORCE_CPU"}
    assert jax_keys() <= _known_env_keys()


def test_cli_entrypoint(capsys):
    assert main([str(COMPOSE)]) == 0
    assert "topology OK" in capsys.readouterr().out


def test_compat_command_against_fakes(capsys):
    """The live-store compat command: the FULL `--compat qdrant=...
    neo4j=...` CLI against the fake servers, every check green end to end."""
    import threading
    from http.server import ThreadingHTTPServer

    from tests.test_neo4j_backend import _FakeNeo4j
    from tests.test_qdrant_backend import _FakeQdrant

    q = ThreadingHTTPServer(("127.0.0.1", 0), _FakeQdrant)
    q.fake_store = {"collections": {}}
    n = ThreadingHTTPServer(("127.0.0.1", 0), _FakeNeo4j)
    n.state = {"statements": [], "auth": [], "paths": []}
    for srv in (q, n):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rc = main(["--compat", f"qdrant=http://127.0.0.1:{q.server_address[1]}",
                   f"neo4j=http://127.0.0.1:{n.server_address[1]}"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "all compat checks passed" in out and "FAIL" not in out
        assert q.fake_store["collections"] == {}
        assert any("DETACH DELETE" in st for st, _ in n.state["statements"])
    finally:
        q.shutdown()
        n.shutdown()


def test_compat_command_fails_on_dead_target():
    import socket

    from symbiont_tpu_torch.deploy import _qdrant_compat

    with socket.socket() as s:  # grab a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    assert _qdrant_compat(f"http://127.0.0.1:{dead}", say=lambda *a: None)


def test_help_flag_exits_cleanly(capsys):
    assert main(["--help"]) == 0
    assert "Usage" in capsys.readouterr().err
    assert main(["-h"]) == 0
    assert main([]) == 2


def test_missing_compose_path_is_friendly(capsys):
    assert main(["no/such/compose.yml"]) == 2
    assert "does not exist" in capsys.readouterr().err


def test_compat_duplicate_target_kind_rejected(capsys):
    assert main(["--compat", "qdrant=http://a:6333", "qdrant=http://b:6333"]) == 2
    err = capsys.readouterr().err
    assert "given twice" in err and "qdrant" in err
