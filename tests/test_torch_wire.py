"""The two packages speak the same wire: the embeddings frame and its JSON
fallback, every wire struct's JSON bytes, the subject table, the
configuration (`load_config` field for field, defaults, a file and the
`SYMBIONT_*` and reference-era env names) and the HTML extraction that
feeds the pipeline. Each message is built with the same values in both
packages from a numpy seed."""

import dataclasses
import inspect
import json

import numpy as np
import pytest

from symbiont_tpu import config as jconfig
from symbiont_tpu import subjects as jsubjects
from symbiont_tpu.schema import frames as jframes
import symbiont_tpu.schema as jschema
from symbiont_tpu.services import html_extract as jhtml
from symbiont_tpu_torch import config as tconfig
from symbiont_tpu_torch import subjects as tsubjects
from symbiont_tpu_torch.schema import frames as tframes
import symbiont_tpu_torch.schema as tschema
from symbiont_tpu_torch.services import html_extract as thtml

RNG = np.random.default_rng(7)
ROWS = RNG.standard_normal((5, 24)).astype(np.float32)
SENTENCES = ["Alpha one.", "Beta — two?", "Gamma drei!", "δέλτα", ""]

# fields the port has and the JAX package does not, by section
PORT_ONLY_FIELDS = {"lm": {"force_cpu"}}


@pytest.mark.parametrize("dtype", ["f32", "f16"])
def test_frames_are_byte_equal_and_cross_decode(dtype):
    a, b = jframes.encode_frame(ROWS, dtype), tframes.encode_frame(ROWS, dtype)
    assert a == b
    np.testing.assert_array_equal(tframes.decode_frame(a), jframes.decode_frame(b))


@pytest.mark.parametrize("use_frame,wire_dtype", [(True, "f32"), (True, "f16"), (False, None)])
def test_embeddings_messages_are_byte_equal_and_cross_decode(use_frame, wire_dtype):
    args = ("doc-1", "http://example.com/a", SENTENCES, ROWS, "model-x", 1_700_000_000_123)
    jb, jh = jframes.encode_embeddings_message(*args, use_frame=use_frame,
                                               wire_dtype=wire_dtype)
    tb, th = tframes.encode_embeddings_message(*args, use_frame=use_frame,
                                               wire_dtype=wire_dtype)
    assert (jb, jh) == (tb, th)
    for dec, data, hdr in ((tframes, jb, jh), (jframes, tb, th)):
        lazy = dec.decode_embeddings_lazy(data, hdr)
        assert lazy.sentences == SENTENCES and lazy.original_id == "doc-1"
        tol = 1e-3 if wire_dtype == "f16" else 0
        np.testing.assert_allclose(lazy.rows, ROWS, atol=tol, rtol=tol)
        msg, rows = dec.decode_embeddings_message(data, hdr)
        assert [e.sentence_text for e in msg.embeddings_data] == SENTENCES
        assert (rows is None) == (not use_frame)


def _sample(cls, mod):
    """One instance of wire struct `cls` of package `mod`, its fields filled
    from their types."""
    hints = cls.__wire_hints__
    out = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        tp = str(hints[f.name])
        if "SentenceEmbedding" in tp:
            out[f.name] = [mod.SentenceEmbedding(sentence_text="s é", embedding=[0.5, -1.25])]
        elif "SemanticSearchResultItem" in tp:
            out[f.name] = [mod.SemanticSearchResultItem(
                qdrant_point_id="p", score=0.75, payload=_sample(mod.QdrantPointPayload, mod))]
        elif "QdrantPointPayload" in tp:
            out[f.name] = _sample(mod.QdrantPointPayload, mod)
        elif "List[float]" in tp:
            out[f.name] = [0.1, 2.0, -3.5]
        elif "List[str]" in tp:
            out[f.name] = ["a", "ü"]
        elif "bool" in tp:
            out[f.name] = bool(i % 2)
        elif "float" in tp:
            out[f.name] = 0.25 * (i + 1)
        elif "int" in tp:
            out[f.name] = 10 ** 12 + i
        else:
            out[f.name] = f"{f.name}-ü-{i}"
    return cls(**out)


@pytest.mark.parametrize("name", [t.__name__ for t in jschema.WIRE_TYPES])
def test_wire_structs_give_equal_json_bytes(name):
    j = _sample(getattr(jschema, name), jschema)
    t = _sample(getattr(tschema, name), tschema)
    assert jschema.to_json_bytes(j) == tschema.to_json_bytes(t)
    # each decodes the other's bytes to an equal struct
    assert tschema.to_json_bytes(tschema.from_json(getattr(tschema, name),
                                                   jschema.to_json_bytes(j))) == \
        jschema.to_json_bytes(j)


def test_subjects_are_the_same_table():
    names = {n for n, v in vars(jsubjects).items() if n.isupper() and not n.startswith("_")}
    assert names == {n for n, v in vars(tsubjects).items()
                     if n.isupper() and not n.startswith("_")}
    for n in names:
        assert getattr(jsubjects, n) == getattr(tsubjects, n), n


def _sections(cfg):
    return {f.name: dataclasses.asdict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def _assert_same_config(jcfg, tcfg):
    js, ts = _sections(jcfg), _sections(tcfg)
    assert set(js) == set(ts)
    for sec in js:
        extra = PORT_ONLY_FIELDS.get(sec, set())
        assert set(ts[sec]) - set(js[sec]) == extra, sec
        assert set(js[sec]) <= set(ts[sec]), sec
        for k, v in js[sec].items():
            assert ts[sec][k] == v, (sec, k)


ENV = {
    "SYMBIONT_API_PORT": "9191",
    "SYMBIONT_ENGINE_MAX_BATCH": "64",
    "SYMBIONT_ENGINE_LENGTH_BUCKETS": "[16, 48]",
    "SYMBIONT_ENGINE_FORCE_CPU": "1",
    "SYMBIONT_LM_ENABLED": "true",
    "SYMBIONT_LM_TEMPERATURE": "0.5",
    "SYMBIONT_LM_NEW_TOKEN_BUCKETS": "[16, 64]",
    "SYMBIONT_VECTOR_STORE_COALESCE_MAX_ROWS": "128",
    "SYMBIONT_BUS_DURABLE": "1",
    "SYMBIONT_BUS_DURABLE_MAX_DELIVER": "3",
    "SYMBIONT_OBS_TRACE_CAPACITY": "77",
    "SYMBIONT_OBS_SLO_P99_MS": '["api.search=500"]',
    "SYMBIONT_ADMISSION_ENABLED": "1",
    "SYMBIONT_ADMISSION_FAIR_WEIGHTS": "a=2,b=1",
    "SYMBIONT_AUTOSCALE_ROLES": "embed=1:4",
    "SYMBIONT_RUNNER_SERVICES": "api,engine",
    "NATS_URL": "symbus://10.0.0.1:4233",
    "API_SERVER_HOST": "0.0.0.0",
    "FORCE_CPU": "0",
}


@pytest.mark.parametrize("env", [{}, ENV], ids=["defaults", "overrides"])
def test_load_config_agrees_field_for_field(env):
    _assert_same_config(jconfig.load_config(env=env), tconfig.load_config(env=env))


def test_load_config_agrees_on_a_file(tmp_path):
    path = tmp_path / "symbiont.json"
    path.write_text(json.dumps({"engine": {"dtype": "float32", "batch_buckets": [4, 8]},
                                "api": {"fused_search_max_top_k": 8},
                                "gen_journal": {"enabled": True}}))
    env = {"SYMBIONT_API_HOST": "::1"}
    _assert_same_config(jconfig.load_config(path, env=env), tconfig.load_config(path, env=env))


@pytest.mark.parametrize("env", [{"SYMBIONT_OBS_SLO_P99_MS": '["api.search"]'},
                                 {"SYMBIONT_AUTOSCALE_ROLES": "embed=4:1"},
                                 {"SYMBIONT_ADMISSION_FAIR_WEIGHTS": "a=x"},
                                 {"SYMBIONT_API_FUSED_SEARCH_MAX_TOP_K": "64"}])
def test_load_config_refuses_what_jax_refuses(env):
    with pytest.raises(ValueError) as jerr:
        jconfig.load_config(env=env)
    with pytest.raises(ValueError) as terr:
        tconfig.load_config(env=env)
    assert str(terr.value) == str(jerr.value)


def test_the_sections_are_the_same_dataclasses():
    for name, cls in inspect.getmembers(jconfig, inspect.isclass):
        if dataclasses.is_dataclass(cls) and cls.__module__ == jconfig.__name__:
            assert dataclasses.is_dataclass(getattr(tconfig, name)), name


PAGES = [
    "<html><body><article><h1>Title</h1><p>One. Two?</p><ul><li>item</li></ul>"
    "</article><footer>skip</footer></body></html>",
    "<html><body><main><p>Main text &amp; more.</p><script>x()</script></main></body></html>",
    "<html><body><div><p>No article here!</p><p>  spaced   words </p></div></body></html>",
    "<html><head><title>t</title></head><body>bare body text</body></html>",
]


@pytest.mark.parametrize("i", range(len(PAGES)))
def test_html_extract_gives_the_same_text(i):
    assert thtml.extract_main_text(PAGES[i]) == jhtml.extract_main_text(PAGES[i])
