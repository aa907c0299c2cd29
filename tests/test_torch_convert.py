"""The port's checkpoint converter (models/convert.py) against the JAX
package's and against `transformers`: the same trees from BERT, XLM-R and
cross-encoder checkpoints (safetensors, sharded safetensors, and
pytorch_model.bin), a safetensors reader and writer that agree with the
`safetensors` package both ways, the CLI's `--out` checkpoint read back by
the JAX package, and exported model dirs that `transformers` runs to the
port's forward. Tiny geometries on the CPU; the trees must be equal
exactly, the forwards within float32's bar of tests/test_bert_numerics.py
(atol 3e-5, rtol 1e-4)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

from symbiont_tpu.models import convert as jconvert  # noqa: E402
from symbiont_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from symbiont_tpu_torch.models import bert as tbert  # noqa: E402
from symbiont_tpu_torch.models import convert  # noqa: E402
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy  # noqa: E402

F32 = dict(atol=3e-5, rtol=1e-4)
TINY = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64)


def _hf_model(arch: str):
    torch.manual_seed({"bert": 0, "xlmr": 1, "cross": 2}[arch])
    if arch == "xlmr":  # the multilingual mpnet's layout: one token type, pad id 1
        cfg = transformers.XLMRobertaConfig(**TINY, max_position_embeddings=66,
                                            type_vocab_size=1, pad_token_id=1)
        return transformers.XLMRobertaModel(cfg).eval()
    cfg = transformers.BertConfig(**TINY, max_position_embeddings=64, num_labels=1)
    if arch == "cross":  # ms-marco-style: bert.* names, pooler and classifier
        return transformers.BertForSequenceClassification(cfg).eval()
    return transformers.BertModel(cfg).eval()


def _save(model, d, fmt: str):
    if fmt == "safetensors":
        model.save_pretrained(d, safe_serialization=True)
        assert (d / "model.safetensors").exists()
    elif fmt == "sharded":
        model.save_pretrained(d, safe_serialization=True, max_shard_size="20KB")
        assert (d / "model.safetensors.index.json").exists()
        assert not (d / "model.safetensors").exists()
    else:
        model.save_pretrained(d, safe_serialization=False)
        assert (d / "pytorch_model.bin").exists()
    return d


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{(arch, fmt): model dir} for every architecture and file format."""
    out = {}
    for arch in ("bert", "xlmr", "cross"):
        model = _hf_model(arch)
        for fmt in ("safetensors", "sharded", "bin"):
            out[arch, fmt] = _save(model, tmp_path_factory.mktemp(f"{arch}_{fmt}"), fmt)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["safetensors", "sharded", "bin"])
@pytest.mark.parametrize("arch", ["bert", "xlmr", "cross"])
def test_load_bert_model_equals_jax_converter(hf_dirs, arch, fmt):
    d = hf_dirs[arch, fmt]
    pooler = arch == "cross"
    got, cfg = convert.load_bert_model(d, with_pooler=pooler)
    want, jcfg = jconvert.load_bert_model(d, with_pooler=pooler)
    _assert_trees_equal(got, want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if arch == "xlmr":
        assert cfg.position_offset == 2 and cfg.type_vocab_size == 1
    if pooler:
        assert got["classifier"]["kernel"].shape == (32, 1)


def test_convert_bert_takes_torch_tensors_and_bf16(hf_dirs):
    """A state dict of tensors, some bfloat16 (numpy has no bf16): upcast to
    float32 exactly, as the JAX converter's astype does for float16."""
    model = _hf_model("bert")
    sd = {k: (v.bfloat16() if k.endswith("query.weight") else v)
          for k, v in model.state_dict().items()}
    cfg = tbert.BertConfig.from_hf(model.config.to_dict())
    got = convert.convert_bert(sd, cfg)
    np.testing.assert_array_equal(got["layers"][0]["attention"]["query"]["kernel"],
                                  sd["encoder.layer.0.attention.self.query.weight"].float().numpy().T)
    want = jconvert.convert_bert({k: v.float() for k, v in sd.items()}, cfg)
    _assert_trees_equal(got, want)


def test_missing_tensor_and_missing_weights_raise(tmp_path, hf_dirs):
    cfg = tbert.BertConfig.from_hf(_hf_model("bert").config.to_dict())
    with pytest.raises(KeyError, match="word_embeddings"):
        convert.convert_bert({}, cfg)
    (tmp_path / "config.json").write_text(json.dumps(_hf_model("bert").config.to_dict()))
    with pytest.raises(FileNotFoundError):
        convert.load_bert_model(tmp_path)


# ------------------------------------------------------------ safetensors


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "f64": rng.standard_normal((2, 2, 2)),
        "i64": rng.integers(-9, 9, (7,)).astype(np.int64),
        "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "i16": rng.integers(-9, 9, (5,)).astype(np.int16),
        "i8": rng.integers(-9, 9, (3, 1)).astype(np.int8),
        "u8": rng.integers(0, 255, (6,)).astype(np.uint8),
        "bool": rng.integers(0, 2, (4,)).astype(np.bool_),
        "scalar": np.array(1.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "transposed": rng.standard_normal((3, 4)).astype(np.float32).T,  # not C-ordered
    }


def test_safetensors_writer_read_by_safetensors_package(tmp_path):
    arrays = _arrays()
    convert.write_safetensors(tmp_path / "a.safetensors", arrays)
    back = safetensors_numpy.load_file(str(tmp_path / "a.safetensors"))
    assert sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a)
    from safetensors import safe_open

    with safe_open(str(tmp_path / "a.safetensors"), "np") as f:
        assert f.metadata() == {"format": "pt"}  # transformers needs it


def test_safetensors_reader_reads_safetensors_package(tmp_path):
    arrays = {k: np.asarray(a, order="C") for k, a in _arrays().items()}
    safetensors_numpy.save_file(arrays, str(tmp_path / "b.safetensors"))
    back = convert.read_safetensors(tmp_path / "b.safetensors")
    assert sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a)
    # bfloat16 reads back as float32, exactly
    t = torch.randn(5, 3).bfloat16()
    safetensors_torch.save_file({"w": t}, str(tmp_path / "c.safetensors"))
    w = convert.read_safetensors(tmp_path / "c.safetensors")["w"]
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, t.float().numpy())


def test_safetensors_writer_refuses_unnamed_dtypes(tmp_path):
    with pytest.raises(ValueError, match="complex"):
        convert.write_safetensors(tmp_path / "x.safetensors", {"c": np.zeros(2, np.complex64)})


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("arch", ["bert", "cross"])
def test_cli_out_is_read_by_the_jax_package(hf_dirs, tmp_path, capsys, arch):
    d = hf_dirs[arch, "safetensors"]
    out = tmp_path / "ckpt"
    argv = [str(d), "--out", str(out)] + (["--pooler"] if arch == "cross" else [])
    convert.main(argv)
    printed = capsys.readouterr().out
    assert "params converted OK" in printed and "saved checkpoint" in printed
    params, meta = jcheckpoint.load_params(out)
    want, jcfg = jconvert.load_bert_model(d, with_pooler=arch == "cross")
    _assert_trees_equal(params, want)
    assert meta["kind"] == "bert" and meta["config"] == dataclasses.asdict(jcfg)


def test_cli_without_out_only_checks(hf_dirs, tmp_path, capsys):
    convert.main([str(hf_dirs["xlmr", "bin"])])
    out = capsys.readouterr().out
    assert "bert: BertConfig hidden=32 layers=2 heads=4" in out
    assert "saved" not in out


@pytest.mark.parametrize("argv_extra,model_type", [([], "gpt2"), ([], "llama"),
                                                   (["--kind", "gpt"], "bert")])
def test_gpt_checkpoints_are_not_ported(tmp_path, argv_extra, model_type):
    """GPT checkpoints were refused until the port had its GPT model; they
    convert now (tests/test_torch_gpt.py), so a config.json with no weights
    beside it fails in the port exactly as it fails in the JAX converter:
    the GPT kind on a GPT or BERT config, the BERT loader on a GPT one."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type,
                                                      "vocab_size": 10, "hidden_size": 8}))
    calls = [(convert.main, jconvert.main, [str(tmp_path)] + argv_extra)]
    if model_type != "bert":
        calls.append((convert.load_bert_model, jconvert.load_bert_model, tmp_path))
    for mine, theirs, arg in calls:
        with pytest.raises(Exception) as got:
            mine(arg)
        with pytest.raises(Exception) as want:
            theirs(arg)
        assert not isinstance(got.value, NotImplementedError)
        assert type(got.value) is type(want.value), (got.value, want.value)


# ----------------------------------------------------------------- export


def _forward(params, cfg, ids, mask):
    return tbert.bert_encode(bert_params_from_numpy(params, "cpu"), torch.from_numpy(ids).long(),
                             torch.from_numpy(mask), dataclasses.replace(cfg, dtype="float32"))


@pytest.mark.parametrize("arch", ["bert", "xlmr"])
def test_export_hf_bert_reloads_in_transformers(hf_dirs, tmp_path, arch):
    params, cfg = convert.load_bert_model(hf_dirs[arch, "safetensors"])
    out = convert.export_hf_bert(params, cfg, tmp_path / "exported")
    # the same files the JAX package's exporter writes
    jout = jconvert.export_hf_bert(params, cfg, tmp_path / "jax_exported")
    assert (json.loads((out / "config.json").read_text())
            == json.loads((jout / "config.json").read_text()))
    mine = safetensors_numpy.load_file(str(out / "model.safetensors"))
    theirs = safetensors_numpy.load_file(str(jout / "model.safetensors"))
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)

    model = transformers.AutoModel.from_pretrained(out).eval()
    rng = np.random.default_rng(3)
    lengths = np.array([12, 5, 1])
    mask = (np.arange(12)[None] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(3, TINY["vocab_size"], (3, 12)).astype(np.int32)
    if arch == "xlmr":
        ids = np.where(mask == 1, ids, 1)  # RoBERTa positions skip the pad id
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    got = _forward(params, cfg, ids, mask)
    m = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[m], ref.numpy()[m], **F32)
    back, back_cfg = convert.load_bert_model(out)
    _assert_trees_equal(back, params)
    assert back_cfg == cfg


def test_export_cross_encoder_roundtrip_with_bert_prefix(hf_dirs, tmp_path):
    """A cross-encoder written as pytorch_model.bin under bert.* names (the
    ms-marco layout): `hf_state_dict(prefix="bert.")` leaves the classifier
    outside the prefix, and the tree reads back equal."""
    params, cfg = convert.load_bert_model(hf_dirs["cross", "bin"], with_pooler=True)
    sd = convert.hf_state_dict(params, prefix="bert.")
    assert "classifier.weight" in sd and "bert.pooler.dense.weight" in sd
    assert sd["classifier.weight"].shape == (1, 32)
    d = tmp_path / "cross"
    d.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps(convert.hf_config(cfg)))
    back, _ = convert.load_bert_model(d, with_pooler=True)
    _assert_trees_equal(back, params)
    model = transformers.BertForSequenceClassification.from_pretrained(
        hf_dirs["cross", "safetensors"]).eval()
    want = {k: v.numpy() for k, v in model.state_dict().items()
            if not k.endswith("position_ids")}
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
