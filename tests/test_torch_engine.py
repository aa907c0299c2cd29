"""TorchEngine on the CPU against the JAX TpuEngine on the same parameters,
both with the hash tokenizer, in float32: embed over several length buckets
and more rows than one batch, the fused query search, and rerank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.config import EngineConfig as JaxEngineConfig
from symbiont_tpu.engine.engine import TpuEngine
from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
from symbiont_tpu.models import bert as jbert
from symbiont_tpu_torch.config import EngineConfig
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy

VOCAB = 1000
GEOM = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=64, dtype="float32")
ENG = dict(embedding_dim=64, length_buckets=[16, 32, 64], batch_buckets=[2, 4],
           max_batch=4, dtype="float32")
F32 = dict(atol=2e-5, rtol=1e-4)
TEXTS = [" ".join(f"w{(i * 7 + j) % 97}" for j in range(n))
         for i, n in enumerate([3, 40, 9, 1, 25, 60, 14, 2, 33, 7, 50])]


@pytest.fixture(scope="module")
def engines():
    jcfg = jbert.BertConfig(**GEOM)
    jp = jbert.init_params(jax.random.key(0), jcfg)
    jc = jbert.init_params(jax.random.key(1), jcfg, with_pooler=True)
    jax_eng = TpuEngine(JaxEngineConfig(**ENG, data_parallel=False), params=jp,
                        model_cfg=jcfg, tokenizer=JaxHashTokenizer(VOCAB),
                        cross_params=jc, cross_cfg=jcfg)
    tcfg = tbert.BertConfig(**GEOM)
    to_np = lambda t: bert_params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    port = TorchEngine(EngineConfig(**ENG), params=to_np(jp), model_cfg=tcfg,
                       tokenizer=HashTokenizer(VOCAB), cross_params=to_np(jc),
                       cross_cfg=tcfg, device="cpu")
    return jax_eng, port


def test_embed_texts_matches_jax_over_buckets(engines):
    jax_eng, port = engines
    want = jax_eng.embed_texts(TEXTS)
    got = port.embed_texts(TEXTS)
    assert got.shape == (len(TEXTS), 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)
    # several length buckets, and more rows than one batch holds
    assert port.stats["embed_batches"] >= 4
    assert port.stats["sentences_embedded"] >= len(TEXTS)
    np.testing.assert_allclose(port.embed_query(TEXTS[5]), got[5], **F32)
    assert port.embed_texts([]).shape == (0, 64)


def test_embed_and_search_matches_jax(engines):
    jax_eng, port = engines
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((16, 64)).astype(np.float32)
    corpus[3] = port.embed_query("w1 w2 w3 w4")
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    n_valid = 12
    s_j, i_j = jax_eng.embed_and_search("w1 w2 w3 w4", jnp.asarray(corpus), n_valid, 6)
    s_t, i_t = port.embed_and_search("w1 w2 w3 w4", torch.from_numpy(corpus), n_valid, 6)
    assert list(i_t) == list(np.asarray(i_j)) and i_t[0] == 3
    np.testing.assert_allclose(s_t, np.asarray(s_j), atol=1e-6)
    assert (i_t < n_valid).all()
    assert port.stats["qsearch_calls"] == 1
    # k past the valid rows: the invalid rows come last, at -inf
    s_t, i_t = port.embed_and_search("w1", torch.from_numpy(corpus), 2, 4)
    assert np.isneginf(s_t[2:]).all() and np.isfinite(s_t[:2]).all()


def test_rerank_scores_match_jax(engines):
    # scores with a tolerance, not argsort order: the synthetic
    # cross-encoder's score gaps are ~1e-5 (test_quantization.py)
    jax_eng, port = engines
    passages = TEXTS[:7]
    want = jax_eng.rerank("w3 w10 w17", passages)
    got = port.rerank("w3 w10 w17", passages)
    assert got.shape == (7,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)
    assert port.rerank("q", []).shape == (0,)
    assert port.stats["rerank_calls"] == 1


def test_warmup_runs_embed_and_rerank(engines):
    _, port = engines
    traffic = lambda s: {k: v for k, v in s.items() if k not in ("compiles", "compile_s")}  # noqa: E731
    before = dict(port.stats)
    port.warmup()
    assert traffic(port.stats) == traffic(before)  # warmup is not traffic
    # it builds the hot executables (embed and rerank at 2 x 2 shapes) once
    assert 0 <= port.stats["compiles"] - before["compiles"] <= 8
    warmed = dict(port.stats)
    port.warmup()
    assert port.stats["compiles"] == warmed["compiles"]


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(EngineConfig(**ENG))


def test_force_cpu_synthetic_engine():
    eng = TorchEngine(EngineConfig(**ENG, force_cpu=True, rerank_enabled=True,
                                   attn_impl="auto"))
    assert eng.device.type == "cpu"
    cfg = eng.model_cfg
    # synthetic depth for a width ≤ 512 without a checkpoint row: 6 layers
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads) == (64, 6, 1)
    assert cfg.attn_impl == "xla" and eng.cross_cfg.attn_impl == "xla"
    assert eng._ids_dtype == np.uint16
    assert np.isfinite(eng.rerank("a b", ["c d", "e"])).all()


def test_bf16_engine_params_and_output():
    eng = TorchEngine(EngineConfig(**{**ENG, "dtype": "bfloat16"}, attn_impl="flash",
                                   rerank_enabled=True), device="cpu")
    assert eng.model_cfg.dtype == "bfloat16" and eng.model_cfg.attn_impl == "flash"
    w = eng.params["layers"][0]["attention"]["query"]["kernel"]
    assert w.dtype == torch.bfloat16
    assert eng.cross_params["pooler"]["kernel"].dtype == torch.float32
    out = eng.embed_texts(TEXTS[:3])
    assert out.dtype == np.float32 and np.isfinite(out).all()


def test_plan_cap_and_batch_bucket():
    eng = TorchEngine(EngineConfig(**{**ENG, "max_batch": 64}), device="cpu")
    assert eng._plan_cap == 4
    assert [eng._batch_bucket(n) for n in (1, 2, 3, 4)] == [2, 2, 4, 4]


@pytest.mark.parametrize("kw,exc", [
    (dict(quantize="int8"), None),
    (dict(quantize="int4"), ValueError),
])
def test_config_rejects_unported_quantization(kw, exc):
    """Every mode of QUANTIZE_MODES constructs (int8 here); a mode outside
    it is refused."""
    if exc is None:
        assert EngineConfig(**kw).quantize == kw["quantize"]
        return
    with pytest.raises(exc):
        EngineConfig(**kw)


@pytest.mark.parametrize("kw", [dict(model_dir="/nonexistent"),
                                dict(cross_model_dir="/nonexistent")])
def test_checkpoint_dirs_not_ported(kw):
    """Checkpoint dirs load now: a missing one raises FileNotFoundError, as
    the JAX loader does."""
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        TorchEngine(EngineConfig(**ENG, **kw), device="cpu")
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        TpuEngine(JaxEngineConfig(**ENG, **kw, data_parallel=False))


def test_bad_attn_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        TorchEngine(EngineConfig(**ENG, attn_impl="fast"), device="cpu")


def test_config_defaults_match_jax():
    mine = dataclasses.asdict(EngineConfig())
    theirs = dataclasses.asdict(JaxEngineConfig())
    assert mine == theirs


# ------------------------------------------------------- checkpoint dirs

HF_CORPUS = [
    "the tensor cores multiply matrices in bfloat16",
    "high bandwidth memory feeds the streaming multiprocessors",
    "length buckets keep the set of shapes small",
    "the vector store ranks documents by cosine similarity",
    "a cross encoder scores the query and the passage together",
    "checkpoints let a restarted engine skip the conversion step",
] * 3


def _train_wordpiece(out_file) -> int:
    """A WordPiece tokenizer trained in-process (the format every
    BERT-family model of BASELINE.md ships), saved as tokenizer.json."""
    tk = pytest.importorskip("tokenizers")
    tok = tk.Tokenizer(tk.models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = tk.normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = tk.pre_tokenizers.BertPreTokenizer()
    trainer = tk.trainers.WordPieceTrainer(
        vocab_size=200, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tok.train_from_iterator(HF_CORPUS, trainer)
    tok.post_processor = tk.processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")),
                        ("[SEP]", tok.token_to_id("[SEP]"))])
    tok.save(str(out_file))
    return tok.get_vocab_size()


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """An embedder dir (model.safetensors + tokenizer.json, as a hub
    snapshot) and a cross-encoder dir (pytorch_model.bin, bert.* names)."""
    transformers = pytest.importorskip("transformers")
    emb_dir = tmp_path_factory.mktemp("embedder")
    vocab = _train_wordpiece(emb_dir / "tokenizer.json")
    torch.manual_seed(7)
    geom = dict(vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
    transformers.BertModel(transformers.BertConfig(**geom)).eval().save_pretrained(
        emb_dir, safe_serialization=True)
    cross_dir = tmp_path_factory.mktemp("cross")
    transformers.BertForSequenceClassification(
        transformers.BertConfig(**geom, num_labels=1)).eval().save_pretrained(
            cross_dir, safe_serialization=False)
    return emb_dir, cross_dir


@pytest.mark.parametrize("attn_impl,tol", [("xla", F32), ("flash", dict(atol=2e-4, rtol=2e-4))])
def test_model_dir_engine_matches_tpu_engine(hf_dirs, attn_impl, tol):
    """TorchEngine(model_dir, cross_model_dir) against TpuEngine on the same
    dirs, both with the tokenizer.json of model_dir: float32, JAX's flash in
    interpret mode as its own tests run it."""
    from symbiont_tpu.engine.tokenizer import HFTokenizer as JaxHFTokenizer
    from symbiont_tpu_torch.engine.tokenizer import HFTokenizer

    emb_dir, cross_dir = hf_dirs
    kw = dict(ENG, model_dir=str(emb_dir), cross_model_dir=str(cross_dir), attn_impl=attn_impl)
    jax_eng = TpuEngine(JaxEngineConfig(**kw, data_parallel=False))
    port = TorchEngine(EngineConfig(**kw), device="cpu")
    assert isinstance(port.tokenizer, HFTokenizer)
    assert isinstance(jax_eng.tokenizer, JaxHFTokenizer)
    assert port.model_cfg.attn_impl == attn_impl and port.model_cfg.hidden_size == 32
    assert port.cross_params["classifier"]["kernel"].shape == (32, 1)
    texts = HF_CORPUS[:6] + ["an unseen sentence with words the vocab splits"] * 2
    np.testing.assert_allclose(port.embed_texts(texts), jax_eng.embed_texts(texts), **tol)
    query = "which part feeds the multiprocessors?"
    np.testing.assert_allclose(port.rerank(query, HF_CORPUS[:6]),
                               jax_eng.rerank(query, HF_CORPUS[:6]), **tol)


def test_f16_at_float32_keeps_bf16_matrices_as_tpu_engine():
    """quantize="f16" under float32 compute holds bf16 matrices and float32
    vectors, the bytes the JAX engine holds, and embeds within the f32 bars:
    the load-time cast never widens a leaf."""
    from symbiont_tpu.models import quant as jquant

    jcfg = jbert.BertConfig(**GEOM)
    jp = jbert.init_params(jax.random.key(0), jcfg)
    kw = dict(ENG, quantize="f16")
    jax_eng = TpuEngine(JaxEngineConfig(**kw, data_parallel=False), params=jp,
                        model_cfg=jcfg, tokenizer=JaxHashTokenizer(VOCAB))
    port = TorchEngine(EngineConfig(**kw),
                       params=bert_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                       model_cfg=tbert.BertConfig(**GEOM), tokenizer=HashTokenizer(VOCAB),
                       device="cpu")
    assert port.param_bytes() == jquant.param_bytes(jax_eng.params)
    layer = port.params["layers"][0]
    assert layer["attention"]["query"]["kernel"].dtype == torch.bfloat16
    assert layer["attention"]["query"]["bias"].dtype == torch.float32
    np.testing.assert_allclose(port.embed_texts(TEXTS), jax_eng.embed_texts(TEXTS), **F32)
    # the synthetic 64-wide engine (30,000 × 64 word table, 6 layers)
    probe = dict(embedding_dim=64, dtype="float32", quantize="f16")
    want = jquant.param_bytes(TpuEngine(JaxEngineConfig(**probe, data_parallel=False)).params)
    assert TorchEngine(EngineConfig(**probe), device="cpu").param_bytes() == want == 4_516_096
