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
    to_np = lambda t: bert_params_from_numpy(jax.tree.map(np.asarray, t))
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
    before = dict(port.stats)
    port.warmup()
    assert port.stats == before  # warmup is not traffic


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
    (dict(quantize="int8"), NotImplementedError),
    (dict(quantize="int4"), ValueError),
])
def test_config_rejects_unported_quantization(kw, exc):
    with pytest.raises(exc):
        EngineConfig(**kw)


@pytest.mark.parametrize("kw", [dict(model_dir="/nonexistent"),
                                dict(cross_model_dir="/nonexistent")])
def test_checkpoint_dirs_not_ported(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchEngine(EngineConfig(**ENG, **kw), device="cpu")


def test_bad_attn_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        TorchEngine(EngineConfig(**ENG, attn_impl="fast"), device="cpu")


def test_config_defaults_match_jax():
    mine = dataclasses.asdict(EngineConfig())
    theirs = dataclasses.asdict(JaxEngineConfig())
    assert mine == theirs
