"""The port's BERT encoder and cross-encoder against the JAX package's, on
one JAX parameter tree passed through the bridge and the same token ids.
Small geometry (2 layers, hidden 64, 4 heads, S ≤ 64) keeps the JAX flash
kernel's interpret mode fast."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import bert as jbert
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy

GEOM = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=64)
LENGTHS = [64, 10, 33, 0]  # the last row is batch padding: length 0


def _cfgs(**kw):
    return jbert.BertConfig(**GEOM, **kw), tbert.BertConfig(**GEOM, **kw)


@pytest.fixture(scope="module")
def trees():
    jcfg, _ = _cfgs()
    jparams = jbert.init_params(jax.random.key(0), jcfg, with_pooler=True)
    return jparams, bert_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _batch(seed=0, S=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GEOM["vocab_size"], (len(LENGTHS), S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    types = ((np.arange(S)[None, :] >= 5) & (mask == 1)).astype(np.int32)
    return ids, mask, types


def _embed_both(trees, **cfg_kw):
    jparams, tparams = trees
    jcfg, tcfg = _cfgs(**cfg_kw)
    ids, mask, _ = _batch()
    want = np.asarray(jbert.embed_sentences(jparams, jnp.asarray(ids),
                                            jnp.asarray(mask), jcfg))
    got = tbert.embed_sentences(tparams, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask), tcfg).numpy()
    return got, want


def test_bridge_keeps_tree_layout_and_dtype(trees):
    jparams, tparams = trees
    assert tparams["layers"][1]["attention"]["query"]["kernel"].shape == (64, 64)
    assert tparams["layers"][0]["mlp"]["in"]["kernel"].shape == (64, 128)  # [in, out]
    assert len(tparams["layers"]) == 2
    leaves = jax.tree.leaves(jparams)
    flat = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for x in t:
                walk(x)
        else:
            flat.append(t)

    walk(tparams)
    assert len(flat) == len(leaves)
    assert all(t.dtype == torch.float32 for t in flat)


def test_bridge_bf16_leaves():
    tree = {"w": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16)), "l": [np.ones(2)]}
    out = bert_params_from_numpy(tree, "cpu")
    assert out["w"].dtype == torch.bfloat16
    assert out["w"].tolist() == [1.5, -2.25]
    assert isinstance(out["l"], list)


def test_f32_xla_matches_jax(trees):
    got, want = _embed_both(trees, dtype="float32")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_f32_flash_matches_jax_flash_and_xla(trees):
    got, want = _embed_both(trees, dtype="float32", attn_impl="flash")
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    xla, _ = _embed_both(trees, dtype="float32")
    np.testing.assert_allclose(got, xla, atol=2e-4, rtol=2e-4)


def test_position_offset_matches_jax(trees):
    got, want = _embed_both(trees, dtype="float32", position_offset=2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_bf16_cosine_matches_jax(trees, attn_impl):
    got, want = _embed_both(trees, dtype="bfloat16", attn_impl=attn_impl)
    assert got.dtype == np.float32
    # the length-0 row pools to zeros on both sides (no cosine defined)
    real = np.asarray(LENGTHS) > 0
    assert np.abs(got[~real]).max() == 0 and np.abs(want[~real]).max() == 0
    assert _cos(got[real], want[real]).min() >= 0.999


def test_cross_encoder_score_matches_jax(trees):
    jparams, tparams = trees
    jcfg, tcfg = _cfgs(dtype="float32")
    ids, mask, types = _batch(1)
    want = np.asarray(jbert.cross_encoder_score(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg, jnp.asarray(types)))
    got = tbert.cross_encoder_score(
        tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg,
        torch.from_numpy(types).long())
    assert got.dtype == torch.float32 and got.shape == (len(LENGTHS),)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_one_row_token_type_table_clamps_as_jax():
    """An XLM-R-layout cross-encoder (type_vocab_size 1, positions offset
    past pad id 1) scoring pairs whose segment-B ids are 1, and a word id
    past the vocab: JAX's gathers clamp both to the table, and so do the
    port's. Float32 at the bar of tests/test_bert_numerics.py."""
    geom = dict(GEOM, type_vocab_size=1, position_offset=2, layer_norm_eps=1e-5)
    jcfg = jbert.BertConfig(**geom, dtype="float32")
    tcfg = tbert.BertConfig(**geom, dtype="float32")
    jparams = jbert.init_params(jax.random.key(3), jcfg, with_pooler=True)
    tparams = bert_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert tparams["embeddings"]["token_type_embeddings"].shape == (1, 64)
    ids, mask, types = _batch(2, S=48)
    ids = np.where(mask == 1, ids, 1)  # XLM-R's pad id
    ids[0, 3] = GEOM["vocab_size"] + 5
    assert types.max() == 1
    want = np.asarray(jbert.cross_encoder_score(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg, jnp.asarray(types)))
    got = tbert.cross_encoder_score(
        tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg,
        torch.from_numpy(types).long())
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


def test_normalize_and_cls_pool_match_jax(trees):
    jparams, tparams = trees
    jcfg, tcfg = _cfgs(dtype="float32")
    ids, mask, _ = _batch(2)
    want = np.asarray(jbert.embed_sentences(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                            jcfg, pooling="cls", normalize=True))
    got = tbert.embed_sentences(tparams, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask), tcfg, pooling="cls",
                                normalize=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["gelu", "relu", "silu"])
def test_activations_match_jax(name):
    x = np.random.default_rng(3).standard_normal((4, 32)).astype(np.float32)
    want = np.asarray(jbert._act(name, jnp.float32)(jnp.asarray(x)))
    got = tbert._act(name, torch.float32)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        tbert._act("swish-ish")


def test_bf16_gelu_is_tanh_approximation():
    x = torch.linspace(-3, 3, 64)
    got = tbert._act("gelu", torch.bfloat16)(x.bfloat16()).float()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy(), jnp.bfloat16), approximate=True),
                      np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


def test_from_hf_matches_jax():
    hf = {"model_type": "xlm-roberta", "vocab_size": 250002, "hidden_size": 768,
          "num_hidden_layers": 12, "num_attention_heads": 12, "pad_token_id": 1,
          "intermediate_size": 3072, "max_position_embeddings": 514,
          "type_vocab_size": 1, "layer_norm_eps": 1e-5}
    assert (dataclasses.asdict(tbert.BertConfig.from_hf(hf))
            == dataclasses.asdict(jbert.BertConfig.from_hf(hf)))
    assert tbert.BertConfig.from_hf(hf).position_offset == 2


def test_init_params_is_seeded_and_shaped():
    _, tcfg = _cfgs()
    a = tbert.init_params(torch.Generator().manual_seed(0), tcfg, with_pooler=True)
    b = tbert.init_params(torch.Generator().manual_seed(0), tcfg, with_pooler=True)
    w = a["layers"][0]["attention"]["query"]["kernel"]
    assert torch.equal(w, b["layers"][0]["attention"]["query"]["kernel"])
    assert w.shape == (64, 64) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 0.04 + 1e-7  # trunc-normal at ±2σ, σ = 0.02
    assert a["classifier"]["kernel"].shape == (64, 1)
