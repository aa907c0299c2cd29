"""The port's weight quantization (models/quant.py) against the JAX
package's: codes and scales bit-equal for int8 and fp8, the fused-dequant
ops at float32, the quantized encoder and engines at the JAX package's
bars, and the `engine.param_bytes` gauge. Tiny geometries on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.config import EngineConfig as JaxEngineConfig
from symbiont_tpu.engine.engine import TpuEngine
from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
from symbiont_tpu.models import bert as jbert
from symbiont_tpu.models import quant as jquant
from symbiont_tpu_torch.config import EngineConfig
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.utils.telemetry import metrics

F32 = dict(atol=2e-5, rtol=1e-4)  # tests/test_bert_numerics.py's float32 bar
BARS = {"f16": 0.999, "int8": 0.999, "fp8": 0.998}  # tests/test_quantization.py
QDTYPES = {"int8": (127.0, jnp.int8, torch.int8),
           "fp8": (448.0, jnp.float8_e4m3fn, torch.float8_e4m3fn)}
VOCAB = 500
GEOM = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64)
ENG = dict(embedding_dim=64, length_buckets=[16, 32], batch_buckets=[4, 8])
CORPUS = [
    "The tensor cores do matmuls all day.",
    "HBM bandwidth is the wall, not flops.",
    "Quantization moves half the bytes.",
    "A sentence.",
    "Length buckets keep the shapes static so the same shapes come back "
    "during steady-state serving.",
    "Per-channel scales keep the dequant exact along the output features.",
    "gpu",
    "Decode is weight-read bound at small batch.",
]


def _bits(a) -> np.ndarray:
    """The raw bytes of a JAX/numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.fixture(scope="module")
def jparams():
    cfg = jbert.BertConfig(**GEOM)
    return (jbert.init_params(jax.random.key(0), cfg),
            jbert.init_params(jax.random.key(1), cfg, with_pooler=True))


@pytest.mark.parametrize("shape", [(257, 64), (64, 3), (1, 64), (3, 5, 7)])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_codes_and_scales_bit_equal_jax(mode, shape):
    amax, jdt, tdt = QDTYPES[mode]
    w = (np.random.default_rng(len(shape)).standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    want = jquant.channel_quantize(w, amax, jdt)
    got = quant.channel_quantize(torch.from_numpy(w), amax, tdt)
    assert got.q.dtype == tdt and got.scale.dtype == torch.float32
    assert got.scale.shape == (shape[-1],)
    np.testing.assert_array_equal(_bits(got.q), _bits(want.q))
    np.testing.assert_array_equal(_bits(got.scale), _bits(want.scale))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_scales_are_divided_not_multiplied_by_a_reciprocal(mode):
    # CUDA torch computes `t / 127.0` as t * float32(1/127); the JAX scales
    # are IEEE quotients. Channels whose amax tells the two apart:
    amax, jdt, tdt = QDTYPES[mode]
    cand = np.random.default_rng(7).uniform(0.01, 0.2, 4096).astype(np.float32)
    apart = cand[cand / np.float32(amax) != cand * (np.float32(1.0) / np.float32(amax))][:64]
    assert apart.size == 64
    w = np.diag(apart).astype(np.float32)  # channel j's amax is apart[j]
    got = quant.channel_quantize(torch.from_numpy(w), amax, tdt)
    np.testing.assert_array_equal(_bits(got.scale), _bits(apart / np.float32(amax)))
    np.testing.assert_array_equal(_bits(got.scale),
                                  _bits(jquant.channel_quantize(w, amax, jdt).scale))
    q, scale = quant.kv_channel_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(scale), _bits(apart / np.float32(127.0)))


@pytest.mark.parametrize("mode", ["none", "f16", "int8", "fp8"])
def test_quantize_params_matches_jax_leaf_for_leaf(jparams, mode):
    jp, _ = jparams
    want = jquant.quantize_params(jp, mode)
    got = quant.quantize_params(bert_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                                mode)
    w_leaves = jax.tree.leaves(want, is_leaf=jquant.is_quantized)
    g_leaves = list(quant.leaves(got))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        if jquant.is_quantized(w):
            assert quant.is_quantized(g) and g.ndim >= 2
            np.testing.assert_array_equal(_bits(g.q), _bits(w.q))
            np.testing.assert_array_equal(_bits(g.scale), _bits(w.scale))
        else:
            assert not quant.is_quantized(g)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert quant.param_bytes(got) == jquant.param_bytes(want)
    again = quant.quantize_params(got, mode)  # a quantized leaf is kept as it is
    assert all(a is b for a, b in zip(quant.leaves(again), quant.leaves(got))
               if quant.is_quantized(b))
    with pytest.raises(ValueError):
        quant.quantize_params(got, "int4")


def test_bridge_moves_jax_quant_tensors(jparams):
    jp, _ = jparams
    for mode in ("int8", "fp8"):
        jq = jax.tree.map(np.asarray, jquant.quantize_params(jp, mode))
        t = bert_params_from_numpy(jq, "cpu")
        w = jq["layers"][1]["mlp"]["in"]["kernel"]
        g = t["layers"][1]["mlp"]["in"]["kernel"]
        assert quant.is_quantized(g) and g.shape == (64, 256)
        np.testing.assert_array_equal(_bits(g.q), _bits(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), w.scale)


def test_mm_mm_tied_take_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 32)) * 0.1).astype(np.float32)
    table = (rng.standard_normal((20, 48)) * 0.1).astype(np.float32)
    ids = np.array([[0, 19, 7], [3, 3, 11]], np.int32)
    for mode, (amax, jdt, tdt) in QDTYPES.items():
        jw, tw = jquant.channel_quantize(w, amax, jdt), quant.channel_quantize(
            torch.from_numpy(w), amax, tdt)
        jt, tt = jquant.channel_quantize(table, amax, jdt), quant.channel_quantize(
            torch.from_numpy(table), amax, tdt)
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(quant.mm(xt, tw).numpy(),
                                   np.asarray(jquant.mm(jnp.asarray(x), jw)), **F32)
        np.testing.assert_allclose(quant.mm_tied(xt, tt).numpy(),
                                   np.asarray(jquant.mm_tied(jnp.asarray(x), jt)), **F32)
        got = quant.take(tt, torch.from_numpy(ids).long())
        assert got.dtype == torch.float32  # a quantized table's gather is float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.take(jt, jnp.asarray(ids))))
        np.testing.assert_allclose(tw.dequantize().numpy(), np.asarray(jw.dequantize()), **F32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(quant.mm(xt, wt).numpy(), x @ w, **F32)
    # jnp promotes mixed operands; so does the port's mm (bf16 @ f32 → f32)
    assert quant.mm(xt.bfloat16(), wt).dtype == torch.float32


def test_take_clamps_indices_as_jax_gathers():
    table = torch.arange(12.0).reshape(3, 4)
    ids = torch.tensor([[0, 2, 3, 9]])
    want = np.asarray(jquant.take(jnp.asarray(table.numpy()), jnp.asarray(ids.numpy())))
    np.testing.assert_array_equal(quant.take(table, ids).numpy(), want)
    qt = quant.channel_quantize(table, 127.0, torch.int8)
    assert torch.equal(quant.take(qt, ids)[0, 3], quant.take(qt, ids)[0, 1])


def test_kv_quantize_and_dequantize_match_jax():
    t = (np.random.default_rng(5).standard_normal((2, 7, 3, 16)) * 2).astype(np.float32)
    t[0, 0, 0] = 0.0  # an all-zero vector takes the eps floor
    jq, js = jquant.kv_channel_quantize(jnp.asarray(t))
    tq, ts = quant.kv_channel_quantize(torch.from_numpy(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = quant.kv_dequantize(tq, ts, dt).float().numpy()
        want = np.asarray(jquant.kv_dequantize(jq, js, jdt), np.float32)
        np.testing.assert_array_equal(got, want)


def test_cast_params_keeps_quant_tensors_whole():
    qt = quant.channel_quantize(torch.randn(4, 3), 127.0, torch.int8)
    tree = {"a": qt, "b": [torch.ones(3)], "i": torch.arange(3)}
    out = quant.cast_params(tree, torch.bfloat16)
    assert out["a"] is qt and out["a"].scale.dtype == torch.float32
    assert out["b"][0].dtype == torch.bfloat16 and out["i"].dtype == torch.int64
    assert tbert.tree_map(lambda leaf: leaf, tree)["a"] is qt
    assert quant.storage_label(tree) == "int8"
    assert quant.storage_label({"w": torch.ones(2, 2)}) == "f32"
    moved = qt.to("cpu")
    assert moved.q.dtype == torch.int8 and moved.nbytes == 12 + 12


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_encoder_matches_jax_at_f32(jparams, mode):
    _, jc = jparams
    jq = jquant.quantize_params(jc, mode)
    tq = bert_params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    jcfg = jbert.BertConfig(**GEOM, dtype="float32")
    tcfg = tbert.BertConfig(**GEOM, dtype="float32")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (3, 24)).astype(np.int32)
    mask = (np.arange(24)[None] < np.array([[24], [9], [1]])).astype(np.int32)
    types = (np.arange(24)[None] >= 5).astype(np.int32) * mask
    want = np.asarray(jbert.embed_sentences(jq, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = tbert.embed_sentences(tq, torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    want = np.asarray(jbert.cross_encoder_score(jq, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                                jnp.asarray(types)))
    got = tbert.cross_encoder_score(tq, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                    tcfg, torch.from_numpy(types).long())
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _engines(jparams, mode, dtype, rerank=False):
    jp, jc = jparams
    jcfg = jbert.BertConfig(**GEOM, dtype=dtype)
    cross = dict(cross_params=jc, cross_cfg=jcfg) if rerank else {}
    jax_eng = TpuEngine(JaxEngineConfig(**ENG, dtype=dtype, quantize=mode, data_parallel=False),
                        params=jp, model_cfg=jcfg, tokenizer=JaxHashTokenizer(VOCAB), **cross)
    to_t = lambda t: bert_params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    tcfg = tbert.BertConfig(**GEOM, dtype=dtype)
    cross = dict(cross_params=to_t(jc), cross_cfg=tcfg) if rerank else {}
    port = TorchEngine(EngineConfig(**ENG, dtype=dtype, quantize=mode), params=to_t(jp),
                       model_cfg=tcfg, tokenizer=HashTokenizer(VOCAB), device="cpu", **cross)
    return jax_eng, port


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("mode", ["f16", "int8", "fp8"])
def test_quantized_engine_matches_quantized_tpu_engine(jparams, mode):
    # float32 compute: the same quantized weights give the same embeddings
    jax_eng, port = _engines(jparams, mode, "float32")
    np.testing.assert_allclose(port.embed_texts(CORPUS), jax_eng.embed_texts(CORPUS), **F32)
    # bf16 compute: cosine ≥ 0.999, the bf16 bar of tests/test_torch_bert.py
    jax_eng, port = _engines(jparams, mode, "bfloat16")
    assert _cos(port.embed_texts(CORPUS), jax_eng.embed_texts(CORPUS)).min() >= 0.999


def test_quantized_engines_meet_the_jax_bars_against_none(jparams):
    _, base = _engines(jparams, "none", "bfloat16")
    ref = base.embed_texts(CORPUS)
    for mode, bar in BARS.items():
        _, port = _engines(jparams, mode, "bfloat16")
        assert _cos(ref, port.embed_texts(CORPUS)).min() >= bar, mode


def test_int8_rerank_scores_match_jax(jparams):
    # scores with a tolerance, not argsort order: the synthetic
    # cross-encoder's score gaps are ~1e-5 (ROADMAP Queue C)
    jax_eng, port = _engines(jparams, "int8", "float32", rerank=True)
    assert quant.is_quantized(port.cross_params["classifier"]["kernel"])
    for query in ("which part is the bottleneck?", "matmul throughput"):
        np.testing.assert_allclose(port.rerank(query, CORPUS), jax_eng.rerank(query, CORPUS),
                                   **F32)


@pytest.mark.parametrize("mode,dtype,label", [
    ("none", "float32", "f32"), ("none", "bfloat16", "bf16"), ("f16", "bfloat16", "bf16"),
    ("f16", "float32", "bf16"), ("int8", "bfloat16", "int8"), ("fp8", "bfloat16", "fp8")])
def test_param_bytes_gauge_says_what_is_held(jparams, mode, dtype, label):
    _, port = _engines(jparams, mode, dtype)
    held = quant.param_bytes(port.params)
    assert metrics.gauge_get("engine.param_bytes",
                             labels={"service": "engine", "dtype": label}) == held
    n = sum(int(np.prod(leaf.shape)) for leaf in quant.leaves(port.params))
    width = 2 if dtype == "bfloat16" else 4
    if mode in ("int8", "fp8"):
        # one byte a code, float32 scales, the vectors in the compute dtype
        assert held < 0.55 * n * width
    elif mode == "f16":
        # bf16 matrices, never widened; the vectors in the compute dtype
        m = sum(int(np.prod(leaf.shape)) for leaf in quant.leaves(port.params)
                if leaf.ndim >= 2)
        assert held == 2 * m + width * (n - m)
    else:
        assert held == n * width
