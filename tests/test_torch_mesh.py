"""The port's mesh and sharding specs (`symbiont_tpu_torch/parallel/`) on an
8-entry CPU mesh, held to the JAX package's (`symbiont_tpu/parallel/`).

The cases of `tests/test_parallel.py` that do not need sequence or pipeline
parallelism (`test_mesh_build_and_shape_error`,
`test_dp_embedding_matches_single_device`,
`test_tp_gpt_logits_match_unsharded`), the config cases of
`tests/test_multichip_serving.py`, and the spec trees themselves: the port's
`gpt_param_sharding` splits the same dimension of every leaf as JAX's, for
both archs and for a vocab that divides the tensor axis and one that does
not. An explicit device list repeating `cpu` is the port's counterpart of
JAX's 8 virtual CPU devices (`tests/conftest.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.config import ParallelConfig as JaxParallelConfig
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.parallel import build_mesh as jax_build_mesh
from symbiont_tpu.parallel import gpt_param_sharding as jax_gpt_param_sharding
from symbiont_tpu.parallel import parse_mesh_spec as jax_parse_mesh_spec
from symbiont_tpu_torch.config import ParallelConfig
from symbiont_tpu_torch.memory.vector_store import cosine_topk
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.parallel import (
    Sharded,
    batch_sharding,
    build_mesh,
    corpus_topk,
    gpt_param_sharding,
    mesh_from_config,
    parse_mesh_spec,
    replicate,
    shard_params,
)
from symbiont_tpu_torch.parallel.sharding import device_put, gather_tree, local_tree

CPU8 = [torch.device("cpu")] * 8


def test_mesh_build_and_shape_error():
    mesh = build_mesh(devices=CPU8)
    assert mesh.shape == {"data": 8, "tensor": 1}
    mesh2 = build_mesh([2, 4], devices=CPU8)
    assert mesh2.shape == {"data": 2, "tensor": 4}
    assert mesh2.flat_index(data=1, tensor=2) == 6 and mesh2.coords(6) == {"data": 1, "tensor": 2}
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh([3, 2], devices=CPU8)
    with pytest.raises(ValueError, match="does not cover"):
        jax_build_mesh([3, 2])


@pytest.mark.parametrize("spec", ["dp4xtp2", "dp8", "tp2", "4x2", "8", " DP2xTP4 ", "banana",
                                  "dp", "4x"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_mesh_spec(spec)
        return
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("kw", [dict(mesh_shape=[]), dict(mesh_shape=[0, 8]),
                                dict(mesh_shape=[8]), dict(mesh_shape=[4, 2])])
def test_parallel_config_validation_matches_jax(kw):
    try:
        JaxParallelConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            ParallelConfig(**kw)
        return
    assert dataclasses.asdict(ParallelConfig(**kw)) == dataclasses.asdict(JaxParallelConfig(**kw))


def test_mesh_from_config_shapes():
    """No CUDA here: the default covers the one local device; a configured
    shape on the CPU repeats it, as JAX's virtual devices do."""
    assert mesh_from_config(ParallelConfig()).shape == {"data": 1, "tensor": 1}
    mesh = mesh_from_config(ParallelConfig(mesh_shape=[4, 2]), cpu=True)
    assert mesh.shape == {"data": 4, "tensor": 2}
    assert all(d == torch.device("cpu") for d in mesh.device_list)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_from_config(ParallelConfig(mesh_shape=[4, 2]))


def _specs(tree, path=()):
    """(path, spec as a tuple) for every leaf of a spec tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _specs(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _specs(v, path + (i,))
    else:
        yield path, tuple(tree)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
@pytest.mark.parametrize("vocab", [64, 257], ids=["divides", "odd"])
def test_gpt_param_sharding_matches_jax(arch, vocab):
    cfg = jgpt.GPTConfig(vocab_size=vocab, hidden_size=32, num_layers=2, num_heads=4,
                         num_kv_heads=2 if arch == "llama" else None, intermediate_size=64,
                         max_position_embeddings=32, arch=arch, dtype="float32",
                         tie_word_embeddings=arch == "gpt2")
    shapes = jax.eval_shape(lambda: jgpt.init_params(jax.random.key(0), cfg))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = dict(_specs(jax_gpt_param_sharding(jax_build_mesh([4, 2]), tree, arch=arch)))
    got = dict(_specs(gpt_param_sharding(build_mesh([4, 2], devices=CPU8), tree, arch=arch)))
    assert got == want
    assert got[("wte",)] == (("tensor", None) if vocab == 64 else ())


def test_placed_blocks_are_copies_on_a_repeated_device_and_gather_back():
    """Every entry holds its own copy, as a card of its own would: a
    repeated device hides no replica behind its block's first holder."""
    mesh = build_mesh([4, 2], devices=CPU8)
    w = torch.arange(48.0).view(6, 8)
    col = device_put(w, type(batch_sharding(mesh))(mesh, (None, "tensor")))
    assert [tuple(t.shape) for t in col.shards] == [(6, 4)] * 8
    # two blocks, each on four entries: 8 x 24 floats, block 0 at home at entry 0
    assert col.shards[0] is not col.shards[2] and torch.equal(col.shards[0], col.shards[2])
    assert col.nbytes == 8 * 24 * 4 and col.home_index(2) == 0 and col.home_index(3) == 1
    assert len(col.homes()) == 2
    assert torch.equal(col.gather(), w)
    rep = replicate(mesh, {"w": w})["w"]
    assert all(t is not w and torch.equal(t, w) for t in rep.shards)
    assert rep.nbytes == 8 * 48 * 4
    rows = device_put(torch.arange(16.0).view(16, 1), batch_sharding(mesh))
    assert torch.equal(rows.shards[mesh.flat_index(data=3, tensor=1)].flatten(),
                       torch.arange(12.0, 16.0))
    with pytest.raises(ValueError, match="not divisible"):
        device_put(torch.zeros(6, 3), type(batch_sharding(mesh))(mesh, (None, "tensor")))


def test_int8_leaves_shard_codes_with_their_scales():
    """Codes take the kernel's spec, per-output-channel scales its last
    entry: col-split q keeps its scales with its channels, row-split o's
    scales replicate."""
    mesh = build_mesh([4, 2], devices=CPU8)
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                         intermediate_size=64, max_position_embeddings=32, dtype="float32")
    params = quant.quantize_params(tgpt.init_params(torch.Generator().manual_seed(0), cfg), "int8")
    placed = shard_params(mesh, params, gpt_param_sharding(mesh, params))
    q, o = placed["layers"][0]["q"]["kernel"], placed["layers"][0]["o"]["kernel"]
    assert isinstance(q, quant.QuantTensor) and isinstance(q.q, Sharded)
    assert q.q.spec == (None, "tensor") and q.scale.spec == ("tensor",)
    assert o.q.spec == ("tensor", None) and o.scale.spec == (None,)
    assert tuple(q.scale.shards[1].shape) == (16,) and tuple(o.scale.shards[1].shape) == (32,)
    whole = gather_tree(placed)
    for a, b in zip(quant.leaves(whole), quant.leaves(params)):
        for x, y in ((a.q, b.q), (a.scale, b.scale)) if quant.is_quantized(a) else ((a, b),):
            assert torch.equal(x, y)
    # a shard's codes times its scales is its block of the dequantized kernel
    blk = local_tree(placed, mesh.flat_index(data=2, tensor=1))["layers"][0]["q"]["kernel"]
    assert torch.equal(blk.dequantize(), params["layers"][0]["q"]["kernel"].dequantize()[:, 16:])
    # every entry's copy counts: a block split over 'tensor' is on 4
    # entries (data=4), o's replicated scales on all 8
    pq, po = params["layers"][0]["q"]["kernel"], params["layers"][0]["o"]["kernel"]
    nb = quant.tensor_bytes
    assert quant.param_bytes([q, o]) == (4 * (nb(pq.q) + nb(pq.scale) + nb(po.q))
                                         + 8 * nb(po.scale))


def test_dp_embedding_matches_single_device():
    """Replicated params, the batch split over 'data', each replica's rows
    embedded on its entry and gathered: the single-device embedding."""
    cfg = tbert.BertConfig(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                           intermediate_size=32, max_position_embeddings=32, dtype="float32")
    params = tbert.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 64, size=(16, 12)))
    mask = torch.ones((16, 12), dtype=torch.int32)
    mask[:, 9:] = 0
    ref = tbert.embed_sentences(params, ids, mask, cfg)
    mesh = build_mesh(devices=CPU8)
    reps = replicate(mesh, params)
    ids_s, mask_s = (device_put(t, batch_sharding(mesh)) for t in (ids, mask))
    out = torch.cat([tbert.embed_sentences(local_tree(reps, i), ids_s.shards[i], mask_s.shards[i],
                                           cfg) for i in range(8)])
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_tp_gpt_logits_match_unsharded_and_jax():
    """Pure TP over 8 entries: the port's TP forward against its unsharded
    forward, and against the JAX package's forward on the same params."""
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=8,
                          intermediate_size=64, max_position_embeddings=32, dtype="float32")
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.key(1), jcfg))
    ids = np.random.default_rng(1).integers(0, 64, size=(2, 10)).astype(np.int32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    cache = jgpt.init_cache(jcfg, 2, 10, jnp.float32)
    want, _ = jgpt.forward(tree, jnp.asarray(ids), cache, jnp.asarray(pos), jcfg)
    cfg = tgpt.GPTConfig(**dataclasses.asdict(jcfg))
    params = gpt_params_from_numpy(tree, "cpu")
    tids, tpos = torch.from_numpy(ids).long(), torch.from_numpy(pos.copy()).long()
    ref, _ = tgpt.forward(params, tids, None, tpos, cfg)
    mesh = build_mesh([1, 8], devices=CPU8)
    placed = shard_params(mesh, params, gpt_param_sharding(mesh, params, arch="gpt2"))
    out, _ = tgpt.forward(placed, tids, None, tpos, cfg)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    # the KV cache of a TP forward: each shard's one KV head, on its entry
    tp_cache = tgpt.init_tp_cache(placed, cfg, 2, 10, torch.float32)
    assert len(tp_cache.shards) == 8 and tp_cache.shards[0].k.shape[3] == 1
    got, _ = tgpt.forward(placed, tids, tp_cache, tpos, cfg)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "ties"])
def test_corpus_topk_is_the_single_device_top_k(tied):
    """Per-shard top-k with global row ids and the stable merge give the
    single-device hits exactly: ids, scores and order, ties by row."""
    mesh = build_mesh(devices=CPU8)
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((96, 16)).astype(np.float32)
    if tied:
        vecs[:] = 0.0
        vecs[:, 0] = 1.0
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    corpus = torch.from_numpy(vecs).to(torch.bfloat16)
    placed = device_put(corpus, batch_sharding(mesh))
    q = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    q[0] = 3.0
    q /= q.norm()
    for n_valid, k in ((96, 10), (70, 16), (5, 8), (96, 32)):
        want = cosine_topk(corpus, q, n_valid, k)
        got = corpus_topk(mesh, placed, q, torch.tensor(n_valid), k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    with pytest.raises(ValueError, match="not divisible"):  # 12 rows over 8 shards
        corpus_topk(mesh, replicate(mesh, {"c": corpus[:12]})["c"], q, 12, 4)
