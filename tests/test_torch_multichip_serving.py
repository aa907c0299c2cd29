"""The port's multi-device serving and training plane (A15 stage 1) on an
8-entry CPU mesh: the cases of `tests/test_multichip_serving.py` and
`tests/test_train.py::test_sharded_lm_train_step_dp_tp`, run against the
port (mesh against one device, at JAX's bars), and the port against the
JAX package on the same params: DP embed against JAX's `TpuEngine` on its
8-device mesh, TP `generate_batch` tokens against JAX's `LmEngine` on
`build_mesh([4, 2])`.

- the runner builds the mesh from `ParallelConfig` alone and threads it
  through TorchEngine, LmEngine and the store, with `mesh.devices{axis}`;
- DP embed through the mesh engine equals one device's, row for row, and
  the per-replica padding and shard-balance gauges account;
- the corpus-sharded store and fused search return identical hits (ids,
  scores, order), ties included;
- TP greedy decode is token-identical to one device's through
  `generate_batch` and a session with a mid-decode admission, with int8
  weights too (codes and scales shard together);
- the dp×tp LM train step matches the unsharded one (loss rtol 1e-4) and
  the params keep their TP layout;
- under a TP mesh the paged layout, a drafter and the online fine-tune
  serve one device's tokens (tests/test_torch_tp_serving.py holds them to
  JAX's TP engine).
"""

import asyncio
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from symbiont_tpu.config import EngineConfig as JaxEngineConfig
from symbiont_tpu.config import LmConfig as JaxLmConfig
from symbiont_tpu.engine.engine import TpuEngine
from symbiont_tpu.engine.lm import LmEngine as JaxLmEngine
from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
from symbiont_tpu.models import bert as jbert
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.parallel import build_mesh as jax_build_mesh
from symbiont_tpu_torch.config import (
    EngineConfig,
    LmConfig,
    SymbiontConfig,
    VectorStoreConfig,
)
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.engine.lm import LmEngine
from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
from symbiont_tpu_torch.memory.vector_store import VectorStore
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy, gpt_params_from_numpy
from symbiont_tpu_torch.parallel import Sharded, batch_sharding, build_mesh
from symbiont_tpu_torch.parallel.sharding import device_put
from symbiont_tpu_torch.train import trainer
from symbiont_tpu_torch.utils.telemetry import metrics

CPU = torch.device("cpu")
ENG_KW = dict(embedding_dim=32, length_buckets=[8, 16], batch_buckets=[8, 16],
              max_batch=16, dtype="float32", force_cpu=True)
TEXTS = [f"sentence number {i} with a few words" for i in range(12)]


def _mesh(shape=None, n=8):
    return build_mesh(shape, devices=[CPU] * n)


def _row_cos(a, b):
    num = np.sum(a * b, axis=1)
    den = np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)
    return num / den


# ------------------------------------------------------------ config → mesh


def _stack_config(tmp_path, shape=None, services="preprocessing,vector_memory,text_generator"):
    cfg = SymbiontConfig()
    cfg.parallel.mesh_shape = shape
    cfg.engine = EngineConfig(**ENG_KW)
    cfg.lm = LmConfig(enabled=True, arch="llama", hidden_size=32, num_layers=1, num_heads=2,
                      intermediate_size=64, max_positions=64, dtype="float32",
                      prompt_buckets=[8], new_token_buckets=[8], stream_chunk=4,
                      force_cpu=True)
    cfg.vector_store = VectorStoreConfig(dim=32, data_dir=str(tmp_path / "vs"),
                                         shard_capacity=64)
    cfg.graph_store.data_dir = str(tmp_path / "gs")
    cfg.text_generator.markov_state_path = None
    cfg.runner.services = services
    return cfg


def _run_stack(cfg, check, **kw):
    from symbiont_tpu_torch.runner import SymbiontStack

    async def scenario():
        stack = SymbiontStack(cfg, **kw)
        await stack.start()
        try:
            check(stack)
        finally:
            await stack.stop()

    asyncio.run(scenario())


def test_runner_builds_mesh_purely_from_config(tmp_path):
    """A stack configured with mesh_shape=[4, 2] serves DP embed, a sharded
    corpus and TP decode with no caller-supplied mesh, and registers the
    mesh.devices{axis} gauges."""
    def check(stack):
        assert stack.engine.mesh.shape == {"data": 4, "tensor": 2}
        assert stack.engine._n_data == 4
        assert stack.vector_store.mesh is stack.engine.mesh
        assert stack.lm.mesh is stack.engine.mesh  # TP sharded decode
        assert isinstance(stack.lm.params["layers"][0]["q"]["kernel"], Sharded)
        assert metrics.gauge_get("mesh.devices", labels={"axis": "data"}) == 4
        assert metrics.gauge_get("mesh.devices", labels={"axis": "tensor"}) == 2

    _run_stack(_stack_config(tmp_path, [4, 2]), check)


def test_runner_standalone_vector_memory_worker_gets_mesh(tmp_path):
    """A store-only worker (engine in another process) still owns a
    device-resident corpus: the runner builds the mesh for it too."""
    cfg = _stack_config(tmp_path, [8, 1], services="vector_memory")

    def check(stack):
        assert stack.engine is None
        assert stack.vector_store.mesh is not None
        assert stack.vector_store.mesh.shape["data"] == 8

    _run_stack(cfg, check)


def test_runner_parallel_disabled_keeps_meshless_engines(tmp_path):
    cfg = _stack_config(tmp_path, [4, 2], services="preprocessing")
    cfg.parallel.enabled = False

    def check(stack):
        assert stack.engine.mesh is None and stack.engine._n_data == 1

    _run_stack(cfg, check)


def test_runner_default_mesh_is_inert_on_one_device(tmp_path):
    """mesh_shape unset on a one-device host: a (1, 1) mesh, which every
    engine treats as none."""
    def check(stack):
        assert stack.engine.mesh.shape == {"data": 1, "tensor": 1}
        assert stack.engine._n_data == 1 and stack.lm.mesh is None
        assert not stack.vector_store._sharded()

    _run_stack(_stack_config(tmp_path), check)


@pytest.mark.parametrize("services", ["preprocessing", "text_generator"])
def test_runner_without_cuda_or_force_cpu_serves_nothing_on_the_cpu(tmp_path, monkeypatch,
                                                                    services):
    """No CUDA device and no owner that asks for the CPU: the mesh covers the
    local devices, so a mesh_shape over two entries raises at start and no
    engine carries on on the CPU unasked."""
    from symbiont_tpu_torch.runner import SymbiontStack

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _stack_config(tmp_path, [2, 1], services=services)
    cfg.engine = EngineConfig(**{**ENG_KW, "force_cpu": False})
    cfg.lm = dataclasses.replace(cfg.lm, force_cpu=False)

    async def scenario():
        stack = SymbiontStack(cfg)
        try:
            with pytest.raises(ValueError, match="does not cover 1 devices"):
                await stack.start()
            assert stack.engine is None and stack.lm is None
        finally:
            await stack.stop()

    asyncio.run(scenario())


def _llama_dir(tmp_path, heads: int, kv_heads: int) -> str:
    """A one-layer llama checkpoint written by `transformers` itself."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    d = tmp_path / "llama"
    LlamaForCausalLM(LlamaConfig(vocab_size=257, hidden_size=32, num_hidden_layers=1,
                                 num_attention_heads=heads, num_key_value_heads=kv_heads,
                                 intermediate_size=64, max_position_embeddings=128)
                     ).save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.mark.parametrize("tensor_parallel", ["auto", "on"])
def test_runner_judges_a_checkpoint_lm_by_its_kv_heads(tmp_path, tensor_parallel):
    """The runner's TP decision is `engine.lm.tp_decode` on the checkpoint's
    own geometry: 4 query heads divide a tensor axis of 2 and 1 KV head
    does not, so under "auto" the LM serves on one device, its paged
    layout included, as JAX's engine would, and under "on" the stack
    raises before it starts."""
    cfg = _stack_config(tmp_path, [1, 2], services="text_generator")
    cfg.lm = dataclasses.replace(cfg.lm, model_dir=_llama_dir(tmp_path, 4, 1),
                                 kv_layout="paged", kv_page_tokens=8,
                                 tensor_parallel=tensor_parallel)
    if tensor_parallel == "on":
        with pytest.raises(ValueError, match="kv_heads"):
            _run_stack(cfg, lambda stack: None)
        return

    def check(stack):
        assert stack.lm.model_cfg.kv_heads == 1 and stack.lm.mesh is None
        assert stack.lm.config.kv_layout == "paged"
        assert isinstance(stack.lm.generate("hi", 4, temperature=0.0), str)

    _run_stack(cfg, check)


# ------------------------------------------------------------------ DP embed


def test_dp_embed_parity_and_replica_gauges():
    """DP embed over the 8-way data axis matches one device row for row,
    and the per-replica padding-waste and shard-balance gauges account for
    the dispatched batch."""
    dp = TorchEngine(EngineConfig(**ENG_KW), mesh=_mesh())
    single = TorchEngine(EngineConfig(**ENG_KW, data_parallel=False))
    out_dp = dp.embed_texts(TEXTS)
    out_1 = single.embed_texts(TEXTS)
    np.testing.assert_allclose(out_dp, out_1, atol=1e-4, rtol=1e-3)
    assert _row_cos(out_dp, out_1).min() >= 0.999
    assert dp._batch_bucket(3) == 8 and dp._batch_bucket(9) == 16
    # 13 real rows in a 16-row batch over 8 replicas (2 rows each):
    # replicas 0-5 fully real, replica 6 half padding, replica 7 all padding
    dp._note_padding([8] * 13, 8, 16, 13)
    waste = [metrics.gauge_get("batcher.padding_waste",
                               labels={"service": "engine", "replica": str(r)})
             for r in range(8)]
    assert waste[:6] == [0.0] * 6
    assert waste[6] == pytest.approx(0.5)
    assert waste[7] == pytest.approx(1.0)
    assert metrics.gauge_get("engine.dp_shard_balance", labels={"service": "engine"}) == 0.0
    assert metrics.gauge_get("engine.dp_replicas", labels={"service": "engine"}) == 8


def test_dp_embed_and_rerank_match_jax_engine():
    """The port's DP engine against the JAX TpuEngine on its 8-device mesh,
    one param tree, f32 atol 2e-5 / rtol 1e-4."""
    geom = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=32, dtype="float32")
    jcfg = jbert.BertConfig(**geom)
    jp = jbert.init_params(jax.random.key(0), jcfg)
    jc = jbert.init_params(jax.random.key(1), jcfg, with_pooler=True)
    kw = {k: v for k, v in ENG_KW.items() if k != "force_cpu"}
    jax_eng = TpuEngine(JaxEngineConfig(**kw), params=jp, model_cfg=jcfg,
                        tokenizer=JaxHashTokenizer(500), cross_params=jc, cross_cfg=jcfg,
                        mesh=jax_build_mesh())
    to_np = lambda t: bert_params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    tcfg = tbert.BertConfig(**geom)
    port = TorchEngine(EngineConfig(**ENG_KW), params=to_np(jp), model_cfg=tcfg,
                       tokenizer=HashTokenizer(500), cross_params=to_np(jc), cross_cfg=tcfg,
                       mesh=_mesh())
    assert port._n_data == jax_eng._n_data == 8
    np.testing.assert_allclose(port.embed_texts(TEXTS), jax_eng.embed_texts(TEXTS),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(port.rerank("a query", TEXTS[:5]),
                               jax_eng.rerank("a query", TEXTS[:5]), atol=2e-5, rtol=1e-4)


def test_micro_batcher_rounds_flush_cap_to_data_axis():
    from symbiont_tpu_torch.engine.batcher import MicroBatcher

    eng = TorchEngine(EngineConfig(**ENG_KW), mesh=_mesh())

    async def scenario():
        # a 13-item cap would bucket every full flush to 16 rows with 3
        # permanent pad rows; mesh-aware sizing rounds it to 16
        b = MicroBatcher(eng, max_batch=13)
        assert b.max_batch == 16
        await b.start()
        out = await b.embed(TEXTS[:4])
        assert out.shape == (4, 32)
        await b.close()

    asyncio.run(scenario())


# -------------------------------------------------------- sharded search


def _store(mesh, ids, vecs, payloads, block=64):
    s = VectorStore(VectorStoreConfig(dim=vecs.shape[1], data_dir="", shard_capacity=block),
                    device="cpu", mesh=mesh)
    s.upsert_rows(ids, vecs, payloads)
    return s


def test_sharded_search_identical_to_single_device():
    """Corpus-sharded search (per-shard top-k + merge) returns identical
    hits (ids, scores, order) to the single-device store, with the corpus
    really split over the 'data' axis."""
    mesh = _mesh()
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    ids = [f"p{i}" for i in range(300)]
    payloads = [{"i": i} for i in range(300)]
    plain, sharded = _store(None, ids, vecs, payloads), _store(mesh, ids, vecs, payloads)
    for _ in range(16):
        q = rng.standard_normal(32).astype(np.float32)
        a, b = plain.search(q, 7), sharded.search(q, 7)
        assert [(h.id, h.score) for h in a] == [(h.id, h.score) for h in b]
    corpus = sharded._device_corpus
    assert isinstance(corpus, Sharded) and corpus.spec == ("data",)
    # 300 rows → capacity rounds to a multiple of both the block and the axis
    assert corpus.shape[0] % 8 == 0 and corpus.shards[1].shape[0] == corpus.shape[0] // 8
    # an upsert past the capacity block makes a new sharded buffer
    sharded.upsert_rows(["late"], vecs[:1] * 2, [{}])
    assert sharded.search(vecs[0], 2)[0].id in ("p0", "late")


def test_sharded_search_ties_preserve_index_order():
    """Score ties resolve identically on both paths: each shard by row,
    shards in global row order, a stable merge."""
    base = np.zeros((96, 32), np.float32)
    base[:, 0] = 1.0  # every row identical → every score ties
    ids = [f"t{i:03d}" for i in range(96)]
    q = np.zeros(32, np.float32)
    q[0] = 1.0
    a = _store(None, ids, base, [{} for _ in ids], 32).search(q, 10)
    b = _store(_mesh(), ids, base, [{} for _ in ids], 32).search(q, 10)
    assert [h.id for h in a] == [h.id for h in b] == ids[:10]


def test_fused_search_sharded_matches_split_and_single():
    """search_fused over a sharded corpus (the query vector, then each
    shard's top-k on its entry) returns the hits of the single-device fused
    path and of split search(embed_query)."""
    eng_dp = TorchEngine(EngineConfig(**ENG_KW), mesh=_mesh())
    eng_1 = TorchEngine(EngineConfig(**ENG_KW, data_parallel=False))
    texts = [f"document about topic {i} and detail {i % 7}" for i in range(40)]
    vecs = eng_1.embed_texts(texts)
    ids, payloads = [f"d{i}" for i in range(40)], [{"t": t} for t in texts]
    plain, sharded = _store(None, ids, vecs, payloads), _store(_mesh(), ids, vecs, payloads)
    for q in ("topic detail", "document about seven"):
        fused_sharded = sharded.search_fused(eng_dp, q, 5)
        fused_single = plain.search_fused(eng_1, q, 5)
        assert [h.id for h in fused_sharded] == [h.id for h in fused_single]
        np.testing.assert_allclose([h.score for h in fused_sharded],
                                   [h.score for h in fused_single], atol=1e-4, rtol=1e-4)
        split = plain.search(eng_1.embed_query(q), 5)
        assert [h.id for h in fused_sharded] == [h.id for h in split]


# ------------------------------------------------------------------ TP decode

LM_KW = dict(enabled=True, arch="gpt2", hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_positions=128, dtype="float32", prompt_buckets=[8, 16],
             new_token_buckets=[16], stream_chunk=4, session_min_rows=4, seed=3,
             force_cpu=True)


def _session_outputs(lm):
    sess = lm.start_session(["the quick brown fox"], [12], temperature=0.0)
    out = dict(sess.step())
    tags = sess.admit(["hello world"], [8], temperature=0.0)
    assert tags and tags[0] is not None
    while not sess.done():
        out.update(sess.step())
    return sorted(out.items())


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_tp_decode_token_identical_through_serving_paths(quantize):
    """TP greedy decode == one device, through generate_batch AND a session
    with a mid-decode admission, and a stream; int8 runs the same bar with
    codes and scales sharded together."""
    single = LmEngine(LmConfig(quantize=quantize, **LM_KW))
    tp = LmEngine(LmConfig(quantize=quantize, **LM_KW), mesh=_mesh([4, 2]))
    assert tp.mesh is not None, "a TP mesh must shard, not fall back"
    prompts = ["the quick brown fox", "mesh native decode"]
    base = single.generate_batch(prompts, [12, 12], temperature=0.0)
    assert tp.generate_batch(prompts, [12, 12], temperature=0.0) == base
    assert _session_outputs(tp) == _session_outputs(single)
    assert "".join(tp.generate_stream("hello", 10, temperature=0.0)) == single.generate(
        "hello", 10, temperature=0.0)
    # every KV cache of the TP engine holds one shard a tensor entry
    kv = [exe.cache for _, exe in tp._prefills.items()]
    assert kv and all(isinstance(c, tgpt.TPCache) and len(c.shards) == 2 for c in kv)


def test_tp_int8_params_shard_with_scales():
    """Codes take the kernel's spec; the scales ride the kernel's last
    entry (col-split q/k/v scales split on 'tensor', row-split o's scales
    replicate); lm.param_bytes reports the narrow storage."""
    tp = LmEngine(LmConfig(quantize="int8", **LM_KW), mesh=_mesh([4, 2]))
    layer = tp.params["layers"][0]
    q_kernel, o_kernel = layer["q"]["kernel"], layer["o"]["kernel"]
    assert isinstance(q_kernel, quant.QuantTensor)
    assert "tensor" in q_kernel.q.spec and "tensor" in q_kernel.scale.spec
    assert "tensor" in o_kernel.q.spec and "tensor" not in o_kernel.scale.spec
    assert metrics.gauge_get("lm.param_bytes",
                             labels={"service": "lm", "dtype": "int8"}) > 0
    assert tp.param_bytes() > 0


def test_tp_on_with_quantize_no_longer_raises_or_warns(caplog):
    with caplog.at_level(logging.WARNING, logger="symbiont_tpu_torch.engine.lm"):
        lm = LmEngine(LmConfig(tensor_parallel="on", quantize="int8", **LM_KW),
                      mesh=_mesh([4, 2]))
    assert lm.mesh is not None
    assert not [r for r in caplog.records if "unquantized" in r.getMessage()]
    assert lm.generate("hello", 8, temperature=0.0)


@pytest.mark.parametrize("shape,kw", [
    (None, dict(tensor_parallel="on")),             # no tensor axis
    ([2, 4], dict(tensor_parallel="on", num_heads=2)),  # heads do not divide 4
])
def test_tensor_parallel_on_raises_where_jax_raises(shape, kw):
    lm_kw = {**LM_KW, **kw}
    with pytest.raises(ValueError):
        JaxLmEngine(JaxLmConfig(**{k: v for k, v in lm_kw.items() if k != "force_cpu"}),
                    mesh=jax_build_mesh(shape))
    with pytest.raises(ValueError, match="tensor"):
        LmEngine(LmConfig(**lm_kw), mesh=_mesh(shape))


def test_tp_engine_refuses_the_unported_branches_by_name():
    """Under a TP mesh the paged layout, speculative decoding and the online
    fine-tune serve (each was once refused there): paged and self-drafted
    TP engines give one device's greedy tokens, and an `OnlineLmTrainer`
    over a TP engine trains placed masters and syncs them into the
    engine's shards, whose tokens then equal a one-device engine's on the
    same weights. (tests/test_torch_tp_serving.py holds all three to JAX.)"""
    from symbiont_tpu_torch.train.online import OnlineLmTrainer

    prompts = ["the quick brown fox", "mesh native decode"]
    paged = {**LM_KW, "kv_layout": "paged", "kv_page_tokens": 8}
    single = LmEngine(LmConfig(**paged))
    base = single.generate_batch(prompts, [12, 12], temperature=0.0)
    tp_paged = LmEngine(LmConfig(**paged), mesh=_mesh([1, 2], 2), params=single.params,
                        model_cfg=single.model_cfg)
    assert tp_paged.mesh is not None and len(tp_paged.pool.shards) == 2
    assert tp_paged.generate_batch(prompts, [12, 12], temperature=0.0) == base
    assert _session_outputs(tp_paged) == _session_outputs(single)
    assert tp_paged.pool.pages_live == 0

    donor = LmEngine(LmConfig(**LM_KW))
    spec = LmEngine(LmConfig(**LM_KW), mesh=_mesh([1, 2], 2), params=donor.params,
                    model_cfg=donor.model_cfg, draft_params=donor.params,
                    draft_model_cfg=donor.model_cfg)
    assert spec.mesh is not None and spec._draft is not None
    assert (spec.generate_batch(prompts, [12, 12], temperature=0.0)
            == donor.generate_batch(prompts, [12, 12], temperature=0.0))
    assert _session_outputs(spec) == _session_outputs(donor)

    tp = LmEngine(LmConfig(**LM_KW), mesh=_mesh([1, 2], 2))
    trainer = OnlineLmTrainer(tp, seq_len=16, batch_size=2)
    assert trainer.train_on_texts(["the mesh shards batches across devices " * 4])["steps"] > 0
    assert isinstance(tp.params["layers"][0]["q"]["kernel"], Sharded)
    fresh = LmEngine(LmConfig(**LM_KW), params=quant.tree_map(
        lambda t: t.detach(), _trainer_tree(trainer)), model_cfg=tp.model_cfg)
    assert (tp.generate_batch(prompts, [12, 12], temperature=0.0)
            == fresh.generate_batch(prompts, [12, 12], temperature=0.0))


def _trainer_tree(trainer):
    """A trainer's placed masters gathered whole on the CPU."""
    from symbiont_tpu_torch.parallel.sharding import gather_tree

    return gather_tree(trainer.state.params, CPU)


def test_tp_auto_indivisible_serves_on_one_device_as_jax(caplog):
    with caplog.at_level(logging.WARNING, logger="symbiont_tpu_torch.engine.lm"):
        lm = LmEngine(LmConfig(**{**LM_KW, "num_heads": 2}), mesh=_mesh([2, 4]))
    jax_lm = JaxLmEngine(JaxLmConfig(**{k: v for k, v in LM_KW.items() if k != "force_cpu"}),
                         mesh=jax_build_mesh([2, 4]))
    assert lm.mesh is None and jax_lm.mesh is None
    assert any("falling back" in r.getMessage() for r in caplog.records)
    assert not isinstance(lm.params["wte"], Sharded)


def _blocks_equal(placed, whole) -> bool:
    """Whether every mesh entry's shard of `placed` is its block of `whole`."""
    for i, shard in enumerate(placed.shards):
        sl = tuple(slice(b * n, (b + 1) * n) for b, n in zip(placed.block(i), shard.shape))
        if not torch.equal(shard, whole[sl]):
            return False
    return True


def test_an_update_reaches_every_replica():
    """Every mesh entry holds its own copy, on a repeated device too, so an
    update must reach each: `LmEngine.update_params` on a [2, 2] mesh
    writes every entry's shard (data row 1's as well as the serving
    row's), and a store's upserts after a search reach every entry's copy
    of their rows."""
    mesh = _mesh([2, 2], 4)
    lm, single = LmEngine(LmConfig(**LM_KW), mesh=mesh), LmEngine(LmConfig(**LM_KW))
    new = quant.tree_map(lambda t: t * 1.5, single.params)
    lm.update_params(new)
    single.update_params(new)
    for got, want in zip(trainer.tree_leaves(lm.params), trainer.tree_leaves(single.params)):
        assert isinstance(got, Sharded) and _blocks_equal(got, want)
        assert len({id(t) for t in got.shards}) == 4  # a copy an entry
    prompts = ["the quick brown fox", "x"]
    assert (lm.generate_batch(prompts, [8, 8], temperature=0.0)
            == single.generate_batch(prompts, [8, 8], temperature=0.0))

    vcfg = VectorStoreConfig(dim=8, data_dir="", shard_capacity=16)
    sharded, plain = VectorStore(vcfg, device="cpu", mesh=mesh), VectorStore(vcfg, device="cpu")
    rng = np.random.default_rng(5)
    q = rng.standard_normal(8).astype(np.float32)
    for ids in ([f"r{i}" for i in range(20)], ["r3", "r17"] + [f"s{i}" for i in range(6)]):
        vecs = rng.standard_normal((len(ids), 8)).astype(np.float32)
        for st in (sharded, plain):
            st.upsert_rows(ids, vecs)
        hits = [(h.id, h.score) for h in sharded.search(q, 10)]
        assert hits == [(h.id, h.score) for h in plain.search(q, 10)]
    corpus = sharded._device_corpus
    assert _blocks_equal(corpus, plain._device_corpus)
    assert len({id(t) for t in corpus.shards}) == 4


def test_tp_generate_batch_matches_jax():
    """The port's TP engine and JAX's on build_mesh([4, 2]), one param tree
    (a byte-vocab llama with GQA, kernels ×8 off JAX's init so greedy
    text moves): the same greedy tokens."""
    jcfg = jgpt.GPTConfig(vocab_size=257, hidden_size=32, num_layers=2, num_heads=4,
                          num_kv_heads=2, intermediate_size=64, max_position_embeddings=128,
                          arch="llama", dtype="float32", tie_word_embeddings=False)
    tree = jax.tree.map(lambda a: np.asarray(a) * (8 if np.ndim(a) >= 2 else 1),
                        jgpt.init_params(jax.random.key(4), jcfg))
    kw = {**LM_KW, "arch": "llama", "num_heads": 4}
    jax_lm = JaxLmEngine(JaxLmConfig(**{k: v for k, v in kw.items() if k != "force_cpu"}),
                         params=tree, model_cfg=jcfg, mesh=jax_build_mesh([4, 2]))
    port = LmEngine(LmConfig(**kw), params=gpt_params_from_numpy(tree, "cpu"),
                    model_cfg=tgpt.GPTConfig(**dataclasses.asdict(jcfg)), mesh=_mesh([4, 2]))
    assert jax_lm.mesh is not None and port.mesh is not None
    prompts = ["the quick brown fox", "mesh native decode", "x"]
    want = jax_lm.generate_batch(prompts, [12, 12, 12], temperature=0.0)
    assert port.generate_batch(prompts, [12, 12, 12], temperature=0.0) == want


# ------------------------------------------------------------- dp×tp train


@pytest.mark.parametrize("arch,nkv", [("gpt2", None), ("llama", 2)])
def test_sharded_lm_train_step_dp_tp(arch, nkv):
    """A full train step with TP-placed masters and a DP-split batch on a
    4x2 mesh: loss and grad norm within rtol 1e-4 of the unsharded step,
    two steps compose, the params keep their TP layout and equal the
    unsharded ones, and the replicas track their masters."""
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                         num_kv_heads=nkv, intermediate_size=64, max_position_embeddings=32,
                         dtype="float32", arch=arch, attn_impl="flash",
                         tie_word_embeddings=arch == "gpt2")
    params = tgpt.init_params(torch.Generator().manual_seed(2), cfg)
    rng = np.random.default_rng(2)
    batch = {"ids": torch.from_numpy(rng.integers(1, 64, (8, 16))),
             "mask": torch.ones((8, 16), dtype=torch.int32)}
    batch["mask"][5, 11:] = 0
    mesh = _mesh([4, 2])
    ref, tx_ref = trainer.make_lm_train_state(params)
    state, tx = trainer.make_lm_train_state(params)
    state, tx = trainer.shard_lm_train_state(mesh, state, tx, arch=arch)
    placed = {k: device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
    for b in (placed, batch):  # a placed batch, then a whole one split by rows
        ref, m_ref = trainer.lm_train_step(ref, batch, cfg, tx_ref)
        state, m = trainer.lm_train_step(state, b, cfg, tx)
        assert np.isfinite(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-4)
    qk = state.params["layers"][0]["q"]["kernel"]
    assert isinstance(qk, Sharded) and "tensor" in qk.spec
    torch.testing.assert_close(qk.gather(), ref.params["layers"][0]["q"]["kernel"].detach(),
                               atol=1e-6, rtol=1e-4)
    assert state.step == 2 and len(trainer.masters(state.params)) == len(tx.state)
    # every replica (a copy of its own on the repeated device) tracks its master
    for leaf in trainer.tree_leaves(state.params):
        assert len({id(t) for t in leaf.shards}) == 8
        assert all(torch.equal(t, leaf.home(i)) for i, t in enumerate(leaf.shards))


def test_sharded_lm_train_step_matches_jax():
    """The port's dp×tp step against the JAX package's `shard_lm_train_state`
    + `lm_train_step` on its [4, 2] mesh, one param tree and one batch:
    loss and grad norm within rtol 1e-4 over two steps, and the updated
    q kernel to float32 noise."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from symbiont_tpu.train import trainer as jtrain

    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                          intermediate_size=64, max_position_embeddings=32, dtype="float32")
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.key(2), jcfg))
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 64, (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.int32)
    mask[6, 9:] = 0
    jmesh = jax_build_mesh([4, 2])
    jstate, jtx = jtrain.make_lm_train_state(jax.tree.map(jnp.asarray, tree))
    jstate = jtrain.shard_lm_train_state(jmesh, jstate, arch="gpt2")
    data = NamedSharding(jmesh, PartitionSpec("data"))
    jbatch = {"ids": jax.device_put(jnp.asarray(ids), data),
              "mask": jax.device_put(jnp.asarray(mask), data)}
    cfg = tgpt.GPTConfig(**{**dataclasses.asdict(jcfg), "attn_impl": "flash"})
    state, tx = trainer.make_lm_train_state(gpt_params_from_numpy(tree, "cpu"))
    state, tx = trainer.shard_lm_train_state(_mesh([4, 2]), state, tx, arch="gpt2")
    batch = {"ids": torch.from_numpy(ids).long(), "mask": torch.from_numpy(mask)}
    for _ in range(2):
        jstate, jm = jtrain.lm_train_step(jstate, jbatch, jcfg, jtx)
        state, m = trainer.lm_train_step(state, batch, cfg, tx)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(state.params["layers"][0]["q"]["kernel"].gather().detach().numpy(),
                               np.asarray(jstate.params["layers"][0]["q"]["kernel"]),
                               atol=1e-6, rtol=1e-4)

