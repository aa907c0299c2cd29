"""The port's LmEngine under a tensor-parallel mesh against the JAX
package's on the same one, on the CPU: the paged KV layout (with the radix
prefix cache, f32 and int8 KV), speculative decoding (a self-drafted
target, dense and paged, and a `GenBatcher` over the paged one) and the
online LM fine-tune of a TP engine, its train state saved and loaded
across the packages.

Both engines serve one param tree (a byte-vocab llama with GQA, kernels
x8 off JAX's init so greedy text moves, `gpt_params_from_numpy` on the
port's side): JAX's on `build_mesh([1, 2], devices=jax.devices()[:2])`,
the port's on `build_mesh([1, 2], devices=[cpu, cpu])`. Tokens, radix hit
counts, page gauges and draft counts are equal; losses within rtol 1e-4,
the `q` master within atol 1e-6 / rtol 1e-4."""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from symbiont_tpu.config import LmConfig as JaxLmConfig
from symbiont_tpu.engine.batcher import GenBatcher as JaxGenBatcher
from symbiont_tpu.engine.lm import LmEngine as JaxLmEngine
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.parallel import build_mesh as jax_build_mesh
from symbiont_tpu.train import checkpoint as jckpt
from symbiont_tpu.train.online import OnlineLmTrainer as JaxOnlineLmTrainer
from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.engine.batcher import GenBatcher
from symbiont_tpu_torch.engine.lm import LmEngine
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.parallel import Sharded, build_mesh
from symbiont_tpu_torch.train import checkpoint as tckpt
from symbiont_tpu_torch.train.online import OnlineLmTrainer
from symbiont_tpu_torch.train.trainer import tree_leaves

CPU = torch.device("cpu")
LM = dict(enabled=True, arch="llama", hidden_size=32, num_layers=2, num_heads=4,
          intermediate_size=64, max_positions=128, dtype="float32", prompt_buckets=[16, 32],
          new_token_buckets=[32], kv_page_tokens=8, stream_chunk=4, session_min_rows=4,
          gen_max_batch=4, temperature=0.0)
DOC = ["the tensor axis splits every head and the mlp width across two shards " * 3]


def _tree(seed=4):
    jcfg = jgpt.GPTConfig(vocab_size=257, hidden_size=32, num_layers=2, num_heads=4,
                          num_kv_heads=2, intermediate_size=64, max_position_embeddings=128,
                          arch="llama", dtype="float32", tie_word_embeddings=False)
    tree = jax.tree.map(lambda a: np.asarray(a) * (8 if np.ndim(a) >= 2 else 1),
                        jgpt.init_params(jax.random.key(seed), jcfg))
    return tree, jcfg


def _pair(draft=False, **kw):
    """(JAX engine, port engine) on [1, 2] meshes over one tree; with
    `draft` each is its own drafter."""
    tree, jcfg = _tree()
    cfg = {**LM, **kw}
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(jcfg))
    jd, td = {}, {}
    if draft:
        jd = dict(draft_params=tree, draft_model_cfg=jcfg)
        td = dict(draft_params=gpt_params_from_numpy(tree, "cpu"), draft_model_cfg=tcfg)
    jax_eng = JaxLmEngine(JaxLmConfig(**cfg), params=tree, model_cfg=jcfg,
                          mesh=jax_build_mesh([1, 2], devices=jax.devices()[:2]), **jd)
    port = LmEngine(LmConfig(**cfg), params=gpt_params_from_numpy(tree, "cpu"), model_cfg=tcfg,
                    mesh=build_mesh([1, 2], devices=[CPU] * 2), device="cpu", **td)
    assert jax_eng.mesh is not None and port.mesh is not None
    return jax_eng, port


def _drain(sess) -> dict:
    out = {}
    while not sess.done():
        out.update(sess.step())
    return out


def _prefix_session(eng) -> tuple:
    """A cold start, then a session whose mid-decode admission shares its
    first page with the committed prompt → (outputs, radix stats, pages
    live and free after)."""
    first = _drain(eng.start_session(["shared prefix pages and a tail", "another row"],
                                     [10, 10]))
    sess = eng.start_session(["shared prefix pages and a tail"], [12])
    out = dict(sess.step())
    assert None not in sess.admit(["shared prefix pages but a fork"], [8])
    out.update(_drain(sess))
    return first, out, dict(eng.radix.stats), eng.pool.pages_live, eng.pool.pages_free


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tp_paged_matches_jax(kv_quant):
    """TP paged greedy tokens through generate_batch and a session with a
    prefix-sharing admission equal JAX's TP paged engine's; the radix
    stats and the pool's live and free pages after equal too, and the
    pool is one set of arrays a shard, its bytes JAX's pool's."""
    jax_eng, port = _pair(kv_layout="paged", kv_quant=kv_quant)
    prompts = ["the quick brown fox", "mesh native decode", "x"]
    want = jax_eng.generate_batch(prompts, [12, 12, 12])
    assert port.generate_batch(prompts, [12, 12, 12]) == want
    got = _prefix_session(port)
    assert got == _prefix_session(jax_eng)
    assert got[2]["hits"] >= 1 and got[2]["committed_pages"] > 0
    assert len(port.pool.shards) == 2 and port.pool.device_bytes == jax_eng.pool.device_bytes
    assert port.pool.shards[0][0].shape[3] == 1  # one KV head a shard
    assert isinstance(port._paged_cache(port._take_carrier(4, 16, 32, paged=True).page_table, 0),
                      tgpt.TPCache)


async def _batched(batcher_cls, eng, prompts, want: int) -> list:
    b = batcher_cls(eng)
    await b.start()
    try:
        return await asyncio.gather(*[b.generate(p, want) for p in prompts])
    finally:
        await b.close()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tp_spec_matches_jax(layout):
    """A self-drafted target on the TP mesh: session and stream tokens
    equal JAX's TP spec engine's, and the drafts proposed and accepted
    equal JAX's; the drafter sits whole on the lead device. Paged, a
    `GenBatcher` over each engine serves concurrent requests the same
    text, and every page comes back."""
    jax_eng, port = _pair(draft=True, kv_layout=layout)
    prompts = ["the quick brown fox", "a much longer prompt", ""]
    for eng, cls in ((jax_eng, JaxGenBatcher), (port, GenBatcher)):
        eng.outputs = (sorted(_drain(eng.start_session(prompts, [20, 20, 20])).items()),
                       "".join(eng.generate_stream("stream through the mesh", 24)))
        if layout == "paged":
            eng.outputs += (asyncio.run(_batched(cls, eng, prompts, 12)),)
    assert port.outputs == jax_eng.outputs
    assert port._spec_proposed > 0
    assert (port._spec_proposed, port._spec_accepted) == (jax_eng._spec_proposed,
                                                          jax_eng._spec_accepted)
    assert not any(isinstance(x, Sharded) for x in tree_leaves(port._draft[0]))
    if layout == "paged":
        assert port.pool.pages_live == 0 == jax_eng.pool.pages_live


def test_tp_missing_drafter_decodes_plain():
    jax_eng, port = _pair(spec_draft_model="/no/such/drafter")
    assert port._draft is None
    assert port.generate_batch(["hello"], [8]) == jax_eng.generate_batch(["hello"], [8])


def _q_master(trainer, jax_side: bool) -> np.ndarray:
    q = trainer.state.params["layers"][0]["q"]["kernel"]
    return np.asarray(q) if jax_side else q.gather(CPU).detach().numpy()


def test_online_tp_trainer_matches_jax(tmp_path):
    """OnlineLmTrainer over each package's TP engine: two passes' losses
    within rtol 1e-4, the q master within atol 1e-6 / rtol 1e-4, the
    engine still TP-placed after the sync and its greedy tokens equal
    JAX's; the train state saved by either package loads in the other and
    the next pass's loss agrees."""
    jax_eng, port = _pair()
    jt, tt = JaxOnlineLmTrainer(jax_eng, seq_len=32, batch_size=4), \
        OnlineLmTrainer(port, seq_len=32, batch_size=4)
    q_spec = tt.state.params["layers"][0]["q"]["kernel"].spec
    assert q_spec == (None, "tensor")
    for _ in range(2):
        lj, lt = jt.train_on_texts(DOC)["loss"], tt.train_on_texts(DOC)["loss"]
        np.testing.assert_allclose(lt, lj, rtol=1e-4)
    np.testing.assert_allclose(_q_master(tt, False), _q_master(jt, True), atol=1e-6, rtol=1e-4)
    assert all(isinstance(x, Sharded) for x in tree_leaves(port.params))
    assert port.params["layers"][0]["q"]["kernel"].spec == q_spec
    prompts = ["the tensor axis", "two shards"]
    assert port.generate_batch(prompts, [10, 10]) == jax_eng.generate_batch(prompts, [10, 10])

    # port -> JAX and JAX -> port, then one more pass each
    tckpt.save_train_state(tmp_path / "port", tt.state, meta={"steps": 2})
    jckpt.save_train_state(tmp_path / "jax", jt.state, meta={"steps": 2})
    jax2, port2 = _pair()
    jt2 = JaxOnlineLmTrainer(jax2, seq_len=32, batch_size=4, state_path=str(tmp_path / "port"))
    tt2 = OnlineLmTrainer(port2, seq_len=32, batch_size=4, state_path=str(tmp_path / "jax"))
    assert jt2.stats["train_steps"] == tt2.stats["train_steps"] == 2
    np.testing.assert_allclose(_q_master(tt2, False), _q_master(jt, True), atol=1e-6, rtol=1e-4)
    assert isinstance(tt2.state.params["layers"][0]["q"]["kernel"], Sharded)
    # the token stream a pass carries over is not in the checkpoint: the
    # resumed trainers take the unbroken ones' leftovers
    jt2._stream, tt2._stream = list(jt._stream), list(tt._stream)
    want = jt.train_on_texts(DOC)["loss"]
    np.testing.assert_allclose(tt2.train_on_texts(DOC)["loss"], want, rtol=1e-4)
    np.testing.assert_allclose(jt2.train_on_texts(DOC)["loss"], want, rtol=1e-4)
