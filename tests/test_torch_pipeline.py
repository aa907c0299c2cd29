"""The port's pipeline parallelism (`symbiont_tpu_torch/parallel/pipeline.py`)
on CPU meshes over a `pipe` axis, held to the JAX package's on its
virtual CPU devices.

The pipeline cases of `tests/test_parallel.py` (the pipelined loss
against the plain loss for both archs, one pipelined train step against
the plain step, the refusals), each run on the port and on JAX's function
with the same numpy inputs, at JAX's tolerances (loss 1e-5, updated params
1e-4 / 1e-3). Then: `stack_layers` against JAX's and back, a loss
independent of the microbatch count, and two pipelined steps against the
port's plain `lm_train_step` with the layer stack still split over
`pipe` and every replica equal to its master.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.parallel import build_mesh as jax_build_mesh
from symbiont_tpu.parallel import pipeline as jpipeline
from symbiont_tpu.train import trainer as jtrain
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.parallel import (
    Sharded,
    build_mesh,
    lm_loss_pp,
    make_lm_train_step_pp,
    make_pp_train_state,
    shard_pp_params,
    stack_layers,
)
from symbiont_tpu_torch.parallel.pipeline import layer_of
from symbiont_tpu_torch.train import trainer

CPU = torch.device("cpu")


def _mesh(n):
    return build_mesh([n], axis_names=("pipe",), devices=[CPU] * n)


def _jmesh(n):
    return jax_build_mesh([n], axis_names=("pipe",), devices=jax.devices()[:n])


def _numpy_tree(jcfg, seed):
    """JAX's GPT tree for jcfg (the layout of `init_params`, traced, not
    run op by op), its leaves drawn from a numpy seed: N(0, 0.02), norm
    scales about 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        x = rng.normal(0.0, 0.02, leaf.shape).astype(np.float32)
        return x + 1.0 if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(lambda: jgpt.init_params(jax.random.key(0), jcfg)))


def _gpt(seed, **kw):
    """A JAX GPT config and params (numpy), and the port's twins."""
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_heads=4, intermediate_size=64,
                          max_position_embeddings=32, dtype="float32", **kw)
    tree = _numpy_tree(jcfg, seed)
    return jcfg, tree, tgpt.GPTConfig(**dataclasses.asdict(jcfg)), gpt_params_from_numpy(tree,
                                                                                         "cpu")


def _batch(seed, B, S):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(1, 64, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) < 0.9).astype(np.int32)}


@pytest.mark.parametrize("arch,num_kv", [("llama", 2), ("gpt2", None)])
def test_pp_loss_matches_unsharded(arch, num_kv):
    """The pipelined loss (4 stages x 1 layer, 4 microbatches) == the plain
    loss on the same params and batch, and == JAX's pipelined loss."""
    jcfg, tree, cfg, params = _gpt(5, num_layers=4, num_kv_heads=num_kv, arch=arch,
                                   tie_word_embeddings=True)
    nb = _batch(11, 8, 16)
    batch = {k: torch.from_numpy(a) for k, a in nb.items()}
    ref = float(trainer.lm_loss(params, batch, cfg))
    got = float(lm_loss_pp(shard_pp_params(_mesh(4), stack_layers(params)), batch, cfg,
                           _mesh(4), num_microbatches=4))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    jmesh = _jmesh(4)
    jplaced = jpipeline.shard_pp_params(jmesh, jpipeline.stack_layers(
        jax.tree.map(jnp.asarray, tree)))
    jgot = jax.jit(lambda p, b: jpipeline.lm_loss_pp(p, b, jcfg, jmesh, num_microbatches=4))(
        jplaced, {k: jnp.asarray(a) for k, a in nb.items()})
    np.testing.assert_allclose(got, float(jgot), atol=1e-5, rtol=1e-5)


def test_pp_train_step_matches_unsharded():
    """One pipelined step (2 stages, 2 microbatches) == one plain step:
    same loss, same updated params, the stack still split over `pipe`;
    and == JAX's pipelined step."""
    jcfg, tree, cfg, params = _gpt(9, num_layers=2, num_kv_heads=2, arch="llama")
    nb = _batch(13, 4, 16)
    batch = {k: torch.from_numpy(a) for k, a in nb.items()}
    ref, tx_ref = trainer.make_lm_train_state(params, learning_rate=1e-3)
    ref, m_ref = trainer.lm_train_step(ref, batch, cfg, tx_ref)
    state, tx = make_pp_train_state(_mesh(2), params, learning_rate=1e-3)
    state, m = make_lm_train_step_pp(_mesh(2), cfg, tx, num_microbatches=2)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), atol=1e-5, rtol=1e-5)
    got = [t.gather().detach().numpy() for t in trainer.tree_leaves(state.params)]
    for a, b in zip(trainer.tree_leaves(stack_layers(ref.params)), got, strict=True):
        np.testing.assert_allclose(b, a.detach().numpy(), atol=1e-4, rtol=1e-3)
    leaf = trainer.tree_leaves(state.params["layers"])[0]
    assert isinstance(leaf, Sharded) and "pipe" in leaf.spec

    jstate, jtx = jpipeline.make_pp_train_state(_jmesh(2), jax.tree.map(jnp.asarray, tree),
                                                learning_rate=1e-3)
    jstate, jm = jpipeline.make_lm_train_step_pp(_jmesh(2), jcfg, jtx, num_microbatches=2)(
        jstate, {k: jnp.asarray(a) for k, a in nb.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jstate.params), got, strict=True):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=1e-3)


def test_pp_rejects_indivisible_shapes():
    _, tree, cfg, params = _gpt(0, num_layers=3, num_kv_heads=2, arch="llama")
    with pytest.raises(ValueError, match="not divisible by pipe"):
        shard_pp_params(_mesh(2), stack_layers(params))  # 3 layers, 2 stages
    with pytest.raises(ValueError, match="not divisible by pipe"):
        jpipeline.shard_pp_params(_jmesh(2), jpipeline.stack_layers(
            jax.tree.map(jnp.asarray, tree)))
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    placed = shard_pp_params(_mesh(2), stack_layers(
        tgpt.init_params(torch.Generator().manual_seed(0), cfg4)))
    batch = {"ids": torch.ones((3, 16), dtype=torch.long),
             "mask": torch.ones((3, 16), dtype=torch.int32)}
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        lm_loss_pp(placed, batch, cfg4, _mesh(2), num_microbatches=2)
    jcfg4 = jgpt.GPTConfig(**dataclasses.asdict(cfg4))
    jplaced = jpipeline.shard_pp_params(_jmesh(2), jpipeline.stack_layers(
        jax.tree.map(jnp.asarray, _numpy_tree(jcfg4, 0))))
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        jpipeline.lm_loss_pp(jplaced, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                             jcfg4, _jmesh(2), num_microbatches=2)


def test_stack_layers_round_trip_and_placement():
    """`stack_layers` gives JAX's stacked tree leaf for leaf; each layer
    comes back out of the stack as it went in; `shard_pp_params` gives
    each stage its contiguous depth and every entry its own copy of the
    replicated leaves."""
    _, tree, cfg, params = _gpt(1, num_layers=4, arch="gpt2")
    stacked = stack_layers(params)
    jstacked = jpipeline.stack_layers(jax.tree.map(jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(jstacked), trainer.tree_leaves(stacked), strict=True):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for j, layer in enumerate(params["layers"]):
        for a, b in zip(trainer.tree_leaves(layer),
                        trainer.tree_leaves(layer_of(stacked["layers"], j))):
            assert torch.equal(a, b)
    placed = shard_pp_params(_mesh(2), stacked)
    qk = placed["layers"]["q"]["kernel"]
    assert qk.spec == ("pipe",) and [tuple(t.shape) for t in qk.shards] == [(2, 32, 32)] * 2
    assert torch.equal(qk.shards[1], stacked["layers"]["q"]["kernel"][2:])
    wte = placed["wte"]
    assert wte.spec == () and wte.shards[0] is not wte.shards[1]
    assert all(torch.equal(t, params["wte"]) for t in wte.shards)


@pytest.mark.parametrize("arch,num_kv", [("gpt2", None), ("llama", 2)])
def test_microbatch_count_does_not_change_the_loss(arch, num_kv):
    """1 and 4 microbatches (and a whole, unplaced stack) give one loss:
    microbatching changes the schedule, not the math."""
    _, _, cfg, params = _gpt(3, num_layers=4, num_kv_heads=num_kv, arch=arch)
    batch = {k: torch.from_numpy(a) for k, a in _batch(4, 8, 16).items()}
    stacked = stack_layers(params)
    placed = shard_pp_params(_mesh(2), stacked)
    one = float(lm_loss_pp(placed, batch, cfg, _mesh(2), num_microbatches=1))
    four = float(lm_loss_pp(placed, batch, cfg, _mesh(2), num_microbatches=4))
    whole = float(lm_loss_pp(stacked, batch, cfg, _mesh(2), num_microbatches=4))
    np.testing.assert_allclose(four, one, rtol=1e-6)
    assert whole == four


def test_pp_steps_equal_the_plain_step(monkeypatch):
    """Two pipelined GPT-2 steps (4 stages, 4 microbatches, `attn_impl=
    "flash"`) against two plain `lm_train_step`s: loss, grad norm and every
    master after each, and every replica of a replicated leaf equal to its
    master after the update. The stages take the flash branch the card
    takes (`flash_attention`, its plain version on the CPU): one call a
    layer and microbatch."""
    _, _, cfg, params = _gpt(15, num_layers=4, arch="gpt2")
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    batch = {k: torch.from_numpy(a) for k, a in _batch(16, 8, 16).items()}
    batch["mask"][3, 9:] = 0
    ref, tx_ref = trainer.make_lm_train_state(params)
    state, tx = make_pp_train_state(_mesh(4), params)
    step = make_lm_train_step_pp(_mesh(4), cfg, tx, num_microbatches=4)
    calls = []
    flash = tgpt.flash_attention
    monkeypatch.setattr(tgpt, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    for _ in range(2):
        ref, m_ref = trainer.lm_train_step(ref, batch, cfg, tx_ref)
        calls.clear()
        state, m = step(state, batch)
        assert len(calls) == 4 * 4
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-4)
        for a, b in zip(trainer.tree_leaves(stack_layers(ref.params)),
                        trainer.tree_leaves(state.params), strict=True):
            torch.testing.assert_close(b.gather(), a.detach(), atol=1e-4, rtol=1e-3)
    assert state.step == 2 and len(trainer.masters(state.params)) == len(tx.state)
    for leaf in trainer.tree_leaves(state.params):
        assert all(torch.equal(t, leaf.home(i)) for i, t in enumerate(leaf.shards))
