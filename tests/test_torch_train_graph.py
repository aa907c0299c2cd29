"""The encoder train step as an executable (`train/trainer.py`), on the CPU.

JAX jits `contrastive_train_step` with the state donated; the port keeps
one executable per (pairs, q bucket, p bucket, config) for the optimizer, a
CUDA graph on the card (forward, the backward's B2/B3, a capturable AdamW)
and the eager function here. Held to the JAX package on one param tree
carried across by the bridge (tests/test_torch_train.py's tiny float32
BERT): loss and grad norm over 3 steps at rtol 1e-4 for both attention
paths, with a checkpoint restore between steps; the executable's cache,
gradients kept and zeroed in place, a leaf without a gradient at zeros,
and an executable that survives a restore. The card holds graphed = eager
bit for bit in `chip_smoke.py`'s [train] lines."""

import weakref

import numpy as np
import pytest
import torch

from symbiont_tpu.models import bert as jbert
from symbiont_tpu.train import checkpoint as jckpt
from symbiont_tpu.train import trainer as jtrain
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.train import checkpoint as tckpt
from symbiont_tpu_torch.train import trainer as ttrain
from tests.test_torch_train import (GEOM, LR, _batch, _copy, _jax_batch, _np_tree,  # noqa: F401
                                    _torch_batch, jparams)

STEPS = 3


def _port_state(jparams):
    return ttrain.make_embedder_train_state(bert_params_from_numpy(_np_tree(jparams), "cpu"),
                                            learning_rate=LR)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_three_steps_with_a_restore_match_jax(impl, jparams, tmp_path):
    """Three steps of both packages from one tree; after the first, each
    package saves its state, and the port's steps go on from its file
    restored into the state the executable is bound to."""
    jcfg = jbert.BertConfig(**GEOM, attn_impl=impl)
    tcfg = tbert.BertConfig(**GEOM, attn_impl=impl)
    batches = [_batch(seed) for seed in range(STEPS)]
    state, tx = jtrain.make_embedder_train_state(_copy(jparams), learning_rate=LR)
    want = []
    for i, b in enumerate(batches):
        state, m = jtrain.contrastive_train_step(state, _jax_batch(b), jcfg, tx)
        want.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            jckpt.save_train_state(tmp_path / "jax", state)
    tstate, ttx = _port_state(jparams)
    got = []
    for i, b in enumerate(batches):
        tstate, m = ttrain.contrastive_train_step(tstate, _torch_batch(b), tcfg, ttx)
        got.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            exe = ttrain.step_executables(ttx)[((4, 16), (4, 16), tcfg)]
            tckpt.save_train_state(tmp_path / "port", tstate)
            for leaf in ttrain.tree_leaves(tstate.params):  # scribble, then restore
                with torch.no_grad():
                    leaf.add_(1.0)
            tstate, _ = tckpt.load_train_state(tmp_path / "port", tstate)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4)
    assert tstate.step == STEPS
    assert ttrain.step_executables(ttx) == {((4, 16), (4, 16), tcfg): exe}
    # the JAX package's file restores into the port's bound state too
    fresh, ftx = _port_state(jparams)
    fresh, _ = tckpt.load_train_state(tmp_path / "jax", fresh)
    for b, w in zip(batches[1:], want[1:]):
        fresh, m = ttrain.contrastive_train_step(fresh, _torch_batch(b), tcfg, ftx)
        np.testing.assert_allclose((float(m["loss"]), float(m["grad_norm"])), w, rtol=1e-4)


def test_gradients_stay_allocated_and_are_zeroed_in_place(jparams):
    """The executable writes the same gradient tensors every step (a graph
    is bound to them); a leaf the loss never reaches (the pooler) keeps
    zeros, as JAX gives an unused leaf."""
    tcfg = tbert.BertConfig(**GEOM)
    params = bert_params_from_numpy(_np_tree(jparams), "cpu")
    params["pooler"] = {"dense": {"kernel": torch.ones((GEOM["hidden_size"],) * 2)}}
    state, tx = ttrain.make_embedder_train_state(params, learning_rate=LR)
    leaves = ttrain.tree_leaves(state.params)
    grads = [p.grad for p in leaves]
    assert all(g is not None and not bool(g.any()) for g in grads)
    for seed in range(2):
        state, m = ttrain.contrastive_train_step(state, _torch_batch(_batch(seed)), tcfg, tx)
        assert all(p.grad is g for p, g in zip(leaves, grads))
    pooler = state.params["pooler"]["dense"]["kernel"]
    assert not bool(pooler.grad.any())
    assert float(m["grad_norm"]) > 0
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    assert torch.equal(norm, m["grad_norm"])  # the norm of what stayed in the gradients


def test_one_executable_per_batch_shape(jparams):
    """A new (pairs, q bucket, p bucket) builds an executable; a shape seen
    before reuses its own; the step counts keep counting on the host (the
    CPU's AdamW is not capturable)."""
    tcfg = tbert.BertConfig(**GEOM)
    state, tx = _port_state(jparams)
    assert not tx.defaults["capturable"]
    small = {k: v[:, :8] for k, v in _torch_batch(_batch()).items()}
    for b in (_torch_batch(_batch()), small, _torch_batch(_batch(1))):
        state, _ = ttrain.contrastive_train_step(state, b, tcfg, tx)
    assert set(ttrain.step_executables(tx)) == {((4, 16), (4, 16), tcfg),
                                                ((4, 8), (4, 8), tcfg)}
    leaf = ttrain.tree_leaves(state.params)[0]
    assert tx.state[leaf]["step"].device.type == "cpu" and float(tx.state[leaf]["step"]) == 3.0


def test_step_executables_go_with_their_optimizer(jparams):
    """The executables are kept for their optimizer, not on it, and are
    freed with it: the state the steps returned does not hold it."""
    tcfg = tbert.BertConfig(**GEOM)
    held = len(ttrain._STEPS)
    state, tx = _port_state(jparams)
    state, _ = ttrain.contrastive_train_step(state, _torch_batch(_batch()), tcfg, tx)
    assert len(ttrain.step_executables(tx)) == 1 and len(ttrain._STEPS) == held + 1
    ref = weakref.ref(tx)
    del tx
    assert ref() is None and len(ttrain._STEPS) == held
