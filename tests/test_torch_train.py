"""The port's encoder fine-tune (`contrastive_train_step`) against the JAX
package's, from the same bridged params and on the same batch, for both
attention paths; and the port's checkpoints against the JAX format.

A tiny float32 BERT (hidden 64, 2 layers, 4 heads, vocab 128, S = 16)
keeps the JAX flash path (its Pallas forward and fused backward kernels
in interpret mode) to seconds. With `attn_impl="flash"` the port's
gradients come through its autograd Function and the plain versions of
the backward kernels (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import bert as jbert
from symbiont_tpu.train import checkpoint as jckpt
from symbiont_tpu.train import trainer as jtrain
from symbiont_tpu_torch.models import bert as tbert
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.ops import flash_attention as fa
from symbiont_tpu_torch.train import checkpoint as tckpt
from symbiont_tpu_torch.train import trainer as ttrain

GEOM = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=32, dtype="float32")
B, S, LR, STEPS = 4, 16, 1e-3, 3
# Adam turns a noise-level gradient into a ±lr update. The key bias has a
# true gradient of 0 (softmax ignores a shift per row), so its leaves can
# differ by up to 2·lr per step between two exact implementations.
KEY_BIAS_ATOL = 2 * LR * STEPS
PARAM_TOL = dict(atol=1e-5, rtol=1e-3)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "p"):
        lengths = rng.integers(4, S + 1, B)
        lengths[0] = S
        out[f"{side}_ids"] = rng.integers(3, GEOM["vocab_size"], (B, S)).astype(np.int32)
        out[f"{side}_mask"] = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def jparams():
    return jbert.init_params(jax.random.key(0), jbert.BertConfig(**GEOM))


def _copy(tree):
    """A fresh copy: the JAX step donates its state's buffers."""
    return jax.tree.map(jnp.array, tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """(path, leaf) pairs in jax.tree.leaves order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.fixture(scope="module", params=["xla", "flash"])
def runs(request, jparams):
    """Both packages, STEPS steps from the same params on the same batch."""
    impl = request.param
    jcfg = jbert.BertConfig(**GEOM, attn_impl=impl)
    tcfg = tbert.BertConfig(**GEOM, attn_impl=impl)
    batch = _batch()
    jgrads = jax.grad(jtrain.contrastive_loss)(jparams, _jax_batch(batch), jcfg)
    state, tx = jtrain.make_embedder_train_state(_copy(jparams), learning_rate=LR)
    jm = []
    for _ in range(STEPS):
        state, m = jtrain.contrastive_train_step(state, _jax_batch(batch), jcfg, tx)
        jm.append((float(m["loss"]), float(m["grad_norm"])))
    tstate, ttx = ttrain.make_embedder_train_state(
        bert_params_from_numpy(_np_tree(jparams), "cpu"), learning_rate=LR)
    tm, tgrads = [], None
    for i in range(STEPS):
        tstate, m = ttrain.contrastive_train_step(tstate, _torch_batch(batch), tcfg, ttx)
        tm.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            tgrads = [p.grad.clone() for p in ttrain.tree_leaves(tstate.params)]
    return dict(impl=impl, jm=jm, tm=tm, jgrads=jgrads, tgrads=tgrads,
                jstate=state, tstate=tstate)


def test_loss_and_grad_norm_per_step_match(runs):
    np.testing.assert_allclose(np.asarray(runs["tm"]), np.asarray(runs["jm"]), rtol=1e-4)


def test_step1_gradients_match_per_leaf(runs):
    want = _paths(_np_tree(runs["jgrads"]))
    assert len(want) == len(runs["tgrads"])
    for (path, w), g in zip(want, runs["tgrads"]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-3, err_msg=path)


def test_params_after_steps_match(runs):
    want = _paths(_np_tree(runs["jstate"].params))
    got = ttrain.tree_leaves(runs["tstate"].params)
    assert runs["tstate"].step == int(runs["jstate"].step) == STEPS
    for (path, w), g in zip(want, got):
        if path.endswith("attention/key/bias"):
            np.testing.assert_allclose(g.detach().numpy(), w, atol=KEY_BIAS_ATOL,
                                       rtol=0, err_msg=path)
        else:
            np.testing.assert_allclose(g.detach().numpy(), w, err_msg=path, **PARAM_TOL)


def test_flash_step_goes_through_the_function(jparams):
    tcfg = tbert.BertConfig(**GEOM, attn_impl="flash")
    params = bert_params_from_numpy(_np_tree(jparams), "cpu")
    state, _ = ttrain.make_embedder_train_state(params)
    loss = ttrain.contrastive_loss(state.params, _torch_batch(_batch()), tcfg)
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo.extend(n for n, _ in node.next_functions)
    names = [type(n).__name__ for n in seen]
    # two encoder passes (queries, passages) x 2 layers
    assert names.count("_FlashAttentionBackward") == 2 * GEOM["num_layers"]


def test_loss_falls_over_eight_steps():
    cfg = tbert.BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                           intermediate_size=32, max_position_embeddings=32,
                           dtype="float32")
    params = tbert.init_params(torch.Generator().manual_seed(0), cfg)
    state, tx = ttrain.make_embedder_train_state(params, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    batch = {"q_ids": torch.from_numpy(rng.integers(3, 64, (8, 10))),
             "q_mask": torch.ones((8, 10), dtype=torch.int32),
             "p_ids": torch.from_numpy(rng.integers(3, 64, (8, 10))),
             "p_mask": torch.ones((8, 10), dtype=torch.int32)}
    losses = []
    for _ in range(8):
        state, m = ttrain.contrastive_train_step(state, batch, cfg, tx)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all() and state.step == 8
    # the masters are copies: the caller's params are not touched
    assert torch.equal(params["layers"][0]["mlp"]["in"]["kernel"],
                       tbert.init_params(torch.Generator().manual_seed(0), cfg)
                       ["layers"][0]["mlp"]["in"]["kernel"])


def test_bridged_jax_state_after_k_steps_continues_like_jax(jparams):
    """Start the port from a JAX train state taken after 2 steps (params,
    Adam moments and count), then take one more step in each package."""
    jcfg, tcfg = jbert.BertConfig(**GEOM), tbert.BertConfig(**GEOM)
    batch = _batch(1)
    state, tx = jtrain.make_embedder_train_state(_copy(jparams), learning_rate=LR)
    for _ in range(2):
        state, _ = jtrain.contrastive_train_step(state, _jax_batch(batch), jcfg, tx)
    adam = state.opt_state[0]
    tstate, ttx = tckpt.embedder_train_state_from_numpy(
        _np_tree(state.params), _np_tree(adam.mu), _np_tree(adam.nu),
        int(adam.count), learning_rate=LR, device="cpu")
    assert tstate.step == 2
    state, jm = jtrain.contrastive_train_step(state, _jax_batch(batch), jcfg, tx)
    tstate, tm = ttrain.contrastive_train_step(tstate, _torch_batch(batch), tcfg, ttx)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    mu = _paths(_np_tree(state.opt_state[0].mu))
    for (path, w), p in zip(mu, ttrain.tree_leaves(tstate.params)):
        np.testing.assert_allclose(ttx.state[p]["exp_avg"].numpy(), w, atol=1e-6,
                                   rtol=1e-3, err_msg=path)
        assert float(ttx.state[p]["step"]) == 3.0


@pytest.mark.parametrize("entry", ["params", "train_state"])
def test_bridge_defaults_to_the_card(monkeypatch, entry):
    """Without device="cpu" the bridge places on CUDA, and raises where
    there is none rather than training on the CPU behind the caller."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "params":
            bert_params_from_numpy(tree)
        else:
            tckpt.embedder_train_state_from_numpy(tree, tree, tree, 1)


# ------------------------------------------------------------ checkpoints


def _tiny_state(seed=0):
    cfg = tbert.BertConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
                           intermediate_size=32, max_position_embeddings=16,
                           dtype="float32")
    params = tbert.init_params(torch.Generator().manual_seed(seed), cfg)
    state, tx = ttrain.make_embedder_train_state(params, learning_rate=1e-3)
    rng = np.random.default_rng(seed)
    batch = {"q_ids": torch.from_numpy(rng.integers(3, 32, (4, 8))),
             "q_mask": torch.ones((4, 8), dtype=torch.int32),
             "p_ids": torch.from_numpy(rng.integers(3, 32, (4, 8))),
             "p_mask": torch.ones((4, 8), dtype=torch.int32)}
    return cfg, state, tx, batch


def test_train_state_save_restore_resumes_exactly(tmp_path):
    cfg, state, tx, batch = _tiny_state()
    for _ in range(2):
        state, _ = ttrain.contrastive_train_step(state, batch, cfg, tx)
    tckpt.save_train_state(tmp_path / "ck", state, meta={"note": "two steps"})
    assert tckpt.train_state_exists(tmp_path / "ck")
    for _ in range(2):
        state, m_a = ttrain.contrastive_train_step(state, batch, cfg, tx)

    _, fresh, ftx, _ = _tiny_state(seed=5)  # other values, same geometry
    fresh, meta = tckpt.load_train_state(tmp_path / "ck", fresh)
    assert meta == {"note": "two steps"} and fresh.step == 2
    for _ in range(2):
        fresh, m_b = ttrain.contrastive_train_step(fresh, batch, cfg, ftx)
    assert fresh.step == state.step == 4
    assert float(m_a["loss"]) == float(m_b["loss"])
    for a, b in zip(ttrain.tree_leaves(state.params), ttrain.tree_leaves(fresh.params)):
        assert torch.equal(a, b)
        assert torch.equal(tx.state[a]["exp_avg_sq"], ftx.state[b]["exp_avg_sq"])


def test_jax_train_state_checkpoint_loads_in_the_port(tmp_path, jparams):
    jstate, jtx = jtrain.make_embedder_train_state(_copy(jparams), learning_rate=LR)
    jstate, _ = jtrain.contrastive_train_step(jstate, _jax_batch(_batch()),
                                              jbert.BertConfig(**GEOM), jtx)
    jckpt.save_train_state(tmp_path / "j", jstate)
    template, ttx = ttrain.make_embedder_train_state(
        bert_params_from_numpy(_np_tree(jparams), "cpu"))
    got, _ = tckpt.load_train_state(tmp_path / "j", template)
    assert got.step == 1
    want = _paths(_np_tree(jstate.opt_state[0].nu))
    for (path, w), p in zip(want, ttrain.tree_leaves(got.params)):
        np.testing.assert_array_equal(ttx.state[p]["exp_avg_sq"].numpy(), w, err_msg=path)
        assert float(ttx.state[p]["step"]) == 1.0
    # and back: the port's file restores into a JAX template
    tckpt.save_train_state(tmp_path / "t", got)
    back, _ = jckpt.load_train_state(tmp_path / "t", jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_params_checkpoint_crosses_packages(tmp_path, jparams, writer):
    np_params = _np_tree(jparams)
    if writer == "jax":
        jckpt.save_params(tmp_path / "p", jparams, meta={"from": "jax"})
        assert tckpt.exists(tmp_path / "p")
        loaded, meta = tckpt.load_params(tmp_path / "p")
    else:
        tckpt.save_params(tmp_path / "p", bert_params_from_numpy(np_params, "cpu"),
                          meta={"from": "port"})
        assert jckpt.exists(tmp_path / "p")
        loaded, meta = jckpt.load_params(tmp_path / "p")
    assert meta == {"from": writer}
    want, got = _paths(np_params), _paths(jax.tree.map(np.asarray, loaded))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_train_state_mismatch_raises(tmp_path):
    cfg, state, tx, batch = _tiny_state()
    tckpt.save_train_state(tmp_path / "ck", state)
    deeper = dataclasses.replace(cfg, num_layers=2)
    t2, _ = ttrain.make_embedder_train_state(
        tbert.init_params(torch.Generator().manual_seed(0), deeper))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_train_state(tmp_path / "ck", t2)
    wider = dataclasses.replace(cfg, intermediate_size=48)
    t3, _ = ttrain.make_embedder_train_state(
        tbert.init_params(torch.Generator().manual_seed(0), wider))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_train_state(tmp_path / "ck", t3)


def test_global_norm_and_leaf_order():
    tree = {"b": [torch.tensor([3.0])], "a": {"y": torch.tensor([4.0]), "x": torch.zeros(2)}}
    assert [t.shape for t in ttrain.tree_leaves(tree)] == [(2,), (1,), (1,)]
    assert float(ttrain.global_norm(ttrain.tree_leaves(tree))) == 5.0
    assert fa.bwd_kv_launches == 0 and fa.bwd_q_launches == 0  # CPU never counts
