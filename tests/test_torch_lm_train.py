"""The port's LM fine-tune (`lm_loss`, `lm_train_step`,
`make_lm_train_state`) against the JAX package's, from one JAX param tree
carried across by the bridge and on the same seed-made batches, on the CPU.

A tiny GPT-2 (tied head) and a tiny llama with GQA (4 query heads over 2
KV heads), vocab 97, hidden 32, 2 layers, S = 16, with rows whose mask
ends early. With `attn_impl="flash"` the JAX side runs its Pallas forward
and fused backward kernels in interpret mode (GQA: its dense float32
recompute), the port the kernels' plain versions. The three-step parity
runs at float32 and at bfloat16, `LmConfig`'s default compute dtype (the
forward and backward in bf16 on float32 masters, on both sides). Bars at
float32: loss and grad norm at rtol 1e-4 over 3 steps; the first step's
gradients, the tied `wte` (a gather and the head) by name, within 1e-5 of
each leaf's largest |gradient| plus 1e-8 (the key bias's true gradient is
0: softmax ignores a shift per row, so both sides hold float noise of
~1e-11 there). At bfloat16 (8 significant bits, 2^-8 = 3.9e-3 a rounding,
and the two packages round their sums in other orders): loss and grad
norm at rtol 5e-3, the gradients within 3e-2 of each leaf's largest plus
4e-6 (the key bias's noise is ~1e-6 there). Also: the training forward (`gpt.forward(cache=None)`) equals a
forward over a fresh cache, `kv_quant="int8"` trains as "none", and a train
state written by either package resumes in the other (on disk, and a JAX
state in memory through `lm_train_state_from_numpy`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.train import checkpoint as jckpt
from symbiont_tpu.train import trainer as jtrain
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.train import checkpoint as tckpt
from symbiont_tpu_torch.train import trainer as ttrain

ARCHS = [("gpt2", None), ("llama", 2)]
B, S, LR, STEPS = 4, 16, 1e-3, 3


# compute dtype -> (loss and grad norm rtol, gradient bar: x leaf max, + atol)
BARS = {"float32": (1e-4, 1e-5, 1e-8), "bfloat16": (5e-3, 3e-2, 4e-6)}


def _cfgs(arch, nkv, impl="xla", kv_quant="none", dtype="float32"):
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=nkv,
              intermediate_size=64, max_position_embeddings=64, arch=arch, dtype=dtype,
              tie_word_embeddings=arch == "gpt2", attn_impl=impl, kv_quant=kv_quant)
    return jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)


def _tree(arch, nkv, seed=0):
    jcfg, _ = _cfgs(arch, nkv)
    return jax.tree.map(np.asarray, jgpt.init_params(jax.random.key(seed), jcfg))


def _batch(seed=0):
    """Token rows with two masks that end early (padding at the tail)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 97, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[2, 10:] = 0
    mask[3, 5:] = 0
    return ids, mask


def _jb(b):
    return {"ids": jnp.asarray(b[0]), "mask": jnp.asarray(b[1])}


def _tb(b):
    return {"ids": torch.from_numpy(b[0]).long(), "mask": torch.from_numpy(b[1])}


def _jax_steps(tree, jcfg, batches, state=None, tx=None):
    if state is None:
        state, tx = jtrain.make_lm_train_state(jax.tree.map(jnp.asarray, tree), LR)
    out = []
    for b in batches:
        state, m = jtrain.lm_train_step(state, _jb(b), jcfg, tx)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, tx, out


def _port_steps(state, tx, tcfg, batches):
    out = []
    for b in batches:
        state, m = ttrain.lm_train_step(state, _tb(b), tcfg, tx)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_three_steps_match_jax(arch, nkv, impl, dtype):
    jcfg, tcfg = _cfgs(arch, nkv, impl, dtype=dtype)
    rtol, rel, atol = BARS[dtype]
    tree = _tree(arch, nkv)
    batches = [_batch(seed) for seed in range(STEPS)]
    jgrads = jax.grad(jtrain.lm_loss)(jax.tree.map(jnp.asarray, tree), _jb(batches[0]), jcfg)
    _, _, want = _jax_steps(tree, jcfg, batches)

    state, tx = ttrain.make_lm_train_state(gpt_params_from_numpy(tree, "cpu"), LR)
    state, first = _port_steps(state, tx, tcfg, batches[:1])
    # the first step's gradients, kept in place until the next step zeroes them
    named = dict(zip(_paths(tree), ttrain.tree_leaves(state.params)))
    for path, jg in zip(_paths(tree), jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        np.testing.assert_allclose(named[path].grad.numpy(), jg, rtol=0,
                                   atol=rel * float(np.abs(jg).max()) + atol, err_msg=path)
    assert "wte" in named and ("lm_head.kernel" in named) == (arch != "gpt2")  # tied or not
    state, rest = _port_steps(state, tx, tcfg, batches[1:])
    np.testing.assert_allclose(np.asarray(first + rest), np.asarray(want), rtol=rtol)
    assert state.step == STEPS
    # one executable for the (B, S) shape, kept for the optimizer
    assert list(ttrain.step_executables(tx)) == [((B, S), tcfg)]


def _paths(tree, prefix=""):
    """Leaf paths in `jax.tree.leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_lm_loss_matches_jax_on_a_padded_mask(arch, nkv, impl):
    jcfg, tcfg = _cfgs(arch, nkv, impl)
    tree = _tree(arch, nkv, seed=1)
    b = _batch(5)
    want = float(jtrain.lm_loss(jax.tree.map(jnp.asarray, tree), _jb(b), jcfg))
    got = float(ttrain.lm_loss(gpt_params_from_numpy(tree, "cpu"), _tb(b), tcfg))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a fully masked batch divides by max(w.sum(), 1): zero, not nan
    zero = (b[0], np.zeros_like(b[1]))
    assert float(ttrain.lm_loss(gpt_params_from_numpy(tree, "cpu"), _tb(zero), tcfg)) == 0.0


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_training_forward_keeps_no_cache_and_equals_a_fresh_cache(arch, nkv, impl):
    _, tcfg = _cfgs(arch, nkv, impl)
    params = gpt_params_from_numpy(_tree(arch, nkv), "cpu")
    ids = torch.from_numpy(_batch()[0]).long()
    pos = torch.arange(S).expand(B, S)
    with torch.no_grad():
        got, cache = tgpt.forward(params, ids, None, pos, tcfg)
        want, _ = tgpt.forward(params, ids, tgpt.init_cache(tcfg, B, S, torch.float32), pos, tcfg)
    assert cache is None
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_kv_quant_int8_trains_as_none(arch, nkv):
    """JAX replaces kv_quant by "none" for the training forward; the port's
    keeps no cache at all: the same steps, bit for bit, and JAX's numbers."""
    tree = _tree(arch, nkv)
    batches = [_batch(seed) for seed in range(STEPS)]
    runs = {}
    for kvq in ("none", "int8"):
        _, tcfg = _cfgs(arch, nkv, kv_quant=kvq)
        state, tx = ttrain.make_lm_train_state(gpt_params_from_numpy(tree, "cpu"), LR)
        runs[kvq] = _port_steps(state, tx, tcfg, batches)[1]
    assert runs["int8"] == runs["none"]
    jcfg, _ = _cfgs(arch, nkv, kv_quant="int8")
    np.testing.assert_allclose(runs["int8"], _jax_steps(tree, jcfg, batches)[2], rtol=1e-4)


def _fresh_port_state(arch, nkv):
    """A port train state on other weights, to restore into."""
    return ttrain.make_lm_train_state(gpt_params_from_numpy(_tree(arch, nkv, seed=7), "cpu"),
                                      LR)


@pytest.mark.parametrize("route", ["jax_file", "port_file", "jax_memory"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_train_state_resumes_across_packages(arch, nkv, route, tmp_path):
    """One step, the state carried to the other package, one more step:
    its loss and grad norm those of the uninterrupted run (rtol 1e-4)."""
    jcfg, tcfg = _cfgs(arch, nkv)
    tree = _tree(arch, nkv)
    b0, b1 = _batch(0), _batch(1)
    jstate, jtx, _ = _jax_steps(tree, jcfg, [b0])
    if route == "jax_file":
        jckpt.save_train_state(tmp_path / "ts", jstate, meta={"by": "jax"})
        state, tx = _fresh_port_state(arch, nkv)
        state, meta = tckpt.load_train_state(tmp_path / "ts", state)
        assert meta == {"by": "jax"} and state.step == 1
        got = _port_steps(state, tx, tcfg, [b1])[1]
    elif route == "jax_memory":
        adam = jstate.opt_state[0]
        state, tx = tckpt.lm_train_state_from_numpy(
            jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu), int(adam.count), learning_rate=LR, device="cpu")
        assert state.step == 1
        got = _port_steps(state, tx, tcfg, [b1])[1]
    else:
        state, tx = ttrain.make_lm_train_state(gpt_params_from_numpy(tree, "cpu"), LR)
        state, _ = _port_steps(state, tx, tcfg, [b0])
        tckpt.save_train_state(tmp_path / "ts", state, meta={"by": "port"})
        template, ttx = jtrain.make_lm_train_state(
            jax.tree.map(jnp.asarray, _tree(arch, nkv, seed=7)), LR)
        restored, meta = jckpt.load_train_state(tmp_path / "ts", template)
        assert meta == {"by": "port"} and int(restored.step) == 1
        got = _jax_steps(tree, jcfg, [b1], restored, ttx)[2]
    want = _jax_steps(tree, jcfg, [b1], jstate, jtx)[2]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_masters_are_copies_and_the_gradients_stay_in_place():
    """The masters never share storage with the params they were made from
    (a float32 leaf is cloned too); every step writes the same gradient
    tensors, which a captured graph is bound to."""
    _, tcfg = _cfgs("gpt2", None)
    params = gpt_params_from_numpy(_tree("gpt2", None), "cpu")
    state, tx = ttrain.make_lm_train_state(params, LR)
    src = {t.data_ptr() for t in ttrain.tree_leaves(params)}
    masters = ttrain.tree_leaves(state.params)
    assert not src & {t.data_ptr() for t in masters}
    assert all(t.dtype == torch.float32 and t.requires_grad for t in masters)
    grads = [t.grad for t in masters]
    _port_steps(state, tx, tcfg, [_batch(0), _batch(1)])
    assert all(t.grad is g for t, g in zip(masters, grads))
