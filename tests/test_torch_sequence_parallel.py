"""The port's sequence parallelism (`symbiont_tpu_torch/parallel/`
`ring_attention`, `ulysses`, `context`) on an 8-entry CPU mesh, held to
the JAX package's on its 8 virtual CPU devices.

The sequence-parallel cases of `tests/test_parallel.py` (ring and Ulysses
attention against full attention, GQA, a long sequence, the refusals, the
sequence-parallel forward against the cache forward with both schemes,
the sequence-parallel train step against the plain one), each run on the
port and on JAX's function with the same numpy inputs, at JAX's
tolerances: attention atol 1e-5 / rtol 1e-4, forward 2e-4 / 1e-3, loss
1e-5, updated params 1e-4 / 1e-3. Then what the JAX file lacks: ring and
Ulysses gradients of q, k and v against dense attention's,
`block_nocache` with dense causal attention against `gpt.forward`, and
the sequence-parallel steps against the port's plain `lm_train_step`
over two steps. JAX's sharded calls are jitted (the same functions; an
unjitted `shard_map` runs op by op).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.parallel import build_mesh as jax_build_mesh
from symbiont_tpu.parallel import context as jcontext
from symbiont_tpu.parallel import pipeline as jpipeline
from symbiont_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring
from symbiont_tpu.parallel.ulysses import ulysses_attention_sharded as jax_ulysses
from symbiont_tpu.train import trainer as jtrain
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.parallel import (
    build_mesh,
    gpt_forward_sp,
    lm_loss_sp,
    make_lm_train_step_sp,
    ring_attention_sharded,
    ulysses_attention_sharded,
)
from symbiont_tpu_torch.parallel.pipeline import _block_dense
from symbiont_tpu_torch.parallel.ulysses import _full_attention
from symbiont_tpu_torch.train import trainer

CPU = torch.device("cpu")
ATTN = dict(atol=1e-5, rtol=1e-4)
FWD = dict(atol=2e-4, rtol=1e-3)


def _mesh(n=8):
    return build_mesh([n, 1], devices=[CPU] * n)


def _jmesh(n=8):
    return jax_build_mesh([n, 1], devices=jax.devices()[:n])


def _qkv(seed, B, S, NH, D, KVH=None):
    rng = np.random.default_rng(seed)
    KVH = KVH or NH
    return (rng.normal(size=(B, S, NH, D)).astype(np.float32),
            rng.normal(size=(B, S, KVH, D)).astype(np.float32),
            rng.normal(size=(B, S, KVH, D)).astype(np.float32))


def _jax_attn(fn, q, k, v, causal, n=8):
    mesh = _jmesh(n)
    run = jax.jit(lambda a, b, c: fn(a, b, c, mesh, axis_name="data", causal=causal))
    return np.asarray(run(*map(jnp.asarray, (q, k, v))))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(causal):
    q, k, v = _qkv(2, 2, 64, 4, 16)  # S = 8 entries x 8 local
    out = ring_attention_sharded(*_t(q, k, v), _mesh(), axis_name="data", causal=causal)
    np.testing.assert_allclose(out.numpy(), _full_attention(*_t(q, k, v), causal).numpy(),
                               **ATTN)
    np.testing.assert_allclose(out.numpy(), _jax_attn(jax_ring, q, k, v, causal), **ATTN)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_full(causal):
    q, k, v = _qkv(4, 2, 64, 8, 16)  # NH = 8 entries x 1 head each
    out = ulysses_attention_sharded(*_t(q, k, v), _mesh(), axis_name="data", causal=causal)
    np.testing.assert_allclose(out.numpy(), _full_attention(*_t(q, k, v), causal).numpy(),
                               **ATTN)
    np.testing.assert_allclose(out.numpy(), _jax_attn(jax_ulysses, q, k, v, causal), **ATTN)
    # and it agrees with the ring scheme on the same blocks
    ring = ring_attention_sharded(*_t(q, k, v), _mesh(), axis_name="data", causal=causal)
    np.testing.assert_allclose(out.numpy(), ring.numpy(), **ATTN)


def test_ulysses_rejects_indivisible_heads():
    q = np.random.default_rng(5).normal(size=(1, 16, 6, 8)).astype(np.float32)  # 6 % 8
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention_sharded(*_t(q, q, q), _mesh())
    with pytest.raises(ValueError, match="not divisible"):
        jax_ulysses(*map(jnp.asarray, (q, q, q)), _jmesh())


def test_ring_attention_long_sequence_memory_shape():
    """A sequence 8x an entry's block (the long-context claim)."""
    q, k, v = _qkv(3, 1, 256, 2, 8)
    out = ring_attention_sharded(*_t(q, k, v), _mesh(), causal=True)
    assert out.shape == (1, 256, 2, 8)
    np.testing.assert_allclose(out.numpy(), _full_attention(*_t(q, k, v), True).numpy(), **ATTN)
    np.testing.assert_allclose(out.numpy(), _jax_attn(jax_ring, q, k, v, True), **ATTN)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gqa_matches_full(causal):
    """GQA ring: K/V rotate at kv_heads width and expand only locally."""
    q, k, v = _qkv(8, 2, 64, 8, 16, KVH=2)
    out = ring_attention_sharded(*_t(q, k, v), _mesh(), axis_name="data", causal=causal)
    kx, vx = (torch.from_numpy(a).repeat_interleave(4, dim=2) for a in (k, v))
    np.testing.assert_allclose(out.numpy(),
                               _full_attention(torch.from_numpy(q), kx, vx, causal).numpy(), **ATTN)
    np.testing.assert_allclose(out.numpy(), _jax_attn(jax_ring, q, k, v, causal), **ATTN)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_gradients_match_dense(impl, causal):
    """The gradients of q, k and v through either scheme (the ring's
    copies between entries, Ulysses' two all-to-alls and the flash
    backward's plain version) equal dense attention's, GQA included:
    compact K/V for the ring, K/V expanded first for Ulysses as the
    sequence-parallel block expands them."""
    q, k, v = _qkv(9, 2, 32, 8, 16, KVH=2)
    g = torch.from_numpy(np.random.default_rng(10).normal(size=q.shape).astype(np.float32))

    def grads(attn):
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        (attn(*leaves) * g).sum().backward()
        return [t.grad.numpy() for t in leaves]

    def expand(qq, kk, vv):
        return qq, kk.repeat_interleave(4, dim=2), vv.repeat_interleave(4, dim=2)

    want = grads(lambda *t: _full_attention(*expand(*t), causal))
    if impl == "ring":
        got = grads(lambda *t: ring_attention_sharded(*t, _mesh(), causal=causal))
    else:
        got = grads(lambda *t: ulysses_attention_sharded(*expand(*t), _mesh(), causal=causal))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **ATTN)


# ------------------------------------------------------- sequence-parallel LM


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
    """A JAX GPT config and params, and the port's twins on the CPU."""
    jcfg = jgpt.GPTConfig(vocab_size=64, intermediate_size=64, max_position_embeddings=64,
                          dtype="float32", **kw)
    tree = _numpy_tree(jcfg, seed)
    return jcfg, tree, tgpt.GPTConfig(**dataclasses.asdict(jcfg)), gpt_params_from_numpy(tree,
                                                                                         "cpu")


def _forward_ref(params, ids, cfg):
    B, S = ids.shape
    return tgpt.forward(params, ids, None, torch.arange(S).expand(B, S), cfg)[0]


def _check_sp_forward(seed, ids_seed, attn_impl, **kw):
    jcfg, tree, cfg, params = _gpt(seed, **kw)
    ids = np.random.default_rng(ids_seed).integers(0, 64, size=(2, 32)).astype(np.int32)
    out = gpt_forward_sp(params, torch.from_numpy(ids), _mesh(), cfg, axis="data",
                         attn_impl=attn_impl)
    assert out.shape == (2, 32, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _forward_ref(params, torch.from_numpy(ids),
                                                         cfg).numpy(), **FWD)
    jmesh = _jmesh()
    jout = jax.jit(lambda p, i: jcontext.gpt_forward_sp(p, i, jmesh, jcfg, axis="data",
                                                        attn_impl=attn_impl))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)


@pytest.mark.parametrize("arch,num_kv", [("gpt2", None), ("llama", 2)])
def test_sp_forward_matches_cache_forward(arch, num_kv):
    """The sequence-split forward (8 entries, ring) equals the one-device
    forward, GQA and RoPE at global positions included, and JAX's."""
    _check_sp_forward(2, 6, "ring", hidden_size=32, num_layers=2, num_heads=4,
                      num_kv_heads=num_kv, arch=arch)


def test_sp_forward_rejects_indivisible_sequence():
    _, tree, cfg, params = _gpt(0, hidden_size=32, num_layers=1, num_heads=4)
    with pytest.raises(ValueError, match="not divisible"):
        gpt_forward_sp(params, torch.zeros((1, 30), dtype=torch.long), _mesh(), cfg)
    with pytest.raises(ValueError, match="not divisible"):
        jcontext.gpt_forward_sp(jax.tree.map(jnp.asarray, tree), jnp.zeros((1, 30), jnp.int32),
                                _jmesh(), jgpt.GPTConfig(**dataclasses.asdict(cfg)))


def test_sp_forward_ulysses_matches_cache_forward():
    _check_sp_forward(4, 9, "ulysses", hidden_size=32, num_layers=2, num_heads=8, arch="gpt2")


def test_sp_forward_ulysses_gqa_matches_cache_forward():
    """Ulysses with GQA: the K/V expansion before the all-to-all maps the
    query heads to their KV groups."""
    _check_sp_forward(5, 10, "ulysses", hidden_size=64, num_layers=2, num_heads=8,
                      num_kv_heads=2, arch="llama")


def _batch(seed, B, S):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(1, 64, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) < 0.9).astype(np.int32)}


@pytest.mark.parametrize("attn_impl,n", [("ring", 8), ("ulysses", 4)])
def test_sp_train_step_matches_unsharded(attn_impl, n):
    """One sequence-parallel step == one plain step: same loss, same
    updated params (long-context training is exact), on the port, and
    the port's step == JAX's. Ulysses splits the 4 heads over 4 entries."""
    jcfg, tree, cfg, params = _gpt(3, hidden_size=32, num_layers=2, num_heads=4,
                                   num_kv_heads=2, arch="llama")
    nb = _batch(7, 2, 32)
    batch = {k: torch.from_numpy(a) for k, a in nb.items()}
    ref, tx_ref = trainer.make_lm_train_state(params, learning_rate=1e-3)
    ref, m_ref = trainer.lm_train_step(ref, batch, cfg, tx_ref)
    state, tx = trainer.make_lm_train_state(params, learning_rate=1e-3)
    state, m = make_lm_train_step_sp(_mesh(n), cfg, tx, axis="data",
                                     attn_impl=attn_impl)(state, batch)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-4)
    leaves = [t.detach().numpy() for t in trainer.tree_leaves(state.params)]
    for a, b in zip(trainer.tree_leaves(ref.params), leaves, strict=True):
        np.testing.assert_allclose(b, a.detach().numpy(), atol=1e-4, rtol=1e-3)

    jstate, jtx = jtrain.make_lm_train_state(jax.tree.map(jnp.asarray, tree), learning_rate=1e-3)
    jstep = jcontext.make_lm_train_step_sp(_jmesh(n), jcfg, jtx, axis="data",
                                           attn_impl=attn_impl)
    jstate, jm = jstep(jstate, {k: jnp.asarray(a) for k, a in nb.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jstate.params), leaves, strict=True):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_sp_steps_equal_the_plain_step(attn_impl):
    """Two sequence-parallel steps of a GPT-2 with `attn_impl="flash"` (the
    plain step's attention is the flash path's plain version here, and
    Ulysses' inner attention too) against two plain `lm_train_step`s:
    loss, grad norm and every master after each; the loss over the split
    forward equals `lm_loss` on the updated params."""
    _, _, cfg, params = _gpt(11, hidden_size=32, num_layers=2, num_heads=4, arch="gpt2")
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    batch = {k: torch.from_numpy(a) for k, a in _batch(12, 2, 32).items()}
    batch["mask"][1, 20:] = 0
    ref, tx_ref = trainer.make_lm_train_state(params)
    state, tx = trainer.make_lm_train_state(params)
    step = make_lm_train_step_sp(_mesh(4), cfg, tx, attn_impl=attn_impl)
    for _ in range(2):
        ref, m_ref = trainer.lm_train_step(ref, batch, cfg, tx_ref)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-4)
        for a, b in zip(trainer.tree_leaves(ref.params), trainer.tree_leaves(state.params)):
            torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-3)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(lm_loss_sp(state.params, batch, cfg, _mesh(4), attn_impl=attn_impl)),
            float(trainer.lm_loss(state.params, batch, cfg)), rtol=1e-5)


@pytest.mark.parametrize("arch,num_kv", [("gpt2", None), ("llama", 2)])
def test_block_nocache_with_dense_attention_equals_forward(arch, num_kv):
    """`gpt.block_nocache` + `gpt.qkv_proj` with dense causal attention
    (the pipeline stage's block) layer by layer, then the final norm and
    head, give `gpt.forward(cache=None)`'s logits; and one such block
    equals JAX's `_block_dense` on the same params."""
    jcfg, tree, cfg, params = _gpt(13, hidden_size=32, num_layers=2, num_heads=4,
                                   num_kv_heads=num_kv, arch=arch)
    ids = torch.from_numpy(np.random.default_rng(14).integers(0, 64, (2, 16)))
    pos = torch.arange(16).expand(2, 16)
    x = tgpt._embed(params, ids, pos, cfg, torch.float32)
    x0 = x
    for layer in params["layers"]:
        x = _block_dense(layer, x, pos, cfg)
    np.testing.assert_allclose(tgpt._logits(params, x, cfg).numpy(),
                               _forward_ref(params, ids, cfg).numpy(), **FWD)
    jx = jax.jit(lambda lp, xx, pp: jpipeline._block_dense(lp, xx, pp, jcfg))(
        jax.tree.map(jnp.asarray, tree["layers"][0]), jnp.asarray(x0.numpy()),
        jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(_block_dense(params["layers"][0], x0, pos, cfg).numpy(),
                               np.asarray(jx), **FWD)
