"""The LM's prefill executables (`LmEngine._prefill`), on the CPU.

JAX jits `prefill` per (B, P, max_new); the port keeps one executable per
(model, kv_quant, rows, prompt bucket, new bucket) that writes a cache of
its own, a CUDA graph on the card and the eager function here. Held to the
JAX package on one param tree carried across by the bridge, at f32: the
logits, `kv_valid`, `prompt_len` and the cache at its real positions
(atol 2e-5 / rtol 1e-4), dense and int8 KV, rows 1/2/4, two buckets,
target and drafter; what each caller takes of the executable's cache (a
carrier's prompt slots, a clone, a paged scatter); the cache of
executables; `prefill_warm` over a sequence of admissions against JAX's.
The card holds graphed = eager bit for bit in `chip_smoke.py`'s [graphs]
prefill lines, whose CPU rehearsal is the last test here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from symbiont_tpu.config import LmConfig as JaxLmConfig
from symbiont_tpu.engine.lm import LmEngine as JaxLmEngine
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.engine.lm import LmEngine
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from test_torch_chip_smoke import TINY_LM_KW, tiny_dirs  # noqa: F401 (a fixture)

F32 = dict(atol=2e-5, rtol=1e-4)
BUCKETS, NEW = [8, 16], 16


def _cfgs(kv_quant="none", layers=2, hidden=32):
    kw = dict(vocab_size=257, hidden_size=hidden, num_layers=layers, num_heads=4,
              num_kv_heads=2, intermediate_size=2 * hidden, max_position_embeddings=64,
              arch="llama", dtype="float32", tie_word_embeddings=False, kv_quant=kv_quant)
    return jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)


def _tree(seed, layers=2, hidden=32):
    jcfg, _ = _cfgs(layers=layers, hidden=hidden)
    return jax.tree.map(lambda a: np.asarray(a) * (8 if np.ndim(a) >= 2 else 1),
                        jgpt.init_params(jax.random.key(seed), jcfg))


@pytest.fixture(scope="module")
def trees():
    return {"target": _tree(4), "draft": _tree(7, layers=1, hidden=16)}


def _engine(trees, kv_quant="none", **kw):
    _, tcfg = _cfgs(kv_quant)
    _, dcfg = _cfgs(layers=1, hidden=16)
    cfg = LmConfig(force_cpu=True, prompt_buckets=BUCKETS, new_token_buckets=[NEW],
                   dtype="float32", kv_quant=kv_quant, temperature=0.0, **kw)
    return LmEngine(cfg, params=gpt_params_from_numpy(trees["target"], "cpu"), model_cfg=tcfg,
                    draft_params=gpt_params_from_numpy(trees["draft"], "cpu"),
                    draft_model_cfg=dcfg, device="cpu")


def _prompts(rows, P, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((rows, P), np.int32)
    mask = np.zeros((rows, P), np.int32)
    for i in range(rows):
        n = P if i == 0 else int(rng.integers(1, P + 1))
        ids[i, :n] = rng.integers(1, 257, n)
        mask[i, :n] = 1
    return ids, mask


def _assert_cache_at_real_slots(got, want, valid, quant):
    """The port's cache against JAX's at the slots kv_valid marks real:
    f32 slabs at F32, int8 codes and their f32 scales equal (the same
    values quantize alike; a code may sit one step off at a rounding
    boundary, then its dequantized value is within that step)."""
    if not quant:
        for g, w in ((got.k, want.k), (got.v, want.v)):
            np.testing.assert_allclose(g.numpy()[:, valid], np.asarray(w)[:, valid], **F32)
        return
    for gq, gs, wq, ws in ((got.k, got.k_scale, want.k, want.k_scale),
                           (got.v, got.v_scale, want.v, want.v_scale)):
        np.testing.assert_allclose(gs.numpy()[:, valid], np.asarray(ws)[:, valid], **F32)
        codes = gq.numpy()[:, valid].astype(np.int32) - np.asarray(wq)[:, valid].astype(np.int32)
        assert np.abs(codes).max() <= 1 and (codes != 0).mean() < 0.01


@pytest.mark.parametrize("model", ["target", "draft"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("rows", [1, 2, 4])
def test_prefill_executable_matches_jax(trees, model, kv_quant, rows):
    """Both buckets through the engine's executable of each key against
    JAX `prefill` on the same tree; the clone a caller without a carrier
    takes is the executable's cache at P, and each key keeps one
    executable across calls."""
    lm = _engine(trees, kv_quant)
    jcfg, _ = _cfgs(kv_quant if model == "target" else "none",
                    **({} if model == "target" else dict(layers=1, hidden=16)))
    jp = jax.tree.map(jnp.asarray, trees[model])
    params = lm.params if model == "target" else lm._draft[0]
    # the drafter's cache is dense and unquantized whatever the target's
    quant = kv_quant == "int8" and model == "target"
    for P in BUCKETS:
        ids, mask = _prompts(rows, P, seed=P + rows)
        with torch.inference_mode():
            cache, logits, kv_valid, plen = lm._prefill(params, ids, mask, NEW, model=model)
        jcache, jlogits, jkv, jplen = jgpt.prefill(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                                   NEW)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32)
        assert np.array_equal(kv_valid.numpy(), np.asarray(jkv))
        assert np.array_equal(plen.numpy(), np.asarray(jplen))
        assert cache.length == P
        _assert_cache_at_real_slots(cache, jcache, np.asarray(jkv)[:, :P + NEW], quant)
        key = (model, kv_quant if model == "target" else "none", rows, P, NEW)
        exe = lm._prefills.get(key)
        assert exe is not None and cache.k is not exe.cache.k  # a clone
        assert torch.equal(cache.k, exe.cache.k)
        with torch.inference_mode():
            lm._prefill(params, ids, mask, NEW, model=model)
        assert lm._prefills.get(key) is exe
    assert len(lm._prefills) == len(BUCKETS)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_a_carrier_takes_the_prompt_slots(trees, kv_quant):
    """A caller that holds a carrier gets the executable's prompt slots
    copied into the carrier's cache, which it gets back at length P; the
    slots past the prompt keep what they held, which no step reads before
    it writes them."""
    lm = _engine(trees, kv_quant)
    ids, mask = _prompts(2, 16, seed=3)
    dec = lm._take_carrier(2, 16, NEW)
    for t in dec.cache0:
        if isinstance(t, torch.Tensor):
            t.fill_(3)
    with torch.inference_mode():
        cache, logits, kv_valid, plen = lm._prefill(lm.params, ids, mask, NEW, cache=dec.cache0)
        alone = lm._prefill(lm.params, ids, mask, NEW)
    assert cache.k is dec.cache0.k and cache.length == 16
    for a, b in zip(cache, alone[0]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a[:, :, :16], b[:, :, :16])
            assert bool((a[:, :, 16:] == 3).all())
    for a, b in zip((logits, kv_valid, plen), alone[1:]):
        assert torch.equal(a, b)


def test_update_params_rebuilds_the_prefill_executable(trees):
    """A sync rebuilds no executable: it copies the new weights into the
    engine's tensors, so the prefill executable is kept (on the card: no
    new capture) and replays on them, its logits those of a fresh engine on
    the new tree. (The name is the one this test had when a sync rebuilt
    the executable.)"""
    _sync_keeps_the_prefill_executable(trees, "none")


def test_update_params_keeps_the_int8_prefill_executable(trees):
    """The same, on an int8 KV cache."""
    _sync_keeps_the_prefill_executable(trees, "int8")


def _sync_keeps_the_prefill_executable(trees, kv_quant):
    lm = _engine(trees, kv_quant)
    ids, mask = _prompts(1, 8, seed=1)
    with torch.inference_mode():
        first = lm._prefill(lm.params, ids, mask, NEW)[1]
    key = ("target", kv_quant, 1, 8, NEW)
    exe = lm._prefills.get(key)
    lm.update_params(gpt_params_from_numpy(_tree(11), "cpu"))
    with torch.inference_mode():
        second = lm._prefill(lm.params, ids, mask, NEW)[1]
    assert lm._prefills.get(key) is exe and exe.params is lm.params
    assert not torch.equal(first, second)
    fresh = _engine(dict(trees, target=_tree(11)), kv_quant)
    with torch.inference_mode():
        assert torch.equal(second, fresh._prefill(fresh.params, ids, mask, NEW)[1])


def test_every_prefill_caller_goes_through_the_executables(trees, monkeypatch):
    """generate_batch, a stream (target and drafter), a session's start and
    an admission each replay an executable of their key; no prefill runs
    outside one."""
    lm = _engine(trees, stream_chunk=4)
    calls = []
    real = tgpt.prefill

    def spy(*a, **kw):
        calls.append(kw.get("cache") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tgpt, "prefill", spy)
    lm.generate_batch(["abc", "de"], [8, 8])
    "".join(lm.generate_stream("stream", 8))
    sess = lm.start_session(["one", "two"], [8, 8])
    sess.step()
    sess.admit(["three"], [4])
    while not sess.done():
        sess.step()
    sess.close()
    assert len(calls) == 7 and all(calls)  # each wrote its executable's own cache
    keys = {k for k, _ in lm._prefills.items()}
    assert keys == {("target", "none", 2, 8, NEW), ("target", "none", 1, 8, NEW),
                    ("draft", "none", 1, 8, NEW), ("target", "none", 4, 8, NEW),
                    ("draft", "none", 4, 8, NEW)}


def test_prefill_executables_are_bounded_by_their_caches_bytes(trees):
    """A model's executables keep their caches within one session's at the
    largest geometry the configuration admits (here 1 row x 32 slots),
    least recently used first out, and the newest is kept even alone over
    the bound; a dropped target shape is no longer warm."""
    lm = _engine(trees, gen_max_batch=1)
    per_slot = tgpt.cache_bytes(tgpt.init_cache(lm.model_cfg, 1, 1, torch.float32, "cpu"))
    shapes = ((1, 8), (1, 16), (1, 8), (4, 8))
    held = []
    with torch.inference_mode():
        for rows, P in shapes:
            ids, mask = _prompts(rows, P, seed=P)
            lm._prefill(lm.params, ids, mask, NEW)
            lm._prefill(lm._draft[0], *_prompts(1, 8, seed=0), NEW, model="draft")
            held.append(sorted(k[2:4] for k, _ in lm._prefills.items() if k[0] == "target"))
    # 24 + 32 slots > 32: the older goes; 4 x 24 is over the bound alone
    assert held == [[(1, 8)], [(1, 16)], [(1, 8)], [(4, 8)]]
    st = lm.prefill_stats()
    assert st["shapes"] == {"target": 1, "draft": 1}
    assert st["budget"]["target"] == 32 * per_slot
    assert st["cache_bytes"]["target"] == 4 * 24 * per_slot
    assert lm.prefill_bytes() == sum(st["cache_bytes"].values()) + st["pool_bytes"]
    lm._prefill_shapes.update({(1, 8, NEW), (4, 8, NEW)})
    with torch.inference_mode():
        lm._prefill(lm.params, *_prompts(1, 16, seed=1), NEW)
    assert (4, 8, NEW) not in lm._prefill_shapes and (1, 8, NEW) in lm._prefill_shapes


def test_prefill_warm_follows_jax_over_a_sequence_of_admissions(trees):
    """`prefill_warm` before each admission of one sequence after a
    session's start: the port's (its executable captured) equals JAX's (its
    prefill compiled), shape for shape."""
    jcfg, tcfg = _cfgs()
    kw = dict(prompt_buckets=BUCKETS, new_token_buckets=[NEW], dtype="float32",
              temperature=0.0, session_min_rows=4, stream_chunk=4)
    jax_lm = JaxLmEngine(JaxLmConfig(**kw), params=trees["target"], model_cfg=jcfg)
    port = LmEngine(LmConfig(**kw), params=gpt_params_from_numpy(trees["target"], "cpu"),
                    model_cfg=tcfg, device="cpu")
    got, want = [], []
    for lm, out in ((port, got), (jax_lm, want)):
        sess = lm.start_session(["a", "b", "c"], [NEW] * 3)
        for k in (1, 2, 1, 4, 3, 2):
            out.append([sess.prefill_warm(j) for j in (1, 2, 3, 4)])
            out.append(sess.prepare_admit(["x" * j for j in range(1, k + 1)], [1] * k)["bb2"])
    assert got == want
    assert got[0] == [False, False, True, True]  # the start's 4 rows
    assert got[-2] == [True, True, True, True]


def test_graphs_prefill_phase_rehearses_on_the_cpu(tiny_dirs, capsys):
    """[graphs]' prefill lines end to end on the CPU at tiny geometries,
    with every check they make on the card (eager against eager here: a
    CPU executable is the eager function; B1's plain forwards counted as
    its launches)."""
    tmp, _ = tiny_dirs
    out = chip_smoke.graphs_prefill_phase(
        np.random.default_rng(0), tmp, device="cpu", lm_kw=TINY_LM_KW,
        sizes=dict(rows=(1, 4), buckets=(8, 16, 64), new=16, reps=2))
    printed = capsys.readouterr().out
    assert printed.count("[graphs] prefill executables") == 2
    # 64 + 16 new overflows the tiny models' 64 positions: two buckets each
    assert set(out["tinyllama"]) == set(out["gpt2"]) == {"1x8", "1x16", "4x8", "4x16"}
    assert all(v["capture_ms"] is None and v["graphed_ms"] > 0 for v in out["gpt2"].values())
    # 2 layers each: a first call, a replay and 2 timed replays at 8 shapes
    assert out["checked_launches"] == 8 * 4 * 2
