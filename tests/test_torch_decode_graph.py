"""The LM's decode at a device slot index and its executables, on the CPU.

`gpt.decode_chunk` writes each step's K/V at a slot held in a 0-d tensor
and builds its mask from it (JAX's `length: jax.Array`), so a chunk has no
host value in it and one CUDA graph serves every chunk on the card. Here,
at the tiny geometry of `tests/test_torch_gpt.py` and float32: chunks of 8
+ 8 equal one chunk of 16 and the JAX package's `decode_chunk` (logits at
atol 2e-5 / rtol 1e-4, greedy tokens identical), for the dense and int8
caches; the engine's carried executables (`engine/lm._CarryDecoder`, the
eager function on the CPU) give `gpt.generate`'s tokens, are lent out of
the engine's pool by geometry and given back by `generate_batch`, streams
and sessions, and adopt state that a caller replaced. The card holds
graphed = eager in `chip_smoke.py`'s [graphs] lines, whose CPU rehearsal
is the last test here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.engine.lm import LmEngine, _CarryDecoder
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.models.quant import leaves as tree_leaves

F32 = dict(atol=2e-5, rtol=1e-4)
B, P, NEW = 3, 16, 16
LENGTHS = [16, 9, 4]


def _cfgs(arch="llama", nkv=2, kv_quant="none"):
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=nkv,
              intermediate_size=64, max_position_embeddings=64, arch=arch, dtype="float32",
              tie_word_embeddings=arch == "gpt2", kv_quant=kv_quant)
    return jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)


def _params(arch="llama", nkv=2, seed=3):
    jcfg, _ = _cfgs(arch, nkv)
    rng = np.random.default_rng(seed)

    def move(a):  # off the init, so greedy decode does not settle on one token
        a = np.asarray(a)
        if a.ndim >= 2:
            return (a * 8).astype(np.float32)
        return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)

    tree = jax.tree.map(move, jgpt.init_params(jax.random.key(seed), jcfg))
    return tree, gpt_params_from_numpy(tree, "cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), np.int32)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(1, 97, n)
        mask[i, :n] = 1
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _port_chunks(tp, tcfg, sizes, temperature=0.0, top_k=0, seed=5):
    ids, mask = _prompts()
    cache, logits, kv_valid, pos = tgpt.prefill(tp, _t(ids), _t(mask), tcfg, NEW)
    done = torch.zeros(B, dtype=torch.bool)
    gen = torch.Generator().manual_seed(seed)
    toks = []
    for n in sizes:
        cache, logits, pos, done, t, _ = tgpt.decode_chunk(tp, cache, logits, pos, done,
                                                           kv_valid, gen, n, tcfg,
                                                           temperature, top_k)
        toks.append(t)
    return cache, logits, torch.cat(toks, 1)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch,nkv", [("gpt2", None), ("llama", 2)])
def test_device_slot_decode_matches_jax(arch, nkv, kv_quant):
    jcfg, tcfg = _cfgs(arch, nkv, kv_quant)
    jp, tp = _params(arch, nkv)
    one = _port_chunks(tp, tcfg, [NEW])
    two = _port_chunks(tp, tcfg, [8, 8])
    assert one[0].length == two[0].length == P + NEW  # the host length comes back
    assert torch.equal(one[2], two[2]) and torch.equal(one[1], two[1])
    for a, b in zip(one[0][:-1], two[0][:-1]):
        assert torch.equal(a, b)  # every slab and scale plane, slot for slot
    ids, mask = _prompts()
    jp_c = jax.tree.map(jnp.asarray, jp)
    cache, logits, kv_valid, plen = jgpt.prefill(jp_c, jnp.asarray(ids), jnp.asarray(mask),
                                                 jcfg, NEW)
    done = jnp.zeros((B,), bool)
    keys = jax.random.split(jax.random.key(0), NEW)
    _, jlogits, _, _, jtoks, _ = jgpt.decode_chunk(jp_c, cache, logits, plen, done, kv_valid,
                                                   keys, jcfg, temperature=0.0, top_k=0)
    assert np.array_equal(two[2].numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(two[1].numpy(), np.asarray(jlogits), **F32)


def test_a_device_length_writes_the_slots_a_host_length_writes():
    _, tcfg = _cfgs()
    _, tp = _params()
    ids, mask = _prompts()
    outs = []
    for as_tensor in (False, True):
        cache, logits, kv_valid, pos = tgpt.prefill(tp, _t(ids), _t(mask), tcfg, NEW)
        if as_tensor:
            cache = cache._replace(length=torch.tensor(cache.length))
        out, cache = tgpt.forward(tp, torch.full((B, 1), 5), cache, pos[:, None], tcfg, kv_valid)
        outs.append((out, cache.k.clone(), cache.v.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_prefill_into_a_given_cache_equals_a_fresh_one():
    _, tcfg = _cfgs()
    _, tp = _params()
    ids, mask = _prompts()
    fresh = tgpt.prefill(tp, _t(ids), _t(mask), tcfg, NEW)
    used = tgpt.init_cache(tcfg, B, P + NEW, torch.float32)
    used.k.fill_(3.0)  # stale contents past the prompt are never read
    given = tgpt.prefill(tp, _t(ids), _t(mask), tcfg, NEW, cache=used)
    assert given[0].k is used.k and given[0].length == P
    assert torch.equal(given[0].k[:, :, :P], fresh[0].k[:, :, :P])
    for a, b in zip(fresh[1:], given[1:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="prefill into a cache"):
        tgpt.prefill(tp, _t(ids), _t(mask), tcfg, NEW + 1, cache=used)


def _engine(**kw):
    _, tcfg = _cfgs()
    _, tp = _params()
    return LmEngine(LmConfig(force_cpu=True, prompt_buckets=[16], new_token_buckets=[16],
                             **kw), params=tp, model_cfg=tcfg)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_carried_chunks_equal_eager_decode(temperature):
    """Four chunks through one carry (the state adopted after the first,
    the generator reseeded as a stream reseeds it) equal eager chunks."""
    lm = _engine()
    ids, mask = _prompts()
    temps, ks = [temperature] * B, [7] * B
    runs = []
    for carried in (False, True):
        cache, logits, kv_valid, pos = tgpt.prefill(lm.params, _t(ids), _t(mask),
                                                    lm.model_cfg, NEW)
        done = torch.zeros(B, dtype=torch.bool)
        carrier, toks = _CarryDecoder(lm.device), []
        for n in range(4):
            gen = lm._chunk_generator(11, n, carrier if carried else None)
            if carried:
                cache, logits, pos, done, kv_valid, t, _ = carrier.chunk(
                    lm.params, lm.model_cfg, gen, cache, logits, pos, done, kv_valid, 4,
                    temps, ks, -1, "test")
            else:
                cache, logits, pos, done, t, _ = tgpt.decode_chunk(
                    lm.params, cache, logits, pos, done, kv_valid, gen, 4, lm.model_cfg,
                    temps, ks)
            toks.append(t)
        runs.append((torch.cat(toks, 1), logits))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_carrier_adopts_state_a_caller_replaced():
    lm = _engine()
    ids, mask = _prompts()
    cache, logits, kv_valid, pos = tgpt.prefill(lm.params, _t(ids), _t(mask), lm.model_cfg, NEW)
    done = torch.zeros(B, dtype=torch.bool)
    carrier, gen = _CarryDecoder(lm.device), torch.Generator().manual_seed(1)
    model = (lm.params, lm.model_cfg)
    cache, logits1, pos1, done1, kvv1, _, _ = carrier.chunk(*model, gen, cache, logits, pos,
                                                            done, kv_valid, 4, [0.0] * B,
                                                            [0] * B, -1, "test")
    assert logits1 is logits and pos1 is pos  # the first chunk binds the carry
    # a new logits tensor (what ingest_pending hands back) is copied in
    fresh = logits1.clone()
    cache, logits2, *_ = carrier.chunk(*model, gen, cache, fresh, pos1, done1, kvv1, 4,
                                       [0.0] * B, [0] * B, -1, "test")
    assert logits2 is logits and len(carrier.exes) == 1
    cache, *_ = carrier.chunk(*model, gen, cache, logits2, pos1, done1, kvv1, 4, [0.0] * B,
                              [9] * B, -1, "test")
    assert len(carrier.exes) == 2  # a new top-k bucket is a new executable
    assert cache.length == P + 12


def test_generate_batch_reuses_one_carrier_per_geometry():
    lm = _engine(temperature=0.0)
    ids, mask = _prompts()
    want, _ = tgpt.generate(lm.params, _t(ids), _t(mask), torch.Generator(), lm.model_cfg,
                            max_new_tokens=NEW, temperature=0.0, top_k=0)
    texts = ["abc", "hello there", "x"]
    a = lm.generate_batch(texts, [NEW] * 3)
    (dec,) = lm._free_carriers.values()
    b = lm.generate_batch(texts[::-1], [NEW] * 3)
    assert b == a[::-1] and list(lm._free_carriers.values()) == [dec] and len(dec.exes) == 1
    lm.generate_batch(texts[:1], [NEW])  # one row: another batch bucket, another carrier
    assert len(lm._free_carriers) == 2
    stats = lm.carrier_stats()
    assert (stats["takes"], stats["geometries"], stats["new"], stats["reused"]) == (3, 2, 2, 1)
    # the engine's carried decode is gpt.generate's on the same prompts
    toks, _ = lm._decode_batch(ids, mask, NEW, [0.0] * B, [0] * B, -1)
    assert torch.equal(toks, want)


def test_streams_and_sessions_give_their_carrier_back():
    """A stream returns its carrier at its end and a dense session when it
    is closed (not when it is done); the next one of that geometry replays
    its graphs (no new executable), and its tokens are what the first one
    decoded."""
    lm = _engine(temperature=0.0, stream_chunk=4)
    one = "".join(lm.generate_stream("hello", NEW, temperature=0.0))
    (dec,) = lm._free_carriers.values()
    n_exes = len(dec.exes)
    assert "".join(lm.generate_stream("hello", NEW, temperature=0.0)) == one
    assert list(lm._free_carriers.values()) == [dec] and len(dec.exes) == n_exes == 1
    with lm.start_session(["abc", "hello"], [NEW, NEW], temperature=0.0) as sess:
        carrier = sess._carrier
        assert carrier is not None and carrier not in lm._free_carriers.values()
        texts = {}
        while not sess.done():
            texts.update(dict(sess.step()))
        texts.update(dict(sess.step()))
        assert sess._carrier is carrier and len(lm._free_carriers) == 1
    assert sess._carrier is None and len(lm._free_carriers) == 2
    assert texts[1] == lm.generate("hello", NEW, temperature=0.0)
    with pytest.raises(RuntimeError, match="closed"):
        sess.step()


def test_a_done_session_keeps_its_carrier_through_a_splice():
    """A session whose rows have all finished may still take a splice and
    decode on: its cache stays its own until it is closed, so a
    `generate_batch` of its geometry in between borrows another carrier.
    The newcomer and the batch both decode what `generate()` decodes."""
    lm = _engine(temperature=0.0, stream_chunk=4)
    sess = lm.start_session(["abc", "hello"], [4, 4], temperature=0.0)
    finished = sess.step()
    assert len(finished) == 2 and sess.done()
    (tag,) = sess.admit(["a newcomer"], [8], temperature=[0.0])
    assert not sess.done()
    texts = dict(sess.step())
    batch = ["one", "two", "three", "four"]  # the session's geometry: 4 rows, 16 + 16
    got = lm.generate_batch(batch, [NEW] * 4, temperature=0.0)
    while not sess.done():
        texts.update(dict(sess.step()))
    sess.close()
    assert texts[tag] == lm.generate("a newcomer", 8, temperature=0.0)
    assert got == [lm.generate(p, NEW, temperature=0.0) for p in batch]
    assert lm.carrier_stats()["by_geometry"][("none", 4, P, NEW)] == 2


def test_gen_batcher_gives_its_sessions_carriers_back():
    """`GenBatcher` closes each session after its last row: the next wave
    of the same geometry finds the carrier free, and its texts are
    `generate()`'s."""
    lm = _engine(temperature=0.0, stream_chunk=4)
    wave = [("abc", 8), ("hello there", 12), ("x", 16)]
    for _ in range(2):
        texts, stats, _ = chip_smoke.serve_batcher(lm, [wave], 4)
        assert texts == [lm.generate(p, n, temperature=0.0) for p, n in wave]
    geometry = ("none", 4, P, NEW)
    assert lm.carrier_stats()["by_geometry"][geometry] == 2 and geometry in lm._free_carriers
    assert lm._carrier_counts["reused"] >= 1


def test_the_carrier_pool_keeps_one_a_geometry_within_its_budget():
    """Two carriers of one geometry given back leave one free; past the
    bytes of one session at the largest geometry (gen_max_batch rows over
    the largest prompt and new-token buckets) the least recently returned
    go first."""
    lm = _engine(gen_max_batch=8)
    a, b = lm._take_carrier(4, P, NEW), lm._take_carrier(4, P, NEW)
    lm._give_carrier(a)
    lm._give_carrier(b)
    assert list(lm._free_carriers.values()) == [b]
    per_slot = b.nbytes() // (4 * (P + NEW))
    assert lm._carrier_budget(b) == per_slot * 8 * (P + NEW)
    for rows in (1, 2, 8):  # 4 rows is free already: 1 + 2 + 4 + 8 > 8 rows
        lm._give_carrier(lm._take_carrier(rows, P, NEW))
    assert [k[1] for k in lm._free_carriers] == [8]
    stats = lm.carrier_stats()
    assert stats["free_bytes"] == per_slot * 8 * (P + NEW) and stats["takes"] == 5


def test_dropped_engines_free_without_a_cyclic_collection():
    """An engine that ran its executables (the LM's carriers, the
    encoder's cache) or its paged pool and radix cache is freed by its last
    reference, not only by a cyclic collection: nothing it owns refers back
    to it."""
    import gc
    import weakref

    from symbiont_tpu_torch.config import EngineConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine

    gc.collect()
    gc.disable()
    try:
        lm = _engine(temperature=0.0, stream_chunk=4)
        lm.generate_batch(["abc"], [NEW])
        "".join(lm.generate_stream("hello", NEW, temperature=0.0))
        with lm.start_session(["abc", "hello"], [NEW, NEW], temperature=0.0) as sess:
            while not sess.done():
                sess.step()
        del sess
        paged = _engine(temperature=0.0, stream_chunk=4, kv_layout="paged", kv_page_tokens=4)
        with paged.start_session(["abc", "hello"], [NEW, NEW], temperature=0.0) as sess:
            while not sess.done():
                sess.step()
        del sess
        enc = TorchEngine(EngineConfig(embedding_dim=32, length_buckets=[8, 16],
                                       batch_buckets=[2, 4], max_batch=4, dtype="float32"),
                          device="cpu")
        enc.embed_texts(["one two", "three"])
        refs = [weakref.ref(lm), weakref.ref(paged), weakref.ref(paged.pool), weakref.ref(enc)]
        del lm, paged, enc
        assert [r() is None for r in refs] == [True] * 4
    finally:
        gc.enable()


def test_update_params_rebuilds_the_executables():
    """A sync rebuilds no executable: it copies the new weights into the
    engine's tensors, so the carrier's decode executable is kept (on the
    card: no new capture) and decodes on the new weights, as a fresh engine
    on them does. (The name is the one this test had when a sync rebuilt
    the executables.)"""
    lm = _engine(temperature=0.0)
    before = lm.generate_batch(["abc"], [NEW])
    (dec,) = lm._free_carriers.values()
    (exe,) = dec.exes.values()
    ptrs = [t.data_ptr() for t in tree_leaves(lm.params)]
    new = tgpt.init_params(torch.Generator().manual_seed(9), lm.model_cfg)
    lm.update_params(new)
    after = lm.generate_batch(["abc"], [NEW])
    assert list(dec.exes.values()) == [exe] and exe.params is lm.params
    assert [t.data_ptr() for t in tree_leaves(lm.params)] == ptrs
    fresh = LmEngine(dataclasses.replace(lm.config), params=new, model_cfg=_cfgs()[1])
    assert after == fresh.generate_batch(["abc"], [NEW]) and after != before


def test_graphs_lm_phase_rehearses_on_the_cpu(tmp_path, capsys):
    """[graphs]' LM lines end to end on the CPU at tiny geometries, with
    every check they make on the card (eager against eager here: a CPU
    executable is the eager function)."""
    from test_torch_chip_smoke import TINY_GPT2, TINY_LLAMA, TINY_LM_KW

    for name, hf, dtype in (("tinyllama", TINY_LLAMA, torch.bfloat16),
                            ("gpt2", TINY_GPT2, torch.float32)):
        params = tgpt.init_params(torch.Generator().manual_seed(len(name)),
                                  tgpt.GPTConfig.from_hf(hf))
        chip_smoke.write_gpt_checkpoint(tmp_path / name, params, hf, dtype)
    out = chip_smoke.graphs_lm_phase(
        np.random.default_rng(0), tmp_path, device="cpu", lm_kw=TINY_LM_KW,
        sizes=dict(bucket=(8, 16), rows=4, new=16, chunk=4, gpt2_bucket=(8, 16),
                   batcher=dict(bucket=(8, 16), first_wave=(6, 8, 10, 12), later_waves=(4, 16),
                                waves=2, max_batch=4)))
    printed = capsys.readouterr().out
    assert printed.count("[graphs]") == 3
    assert set(out) == {"none greedy", "none sampled", "int8 greedy", "gpt2", "batcher",
                        "sampled_streams"}
    assert out["sampled_streams"]["second"]["reused"] == 1
    assert out["gpt2"]["batcher"]["warm"]["carriers"]["repeat_share"] > 0
    assert out["batcher"]["warm"]["tok_s"] > 0 and out["batcher"]["warm"]["busy_pct"] is None
    assert out["batcher"]["eager"]["tok_s"] > 0
    assert out["none greedy"]["capture_ms"] is None and out["gpt2"]["session_steps"] >= 3
