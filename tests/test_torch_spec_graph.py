"""The spec plane's rounds as executables (engine/lm.py `_CarryDecoder`'s
`spec_first`, `draft`, `verify`, `ingest` and `track`) against the JAX
package on the CPU, at float32:

- the five `gpt` round functions at a device slot index (a 0-d `length`)
  with the sampling triple built outside equal JAX's jitted rounds on one
  numpy-seeded state: greedy tokens, counts, emitted lengths, positions,
  done flags and pending identical, kv_valid equal to the array JAX's
  `dynamic_update_slice` gives (written in place into the one passed),
  cache leaves within atol 2e-5 / rtol 1e-4, `length` a device scalar
  advanced by the window;
- engines whose rounds run through the carrier (eagerly on the CPU, the
  same executables the card captures): a stream and sessions on the
  dense, int8 and paged layouts give the JAX spec engine's tokens and
  spec-off's, with full and with partial acceptance (drafts corrupted
  from slot 2), and across a splice and a cancel;
- one seed repeats a sampled stream and a sampled session, and a carrier
  reused by a second session replays the first one's executables: one
  executable per round geometry, `compiles` in the dispatch ledger one per
  signature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.obs.xprof import dispatch_ledger
from tests.test_torch_spec import (BP, K, NEWP, PROMPTS, _close_caches, _corrupting, _engine,
                                   _jnp, _pair_spec, _spec_engine, _state)

S = K + 1


def _dev(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int64)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch,nkv", [("gpt2", None), ("llama", 2)])
def test_round_functions_at_a_device_slot_match_jax(arch, nkv, kv_quant):
    """spec_first, draft_chunk, verify_chunk (greedy, an eos among the
    target's tokens, a finished row riding along), ingest_pending and
    track_chunk, each at a device `length` and with the sampling triple
    passed in, against JAX's rounds on the same state."""
    r = _state(arch, nkv, kv_quant)
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    P = r["kv"].shape[1] - NEWP
    done = np.array([False, False, True])
    sampling = tgpt._norm_sampling(0.0, 0, BP, tcfg.vocab_size)
    jtok, jc0, jdone = jgpt.spec_first(_jnp(r["logits"]), _jnp(done), jax.random.key(0), jcfg,
                                       temperature=0.0, top_k=0)
    ttok, tc0, tdone = tgpt.spec_first(torch.from_numpy(r["logits"]), torch.from_numpy(done),
                                       torch.Generator().manual_seed(0), tcfg, sampling=sampling)
    for g, w in ((ttok, jtok), (tc0, jc0), (tdone, jdone)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    pos = torch.from_numpy(r["pos"]).long()
    jd, jdrafts = jgpt.draft_chunk(r["jdp"], r["jd"]._replace(length=jnp.asarray(P)), _jnp(jtok),
                                   _jnp(r["pos"]), _jnp(jdone), _jnp(r["kv"]), jcfg, K)
    td, tdrafts = tgpt.draft_chunk(r["tdp"], r["td"]._replace(length=_dev(P)), ttok, pos, tdone,
                                   torch.from_numpy(r["kv"]), tcfg, K)
    assert np.array_equal(tdrafts.numpy(), np.asarray(jdrafts))
    assert isinstance(td.length, torch.Tensor) and int(td.length) == P + S
    _close_caches(td._replace(length=int(td.length)), jd, P + S)
    eos = int(np.asarray(jdrafts)[1, 0])
    jout = jgpt.verify_chunk(r["jp"], r["jcache"]._replace(length=jnp.asarray(P)), _jnp(jtok),
                             _jnp(jdrafts), _jnp(r["pos"]), _jnp(jdone), _jnp(r["kv"]),
                             jax.random.key(1), jcfg, temperature=0.0, top_k=0, eos_id=eos)
    kv = torch.from_numpy(r["kv"].copy())
    tout = tgpt.verify_chunk(r["tp"], r["tcache"]._replace(length=_dev(P)), ttok, tdrafts, pos,
                             tdone, kv, torch.Generator().manual_seed(1), tcfg, eos_id=eos,
                             sampling=sampling)
    assert tout[4] is kv  # the window's validity written into the kv_valid given
    want_kv = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(r["kv"]), jnp.asarray(jout[4])[:, P:P + S], (0, P)))
    assert np.array_equal(kv.numpy(), want_kv) and np.array_equal(kv.numpy(), np.asarray(jout[4]))
    assert int(tout[0].length) == P + S
    _close_caches(tout[0]._replace(length=int(tout[0].length)), jout[0], P + S)
    for i, (g, w) in enumerate(zip(tout[1:], jout[1:])):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"output {i + 1} differs"
    jing = jgpt.ingest_pending(r["jp"], jout[0], jout[1], jout[2], jout[3], jout[4], jcfg)
    ting = tgpt.ingest_pending(r["tp"], tout[0], tout[1], tout[2], tout[3], tout[4], tcfg)
    assert int(ting[0].length) == P + S + 1
    _close_caches(ting[0]._replace(length=int(ting[0].length)), jing[0], P + S + 1)
    np.testing.assert_allclose(ting[1].numpy(), np.asarray(jing[1]), atol=2e-5, rtol=1e-4)
    assert np.array_equal(ting[2].numpy(), np.asarray(jing[2]))
    toks = np.array(jdrafts)[:, :3]
    start = np.array(jing[2])
    jtr = jgpt.track_chunk(r["jdp"], jd, _jnp(toks), _jnp(start), jout[4], jcfg)
    ttr = tgpt.track_chunk(r["tdp"], td, torch.from_numpy(toks).long(),
                           torch.from_numpy(start).long(), kv, tcfg)
    assert int(ttr.length) == P + S + 3
    _close_caches(ttr._replace(length=int(ttr.length)), jtr, P + S + 3)


def test_a_device_slot_round_equals_a_host_slot_round():
    """One sampled verify at a host `length` and one at the same device
    `length`, one seed: the same draws, tokens, caches and kv_valid; the
    host length comes back a host int."""
    r = _state("llama", 2)
    tcfg = r["tcfg"]
    P = r["kv"].shape[1] - NEWP
    pending = torch.from_numpy(r["logits"]).argmax(-1)
    pos, done = torch.from_numpy(r["pos"]).long(), torch.zeros(BP, dtype=torch.bool)
    drafts = torch.randint(0, tcfg.vocab_size, (BP, K), generator=torch.Generator().manual_seed(2))
    outs = []
    for length in (P, _dev(P)):
        cache = type(r["tcache"])(*[t.clone() for t in r["tcache"][:-1]], length)
        outs.append(tgpt.verify_chunk(r["tp"], cache, pending, drafts, pos, done,
                                      torch.from_numpy(r["kv"].copy()),
                                      torch.Generator().manual_seed(4), tcfg, temperature=0.8,
                                      top_k=3))
    host, dev = outs
    assert host[0].length == P + S and int(dev[0].length) == P + S
    for a, b in zip(host[0][:-1], dev[0][:-1]):
        assert torch.equal(a, b)
    for a, b in zip(host[1:], dev[1:]):
        assert torch.equal(a, b)


def _stream(eng, prompt, n, **kw):
    return "".join(eng.generate_stream(prompt, n, **kw))


def _session(eng, prompts, wants, admit=None, cancel=False, **kw):
    """A session driven to its end; `admit` = (prompt, want) joins after
    the first step, `cancel` cancels tag 0 after the second."""
    sess = eng.start_session(prompts, wants, **kw)
    done, n = [], 0
    while not sess.done():
        done += sess.step()
        n += 1
        if n == 1 and admit is not None:
            sess.admit([admit[0]], [admit[1]], **kw)
        if n == 2 and cancel:
            sess.cancel_tag(0)
    if hasattr(sess, "close"):  # the port's session gives its carrier back
        sess.close()
    return sorted(done)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("layout,kv_quant", [("dense", "none"), ("dense", "int8"),
                                             ("paged", "none"), ("paged", "int8")])
def test_carried_rounds_give_the_jax_spec_engines_tokens(monkeypatch, layout, kv_quant,
                                                         corrupt):
    """A stream and a session (with an admission after the first step)
    whose rounds run through the carrier's executables: the JAX spec
    engine's tokens and spec-off's, at full acceptance and with drafts
    corrupted from slot 2 (rejected slots become kv_valid holes); the
    acceptance counts equal JAX's."""
    jax_eng, port, off = _pair_spec(kv_layout=layout, kv_quant=kv_quant)
    admit = ("a newcomer joins", 12)
    ref_s = _stream(off, "the quick brown fox", 24, temperature=0.0)
    ref_b = _session(off, PROMPTS, [20, 20, 20], admit=admit, temperature=0.0)
    if corrupt:
        monkeypatch.setattr(tgpt, "draft_chunk", _corrupting(tgpt.draft_chunk))
        monkeypatch.setattr(jgpt, "draft_chunk", _corrupting(jgpt.draft_chunk))
    for eng in (port, jax_eng):
        assert _stream(eng, "the quick brown fox", 24, temperature=0.0) == ref_s
        assert _session(eng, PROMPTS, [20, 20, 20], admit=admit, temperature=0.0) == ref_b
    assert (port._spec_proposed, port._spec_accepted) == (jax_eng._spec_proposed,
                                                          jax_eng._spec_accepted)
    assert port._spec_proposed > 0
    assert (port._spec_accepted < port._spec_proposed) == corrupt


def test_carried_rounds_through_a_splice_and_a_cancel():
    """A spec session that admits a row mid-flight (the pending token
    folded into both caches, the drafter's rows spliced into the carrier's
    drafter cache in place) and then cancels one: spec-off's tokens on
    both layouts, every page free after."""
    kw = dict(temperature=0.0)
    for layout in ("dense", "paged"):
        off, on = _engine(kv_layout=layout), _spec_engine(kv_layout=layout)
        want = _session(off, PROMPTS, [20, 20, 20], admit=("late prompt", 12), cancel=True, **kw)
        got = _session(on, PROMPTS, [20, 20, 20], admit=("late prompt", 12), cancel=True, **kw)
        assert got == want and on._spec_proposed > 0
        if layout == "paged":
            assert on.pool.pages_live == 0


def test_one_seed_repeats_sampled_rounds():
    """Sampled (temperature 0.9, top-k 5) streams and sessions of two
    engines built alike: the same draws, the same tokens, the same
    acceptance; and a second session on one engine, which reuses the
    first one's carrier and executables, repeats on a twin engine's
    second session."""
    def run():
        eng = _spec_engine(temperature=0.9, top_k=5)
        s = _stream(eng, "sampled stream", 20)
        a = _session(eng, PROMPTS, [20, 20, 20])
        b = _session(eng, PROMPTS, [20, 20, 20])
        return s, a, b, eng._spec_proposed, eng._spec_accepted

    first, second = run(), run()
    assert first == second and first[3] > 0


def test_one_executable_per_round_geometry():
    """A session's carrier holds one executable per round shape (a chunk,
    spec_first, the draft, the verify, the ingest, a track per window
    width), and a second session of the geometry takes the carrier back
    and replays them: no new executable, no new compile in the dispatch
    ledger."""
    eng = _spec_engine(new_token_buckets=[64])
    kw = dict(temperature=0.0)

    def kinds(carrier):
        out = {}
        for key in carrier.exes:
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    def compiles():
        return {r["executable"]: r["compiles"] for r in dispatch_ledger.snapshot()
                if r["executable"].startswith("lm.")}

    def drive(sess):
        # two rounds, a plain interlude (ingest, chunks, tracks), rounds again
        while not sess.done():
            sess.step()
            if sess._spec_rounds == 2 and sess._spec_on:
                sess._spec_on = False
                plain_from = sess.steps_done
            if not sess._spec_on and sess.steps_done >= plain_from + 8:
                sess._spec_on = True
        sess.close()

    plain_from = 1 << 30
    sess = eng.start_session(PROMPTS, [40, 40, 40], **kw)
    carrier = sess._carrier
    drive(sess)
    have = kinds(carrier)
    assert have["spec_first"] >= 1 and have["draft"] == 1 and have["verify"] == 1
    assert have["ingest"] == 1 and have["chunk"] == 1 and have["track"] >= 1
    assert len(carrier.exes) == sum(have.values())
    before, n_exes = compiles(), len(carrier.exes)
    assert before[f"lm.verify_chunk[P={sess.P},B={sess.bb},k={K}]"] >= 1
    plain_from = 1 << 30
    again = eng.start_session(PROMPTS, [40, 40, 40], **kw)
    assert again._carrier is carrier  # the geometry's free carrier
    drive(again)
    assert len(carrier.exes) == n_exes
    after = compiles()
    assert {k: v for k, v in after.items() if before.get(k) != v} == {}
