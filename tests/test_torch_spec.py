"""The port's speculative decoding (models/gpt.py's spec functions, the
draft plane of engine/lm.py) against the JAX package on the CPU:

- `spec_first`, `draft_chunk`, greedy `verify_chunk`, `ingest_pending` and
  `track_chunk` on the same weights and carried state as the JAX
  functions (a tiny llama and gpt2, f32): the same tokens, counts, emitted
  lengths, kv_valid, positions and done flags, cache leaves within atol
  2e-5 / rtol 1e-4; sampled rounds repeat under one seed and keep their
  tokens inside the top-k cutoff set;
- engines (a byte-level llama of width 32, greedy): spec-on text equal to
  spec-off for streams and for sessions on the dense, paged and int8
  layouts, with a drafter that is the target itself (acceptance 1) and one
  whose drafts are corrupted from slot 2 (partial acceptance; the counts
  equal the JAX engine's on the same schedule); admission and cancel
  mid-flight; the acceptance EMA turning a session plain; a pool exhausted
  in a spec window degrading to plain; the margin guard never truncating;
  `validate_spec_draft` against JAX's; a missing drafter dir degrading."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.config import LmConfig as JaxLmConfig
from symbiont_tpu.config import validate_spec_draft as jax_validate
from symbiont_tpu.engine.lm import LmEngine as JaxLmEngine
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu_torch.config import LmConfig, validate_spec_draft
from symbiont_tpu_torch.engine.lm import LmEngine
from symbiont_tpu_torch.kv.pool import PoolExhausted
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.utils.telemetry import metrics
from tests.test_torch_gpt import F32, _cfgs, _params, _prompts, _t

K = 4  # drafts a round
BP, NEWP = 3, 16  # rows and new slots of the function-level state


# ---------------------------------------------------------------- functions


def _jnp(a):
    return jnp.array(np.asarray(a))  # a fresh buffer: the JAX spec calls donate


def _state(arch, nkv, kv_quant="none"):
    """A prefilled carried state (target and drafter caches) from JAX's
    prefill, in both packages: the drafter is the target's geometry on
    other weights, so greedy acceptance is partial."""
    jcfg, tcfg = _cfgs(arch, nkv, kv_quant=kv_quant)
    jp, tp = _params(arch, nkv)
    jdp, tdp = _params(arch, nkv, seed=11)
    ids, mask = _prompts(3)
    jcache, jlogits, kv_valid, plen = jgpt.prefill(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids),
                                                   jnp.asarray(mask), jcfg, NEWP)
    jd = jgpt.prefill(jax.tree.map(jnp.asarray, jdp), jnp.asarray(ids), jnp.asarray(mask), jcfg,
                      NEWP)[0]

    def torch_cache(c):
        return type(tgpt.init_cache(tcfg, 1, 1, torch.float32))(
            *[torch.from_numpy(np.array(x)) for x in c[:-1]], int(c.length))

    return dict(jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, jp), tp=tp,
                jdp=jax.tree.map(jnp.asarray, jdp), tdp=tdp, jcache=jcache, jd=jd,
                tcache=torch_cache(jcache), td=torch_cache(jd), logits=np.array(jlogits),
                kv=np.array(kv_valid), pos=np.array(plen))


def _close_caches(got, want, upto: int):
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy()[:, :, :upto].astype(np.float32),
                                   np.asarray(w)[:, :, :upto].astype(np.float32), **F32)
    assert got.length == int(want.length)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch,nkv", [("gpt2", None), ("llama", 2)])
def test_spec_round_functions_match_jax(arch, nkv, kv_quant):
    """One plain → spec → plain cycle: spec_first, a draft_chunk, a greedy
    verify_chunk with an eos among the target's tokens, ingest_pending,
    then a plain chunk tracked into the drafter's cache."""
    r = _state(arch, nkv, kv_quant)
    jcfg, tcfg = r["jcfg"], r["tcfg"]
    P = r["kv"].shape[1] - NEWP
    done = np.array([False, False, True])  # a finished row rides along
    # spec_first, greedy
    jtok, jc0, jdone = jgpt.spec_first(_jnp(r["logits"]), _jnp(done), jax.random.key(0), jcfg,
                                       temperature=0.0, top_k=0)
    ttok, tc0, tdone = tgpt.spec_first(torch.from_numpy(r["logits"]), torch.from_numpy(done),
                                       torch.Generator().manual_seed(0), tcfg, temperature=0.0,
                                       top_k=0)
    for g, w in ((ttok, jtok), (tc0, jc0), (tdone, jdone)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # draft_chunk
    jd, jdrafts = jgpt.draft_chunk(r["jdp"], r["jd"]._replace(length=jnp.asarray(P)),
                                   _jnp(jtok), _jnp(r["pos"]), _jnp(jdone), _jnp(r["kv"]), jcfg, K)
    td, tdrafts = tgpt.draft_chunk(r["tdp"], r["td"]._replace(length=P), ttok,
                                   torch.from_numpy(r["pos"]).long(), tdone,
                                   torch.from_numpy(r["kv"]), tcfg, K)
    assert np.array_equal(tdrafts.numpy(), np.asarray(jdrafts))
    _close_caches(td, jd, P + K + 1)
    # verify_chunk, greedy, with an eos the target emits in row 1
    eos = int(np.asarray(jdrafts)[1, 0])
    kw = dict(temperature=0.0, top_k=0, eos_id=eos)
    jout = jgpt.verify_chunk(r["jp"], r["jcache"]._replace(length=jnp.asarray(P)), _jnp(jtok),
                             _jnp(jdrafts), _jnp(r["pos"]), _jnp(jdone), _jnp(r["kv"]),
                             jax.random.key(1), jcfg, **kw)
    tout = tgpt.verify_chunk(r["tp"], r["tcache"]._replace(length=P), ttok, tdrafts,
                             torch.from_numpy(r["pos"]).long(), tdone, torch.from_numpy(r["kv"]),
                             torch.Generator().manual_seed(1), tcfg, **kw)
    _close_caches(tout[0], jout[0], P + K + 1)
    for i, (g, w) in enumerate(zip(tout[1:], jout[1:])):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"output {i + 1} differs"
    emitted = tout[7].numpy()
    assert emitted[2] == 0 and (emitted[:2] >= 1).all()
    holes = ~tout[4].numpy()[:2, P:P + K + 1]
    assert (holes.sum(1) == K + 1 - emitted[:2]).all()  # rejected slots are holes
    # ingest_pending: back to the plain state
    jing = jgpt.ingest_pending(r["jp"], jout[0], jout[1], jout[2], jout[3], jout[4], jcfg)
    ting = tgpt.ingest_pending(r["tp"], tout[0], tout[1], tout[2], tout[3], tout[4], tcfg)
    _close_caches(ting[0], jing[0], P + K + 2)
    np.testing.assert_allclose(ting[1].numpy(), np.asarray(jing[1]), **F32)
    assert np.array_equal(ting[2].numpy(), np.asarray(jing[2]))
    # track_chunk: a plain chunk's tokens into the drafter's cache
    toks = np.array(jdrafts)[:, :3]
    start = np.array(jing[2])
    jtr = jgpt.track_chunk(r["jdp"], jd, _jnp(toks), _jnp(start), jout[4], jcfg)
    ttr = tgpt.track_chunk(r["tdp"], td, torch.from_numpy(toks).long(),
                           torch.from_numpy(start).long(), tout[4], tcfg)
    _close_caches(ttr, jtr, P + K + 4)


def test_sampled_verify_repeats_and_keeps_to_the_top_k_set():
    """Sampled rows (temperature 0.8, top-k 3): one seed gives one outcome,
    and every emitted token is inside the cutoff set the target's logits
    give at its window position (accepted drafts and the correction)."""
    r = _state("llama", 2)
    tcfg = r["tcfg"]
    P = r["kv"].shape[1] - NEWP
    pending = torch.from_numpy(r["logits"]).argmax(-1)
    pos, kv = torch.from_numpy(r["pos"]).long(), torch.from_numpy(r["kv"])
    done = torch.zeros(BP, dtype=torch.bool)
    # drafts: the target's own greedy continuation, so some are accepted
    _, drafts = tgpt.draft_chunk(r["tp"], tgpt.KVCache(r["tcache"].k.clone(),
                                                       r["tcache"].v.clone(), P),
                                 pending, pos, done, kv, tcfg, K)
    outs = []
    for _ in range(2):
        cache = tgpt.KVCache(r["tcache"].k.clone(), r["tcache"].v.clone(), P)
        # verify_chunk writes the window's validity into the kv_valid it takes
        outs.append(tgpt.verify_chunk(r["tp"], cache, pending, drafts, pos, done, kv.clone(),
                                      torch.Generator().manual_seed(4), tcfg, temperature=0.8,
                                      top_k=3))
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(a, b)
    # the target's logits at each window position, by a plain forward
    seq = torch.cat([pending[:, None], drafts], 1)
    cache = tgpt.KVCache(r["tcache"].k.clone(), r["tcache"].v.clone(), P)
    logits, _ = tgpt.forward(r["tp"], seq, cache, pos[:, None] + torch.arange(K + 1)[None], tcfg,
                             kv)
    top = torch.topk(logits, 3, dim=-1).indices
    out, emitted = outs[0][5], outs[0][7]
    assert int(emitted.max()) > 1  # some drafts accepted
    for i in range(BP):
        for j in range(int(emitted[i])):
            assert int(out[i, j]) in top[i, j].tolist(), (i, j)


# ------------------------------------------------------------------ engines

TINY = dict(enabled=True, arch="llama", hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_positions=256, dtype="float32", prompt_buckets=[16],
            new_token_buckets=[32], temperature=0.0, spec_k=K, stream_chunk=4,
            kv_page_tokens=16, gen_max_batch=8, session_min_rows=4)
PROMPTS = ["hello", "a much longer prompt", ""]


def _engine(**kw):
    return LmEngine(LmConfig(**{**TINY, **kw}), device="cpu")


def _spec_engine(**kw):
    """A drafter that IS the target (the same seeded init): acceptance 1,
    so identity tests see the spec plumbing alone."""
    donor = _engine(**kw)
    return LmEngine(LmConfig(**{**TINY, **kw}), draft_params=donor.params,
                    draft_model_cfg=donor.model_cfg, device="cpu")


def _stream(eng, prompt, n):
    return "".join(eng.generate_stream(prompt, n, temperature=0.0))


def _session(eng, prompts, wants):
    sess = eng.start_session(prompts, wants, temperature=0.0)
    done = []
    while not sess.done():
        done += sess.step()
    return sorted(done)


def _corrupting(real, wrong_from=2):
    """draft_chunk with its proposals corrupted from slot `wrong_from` on:
    partial acceptance, so rejected slots become kv_valid holes."""
    def fn(draft_params, d_cache, pending, cur_pos, done, kv_valid, dcfg, spec_k):
        cache, drafts = real(draft_params, d_cache, pending, cur_pos, done, kv_valid, dcfg,
                             spec_k)
        if isinstance(drafts, torch.Tensor):
            bad = (drafts + 1) % dcfg.vocab_size
            return cache, torch.where(torch.arange(spec_k)[None, :] >= wrong_from, bad, drafts)
        bad = (drafts + 1) % dcfg.vocab_size
        return cache, jnp.where(jnp.arange(spec_k)[None, :] >= wrong_from, bad, drafts)

    return fn


@pytest.mark.parametrize("layout,kv_quant", [("dense", "none"), ("dense", "int8"),
                                             ("paged", "none"), ("paged", "int8")])
def test_spec_greedy_token_identical(layout, kv_quant):
    kw = dict(kv_layout=layout, kv_quant=kv_quant)
    off, on = _engine(**kw), _spec_engine(**kw)
    assert _stream(off, "the quick brown fox jumps", 24) == _stream(
        on, "the quick brown fox jumps", 24)
    assert _session(off, PROMPTS, [20, 20, 20]) == _session(on, PROMPTS, [20, 20, 20])
    assert on._spec_proposed > 0 and on._spec_accepted == on._spec_proposed
    labels = {"service": "lm", "kv_dtype": "int8" if kv_quant == "int8" else "float32"}
    assert metrics.gauge_get("lm.spec_accept_rate", labels) == 1.0


def _pair_spec(**kw):
    """A JAX and a port engine with a drafter, on the same weights (the
    target's tree, a byte-vocab llama of TINY's width, as its own
    drafter), plus the port's spec-off engine."""
    jcfg = jgpt.GPTConfig(vocab_size=257, hidden_size=32, num_layers=2, num_heads=4,
                          num_kv_heads=2, intermediate_size=64, max_position_embeddings=256,
                          arch="llama", dtype="float32", tie_word_embeddings=False)
    tree = jax.tree.map(lambda a: np.asarray(a) * (8 if np.ndim(a) >= 2 else 1),
                        jgpt.init_params(jax.random.key(4), jcfg))
    cfg = {**TINY, **kw}
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(jcfg))
    jax_eng = JaxLmEngine(JaxLmConfig(**cfg), params=tree, model_cfg=jcfg, draft_params=tree,
                          draft_model_cfg=jcfg)
    port = LmEngine(LmConfig(**cfg), params=gpt_params_from_numpy(tree, "cpu"), model_cfg=tcfg,
                    draft_params=gpt_params_from_numpy(tree, "cpu"), draft_model_cfg=tcfg,
                    device="cpu")
    off = LmEngine(LmConfig(**cfg), params=port.params, model_cfg=tcfg, device="cpu")
    return jax_eng, port, off


@pytest.mark.parametrize("layout,kv_quant", [("dense", "none"), ("paged", "int8")])
def test_partial_acceptance_is_token_identical_and_counts_match_jax(monkeypatch, layout,
                                                                    kv_quant):
    jax_eng, port, off = _pair_spec(kv_layout=layout, kv_quant=kv_quant)
    ref_s, ref_b = _stream(off, "the quick brown fox", 24), _session(off, PROMPTS, [20, 20, 20])
    monkeypatch.setattr(tgpt, "draft_chunk", _corrupting(tgpt.draft_chunk))
    monkeypatch.setattr(jgpt, "draft_chunk", _corrupting(jgpt.draft_chunk))
    engine_timeline.clear()
    for eng in (port, jax_eng):
        assert _stream(eng, "the quick brown fox", 24) == ref_s
        assert _session(eng, PROMPTS, [20, 20, 20]) == ref_b
    assert 0 < port._spec_accepted < port._spec_proposed
    assert (port._spec_proposed, port._spec_accepted) == (jax_eng._spec_proposed,
                                                          jax_eng._spec_accepted)
    summ = engine_timeline.summary()
    assert summ["decode_spec_rounds"] >= 1 and 0 < summ["decode_spec_accept_pct"] < 100


def test_spec_admit_and_cancel_mid_flight():
    def drive(eng):
        sess = eng.start_session(["alpha prompt", "beta words"], [20, 20], temperature=0.0)
        out = list(sess.step())
        tags = sess.admit(["gamma joins late"], [12], temperature=0.0)
        out += sess.step()
        assert sess.cancel_tag(tags[0])
        while not sess.done():
            out += sess.step()
        return sorted(out)

    for layout in ("dense", "paged"):
        on = _spec_engine(kv_layout=layout)
        assert drive(_engine(kv_layout=layout)) == drive(on)
        assert on._spec_proposed > 0
    assert on.pool.pages_live == 0


def test_spec_divergence_ema_turns_the_session_plain(monkeypatch):
    def wrong(draft_params, d_cache, pending, cur_pos, done, kv_valid, dcfg, spec_k):
        cache, drafts = real(draft_params, d_cache, pending, cur_pos, done, kv_valid, dcfg,
                             spec_k)
        return cache, (drafts + 1) % dcfg.vocab_size

    real = tgpt.draft_chunk
    kw = dict(new_token_buckets=[64])
    ref = _session(_engine(**kw), ["alpha prompt", "beta words"], [12, 12])
    on = _spec_engine(**kw)
    monkeypatch.setattr(tgpt, "draft_chunk", wrong)
    sess = on.start_session(["alpha prompt", "beta words"], [12, 12], temperature=0.0)
    done = []
    while not sess.done():
        done += sess.step()
    assert sorted(done) == ref
    assert sess._spec_on is False and sess._spec_rounds >= 3 and on._spec_accepted == 0


def test_spec_pool_exhausted_degrades_to_plain(monkeypatch):
    ref = _session(_engine(kv_layout="paged"), ["alpha prompt", "beta words"], [20, 20])
    on = _spec_engine(kv_layout="paged")
    sess = on.start_session(["alpha prompt", "beta words"], [20, 20], temperature=0.0)
    calls = {"n": 0}
    real = sess._ensure_decode_blocks

    def flaky(slots):
        calls["n"] += 1
        if calls["n"] == 1:
            raise PoolExhausted("pressure")
        return real(slots)

    monkeypatch.setattr(sess, "_ensure_decode_blocks", flaky)
    done = []
    while not sess.done():
        done += sess.step()
    assert sorted(done) == ref and sess._spec_on is False


def test_spec_margin_guard_never_truncates_output():
    """A budget equal to the largest bucket leaves no spec headroom: the
    guard hands back to plain decode in time for every token."""
    off, on = _engine(), _spec_engine()
    a, b = _stream(off, "margin case", 32), _stream(on, "margin case", 32)
    assert a == b and len(b) > 0
    sess = on.start_session(["margin case"], [32], temperature=0.0)
    assert sess.round_slots() == K + 1 and sess.new_bucket == 32
    assert dict(_session(on, ["margin case"], [32]))[0] == dict(
        _session(off, ["margin case"], [32]))[0]


def test_spec_session_gates_and_round_slots():
    on = _spec_engine(new_token_buckets=[64])
    sess = on.start_session(["a"], [40], temperature=0.0)
    assert sess.new_bucket == 64  # 40 + spec_k headroom
    sess.step()  # a spec round: pending rides outside the caches
    assert sess._pending is not None and sess.steps_done == K + 1
    left = sess.remaining_steps()
    assert sess.can_admit("b", left - 1) and not sess.can_admit("b", left)  # the ingest slot
    tag = sess.admit(["b"], [8], temperature=0.0)[0]
    assert sess._pending is None and sess.steps_done == K + 2  # folded in before the merge
    finished = []
    while not sess.done():
        finished += sess.step()
    assert tag in dict(finished)


def _model_dir(tmp_path, name, vocab=256, tok=None):
    d = tmp_path / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"vocab_size": vocab}))
    if tok is not None:
        (d / "tokenizer.json").write_bytes(tok)
    return str(d)


@pytest.mark.parametrize("target,draft,match", [
    (dict(vocab=512, tok=b"{tok}"), dict(vocab=512, tok=b"{tok}"), None),
    (dict(vocab=512), dict(vocab=512, tok=b"{tok}"), None),
    (dict(vocab=512), dict(vocab=300), "vocab mismatch"),
    (dict(tok=b"{tok-a}"), dict(tok=b"{tok-b}"), "tokenizer mismatch"),
])
def test_validate_spec_draft_matches_jax(tmp_path, target, draft, match):
    t, d = _model_dir(tmp_path, "target", **target), _model_dir(tmp_path, "draft", **draft)
    for fn in (validate_spec_draft, jax_validate):
        if match is None:
            fn(t, d)
        else:
            with pytest.raises(ValueError, match=match):
                fn(t, d)
    for fn in (validate_spec_draft, jax_validate):
        with pytest.raises(ValueError, match="cannot read"):
            fn(t, str(tmp_path / "nope"))


def test_missing_drafter_dir_degrades_and_bad_drafters_fail_fast(tmp_path):
    eng = _engine(spec_draft_model=str(tmp_path / "not-there"))
    assert eng._draft is None and isinstance(eng.generate("hello", 8), str)
    donor = _engine()
    with pytest.raises(ValueError, match="vocab"):
        LmEngine(LmConfig(**TINY), draft_params=donor.params, device="cpu",
                 draft_model_cfg=dataclasses.replace(donor.model_cfg, vocab_size=300))
    with pytest.raises(ValueError, match="together"):
        LmEngine(LmConfig(**TINY), draft_params=donor.params, device="cpu")


def test_sampled_spec_sessions_repeat_under_one_seed():
    def run():
        eng = _spec_engine(temperature=0.9, top_k=5)
        return _session(eng, PROMPTS, [20, 20, 20]), eng._spec_proposed

    (a, pa), (b, pb) = run(), run()
    assert a == b and pa == pb > 0
