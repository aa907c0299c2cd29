"""The port's continuous batching (`BatchSession`, `gpt.merge_rows`) against
the JAX package on the CPU, at tiny geometries on the same weights
(tests/test_torch_lm.py's `_pair`), llama GQA and gpt2, dense and int8 KV:

- `merge_rows` gives JAX `_merge_rows_jit`'s leaves bit for bit on the same
  carried states;
- a session with no admission decodes `generate_batch`'s text and the JAX
  session's; a row admitted after one chunk (so a gap exists) decodes its
  standalone text and the JAX session's, token for token;
- the budget, capacity and prompt-bucket gates; `cancel_tag` frees the row
  and the KV gauges; the timeline and usage records equal JAX's on the
  same schedule; the admission bytes forecast; seeded sampling repeats;
  `prepare_admit` runs while another thread holds the engine lock."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.obs import engine_timeline as jtimeline
from symbiont_tpu.obs import usage as jusage
from symbiont_tpu.obs.usage import UsageMeter as JaxUsageMeter
from symbiont_tpu.utils.telemetry import Metrics as JaxMetrics
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.obs import engine_timeline as ttimeline
from symbiont_tpu_torch.obs import usage as tusage
from symbiont_tpu_torch.obs.hbm import hbm_ledger
from symbiont_tpu_torch.obs.usage import UsageMeter
from symbiont_tpu_torch.utils.telemetry import Metrics, metrics
from tests.test_torch_lm import _pair, _port

SESS = dict(stream_chunk=4, new_token_buckets=[16, 32], prompt_buckets=[8, 16])
VARIANTS = [("llama", 2, {}), ("llama", 2, dict(kv_quant="int8")),
            ("gpt2", None, {}), ("gpt2", None, dict(kv_quant="int8"))]
IDS = ["llama-dense", "llama-int8kv", "gpt2-dense", "gpt2-int8kv"]


@pytest.fixture(scope="module", params=VARIANTS, ids=IDS)
def engines(request):
    arch, nkv, kw = request.param
    return _pair(arch, nkv, **SESS, **kw)


def _drive(sess, max_chunks=64) -> dict:
    out = {}
    for _ in range(max_chunks):
        if sess.done():
            break
        out.update(sess.step())
    return out


# ----------------------------------------------------------------- merge_rows


def _carried_states(rng, quant: bool, B=4, Bb=2, T=24, P=8, length=14):
    """Random carried states a (B rows, `length` slots written) and b (Bb
    rows) as numpy, in both cache layouts."""
    L, nkv, hd = 2, 2, 8

    def cache(rows):
        shape = (L, rows, T, nkv, hd)
        if quant:
            return (rng.integers(-127, 128, shape).astype(np.int8),
                    rng.integers(-127, 128, shape).astype(np.int8),
                    rng.random(shape[:-1], np.float32), rng.random(shape[:-1], np.float32))
        return (rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32))

    def row_state(rows):
        return (rng.standard_normal((rows, 33), np.float32),
                rng.integers(1, P, rows).astype(np.int32), rng.random(rows) < 0.3,
                rng.random((rows, T)) < 0.8)

    return (cache(B), *row_state(B)), (cache(Bb), *row_state(Bb)), P, length


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
@pytest.mark.parametrize("row_map", [[-1, 1, -1, 0], [0, -1, -1, -1], [-1, -1, -1, -1]])
def test_merge_rows_matches_jax_bit_for_bit(quant, row_map):
    a, b, P, length = _carried_states(np.random.default_rng(len(row_map) + quant), quant)
    jcls, tcls = (jgpt.QuantKVCache, tgpt.QuantKVCache) if quant else (jgpt.KVCache,
                                                                       tgpt.KVCache)

    def jax_state(s, n):
        return (jcls(*map(jnp.asarray, s[0]), jnp.asarray(n, jnp.int32)),
                *map(jnp.asarray, s[1:]))

    def torch_state(s, n):
        return (tcls(*[torch.from_numpy(x.copy()) for x in s[0]], n),
                *[torch.from_numpy(x.copy()) for x in s[1:]])

    want = jgpt._merge_rows_jit(*jax_state(a, length), *jax_state(b, P),
                                jnp.asarray(row_map, jnp.int32), prompt_width=P)
    ta = torch_state(a, length)
    got = tgpt.merge_rows(*ta, *torch_state(b, P), np.asarray(row_map), prompt_width=P)
    assert got[0] is ta[0] and all(g is t for g, t in zip(got[1:], ta[1:]))  # in place
    assert got[0].length == length
    for g, w in zip(list(got[0][:-1]) + list(got[1:]), list(want[0][:-1]) + list(want[1:])):
        assert g.numpy().dtype.kind == np.asarray(w).dtype.kind
        assert np.array_equal(g.numpy(), np.asarray(w)), "leaf differs"
    spliced = [i for i, j in enumerate(row_map) if j >= 0]
    if spliced:  # the gap [P, length) of a spliced row is invalid for good
        assert not got[4][spliced, P:length].any()


def test_merge_rows_refuses_other_layouts_naming_paged_kv():
    a, b, P, length = _carried_states(np.random.default_rng(0), False)
    state = [torch.from_numpy(x) for x in a[1:]]
    # dense and int8 caches splice here, the paged layout by its own branch
    # (tests/test_torch_kv_paged.py); anything else is refused
    with pytest.raises(ValueError, match="QuantKVCache or PagedKVCache, not a tuple"):
        tgpt.merge_rows(("not", "a", "cache"), *state, ("b",), *state, [0, -1, -1, -1], P)
    cache = tgpt.KVCache(*map(torch.from_numpy, a[0]), length)
    with pytest.raises(ValueError, match="past the 2 prepared"):
        tgpt.merge_cache_rows(cache, tgpt.KVCache(*map(torch.from_numpy, b[0]), P),
                              [2, -1, -1, -1])


# ------------------------------------------------------------- equivalence


def test_session_matches_generate_batch_and_jax(engines):
    jax_eng, port = engines
    prompts, wants = ["hello", "wider prompt", "x"], [10, 16, 5]
    base = port.generate_batch(prompts, wants)
    assert base == jax_eng.generate_batch(prompts, wants)
    sess = port.start_session(prompts, wants)
    assert (sess.bb, sess.P, sess.new_bucket, sess.chunk) == (4, 16, 16, 4)
    out = _drive(sess)
    assert [out[i] for i in range(3)] == base
    assert _drive(jax_eng.start_session(prompts, wants)) == out


def test_admit_after_one_chunk_matches_standalone_and_jax(engines):
    jax_eng, port = engines
    solo = [port.generate(p, w) for p, w in (("hello", 24), ("world!", 12), ("ab", 8))]
    outs = []
    for eng in engines:
        admitted0 = eng.stats.get("admitted", 0)
        sess = eng.start_session(["hello"], [24])
        out = dict(sess.step())  # chunk 1 decodes alone: the gap [P, P + 4) exists
        assert sess.capacity() == 3 and sess.can_admit("world!", 12)
        tags = sess.admit(["world!", "ab"], [12, 8], temperature=[0.0, 0.0], top_k=[0, 0])
        assert tags == [1, 2] and sess.capacity() == 1
        out.update(_drive(sess))
        assert eng.stats["admitted"] - admitted0 == 2
        outs.append(out)
    assert outs[1] == outs[0]
    assert [outs[1][t] for t in (0, 1, 2)] == solo


def test_splice_refuses_a_budget_that_no_longer_fits(engines):
    _, port = engines
    sess = port.start_session(["hello"], [32])
    prep = sess.prepare_admit(["late"], [24])
    sess.step()
    sess.step()  # 8 of 32 steps spent: 24 still fit
    assert sess.splice(prep) == [1]
    prep = sess.prepare_admit(["later"], [20])
    sess.step()
    sess.step()  # 16 steps left: a budget of 20 no longer fits
    decode_s = sess.decode_s
    assert sess.splice(prep) == [None]
    assert sess.decode_s >= decode_s + prep["prefill_s"]  # the wasted prefill is kept
    _drive(sess)


def test_session_gates():
    port = _port(stream_chunk=4, new_token_buckets=[8])
    sess = port.start_session(["a"], [8])
    assert sess.capacity() == 3  # session_min_rows=4 reserves rows
    sess.step()  # 4 of 8 steps spent
    assert not sess.can_admit("b", 8)  # budget past the remaining steps
    assert sess.can_admit("b", 4) and not sess.can_admit("b", 4, lookahead_chunks=1)
    assert not sess.can_admit("x" * 50, 4)  # prompt past the prompt bucket
    with pytest.raises(ValueError, match="capacity"):
        sess.admit(["b"] * 4, [4] * 4)
    full = _port(stream_chunk=4, new_token_buckets=[8], session_min_rows=1).start_session(
        ["a"], [8])
    assert full.capacity() == 0 and not full.can_admit("b", 1)


# ------------------------------------------------------- gauges and records


LABELS = {"service": "lm", "kv_dtype": "float32"}


def _claim(name):
    return sum(r["bytes"] for r in hbm_ledger.rows() if r["subsystem"] == name)


def test_cancel_tag_frees_the_row_and_the_gauges():
    port = _port(stream_chunk=4)  # the newest engine owns the gauges' labels
    claim0 = _claim("lm.kv_cache")
    sess = port.start_session(["one", "two"], [16, 16])
    nbytes = tgpt.cache_bytes(sess._cache)
    assert nbytes == 2 * 2 * 4 * 24 * 4 * 8 * 4  # k and v [L, bb, P + new, kv, hd] f32
    gauges = {n: metrics.gauge_get(n, LABELS) for n in (
        "lm.kv_rows_active", "lm.kv_rows_allocated", "lm.kv_stranded_rows",
        "lm.kv_cache_bytes", "lm.kv_rows_per_gib")}
    assert gauges == {"lm.kv_rows_active": 2, "lm.kv_rows_allocated": 4,
                      "lm.kv_stranded_rows": 2, "lm.kv_cache_bytes": nbytes,
                      "lm.kv_rows_per_gib": round(4 * (1 << 30) / nbytes, 1)}
    assert _claim("lm.kv_cache") - claim0 == nbytes
    sess.step()
    assert sess.cancel_tag(1) and not sess.cancel_tag(1)
    assert metrics.gauge_get("lm.kv_rows_active", LABELS) == 1
    assert metrics.gauge_get("lm.kv_stranded_rows", LABELS) == 3
    assert port.stats["cancelled"] == 1 and port.stats["tokens_generated"] == 4
    assert sess.cancel_tag(0) and sess.done()  # every row cancelled
    assert metrics.gauge_get("lm.kv_rows_allocated", LABELS) == 0
    assert _claim("lm.kv_cache") == claim0
    assert port.kv_row_counts() == (0, 0) and port.pages_reserved() == 0


_KEYS = {"step": ("rows_live", "rows_capacity", "kv_rows_live", "kv_rows_allocated",
                  "steps", "sessions", "dispatches"),
         "admit": ("rows", "admit_kind", "prefix_share"), "finish": ("tokens",),
         "cancel": ()}


def test_timeline_and_usage_records_match_jax():
    jax_eng, port = _pair(**SESS)
    records = []
    for eng, tl, meter in ((jax_eng, jtimeline.engine_timeline, jusage.usage),
                           (port, ttimeline.engine_timeline, tusage.usage)):
        tl.clear()
        meter.reset()
        sess = eng.start_session(["shared prefix one", "shared prefix two"], [8, 12],
                                 tenants=["gold", "free"])
        sess.step()
        sess.admit(["shared prefix three"], [4], tenants=["gold"])
        sess.step()
        assert sess.cancel_tag(1)
        _drive(sess)
        events = [{k: e[k] for k in ("kind",) + _KEYS[e["kind"]] if k in e}
                  for e in tl.events() if e["kind"] in _KEYS]
        assert all("ttft_ms" in e for e in tl.events() if e["kind"] == "finish")
        snap = meter.snapshot()
        assert all(snap[t]["kv_row_seconds"] > 0 for t in ("gold", "free"))
        summary = tl.summary()
        records.append((events, {t: (v["tokens_in"], v.get("tokens_out", 0))
                                 for t, v in snap.items()},
                        {k: summary[k] for k in ("decode_steps", "decode_occupancy_pct",
                                                 "decode_kv_stranded_pct",
                                                 "decode_prefix_share_pct", "decode_admits",
                                                 "decode_finishes", "decode_cancels",
                                                 "decode_dispatches_per_token")}))
    assert records[1] == records[0]
    kinds = [e["kind"] for e in records[1][0]]
    assert kinds[:3] == ["admit", "step", "admit"] and "cancel" in kinds
    assert records[1][2]["decode_prefix_share_pct"] > 0


def test_usage_meter_matches_jax():
    mine, theirs = UsageMeter(max_tenants=3, registry=Metrics()), JaxUsageMeter(
        max_tenants=3, registry=JaxMetrics())
    for m in (mine, theirs):
        m.note("acme", tokens_in=10, tokens_out=4)
        m.note("acme", kv_row_seconds=0.5)
        m.note(None, embed_rows=3)
        for i in range(6):
            m.note(f"tenant-{i}", search_queries=1)
        with pytest.raises(ValueError):
            m.note("acme", bogus_kind=1)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.snapshot()["(overflow)"]["search_queries"] == 5.0
    assert (mine.registry.get("tenant.usage.tokens_in", {"tenant": "acme"})
            == theirs.registry.get("tenant.usage.tokens_in", {"tenant": "acme"}) == 10)


# ---------------------------------------------------- admission and threads


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_admit_bytes_forecast_and_can_admit(monkeypatch, kv_quant):
    port = _port(kv_quant=kv_quant)
    cfg = port.model_cfg
    T = 64 + 16  # the largest usable prompt bucket + the largest new bucket
    row = tgpt.cache_bytes(tgpt.init_cache(cfg, 1, T, torch.float32))
    assert port._admit_bytes_forecast(3) == 3 * row
    assert port.hbm_headroom_bytes() is None and port.can_admit(1000)  # CPU: no forecast
    rejects = metrics.get("lm.admit_hbm_rejects")
    monkeypatch.setattr(port, "hbm_headroom_bytes", lambda: 2 * row)
    assert port.can_admit(2) and not port.can_admit(3)
    assert metrics.get("lm.admit_hbm_rejects") == rejects + 1
    monkeypatch.setattr(port, "hbm_headroom_bytes", lambda: None)
    sess = port.start_session(["a"], [8])
    assert port.kv_rows_allocated() == sess.bb == 4
    assert port.can_admit(4, max_kv_rows=8) and not port.can_admit(5, max_kv_rows=8)
    assert port.stats["sessions"] == 1


def test_prepare_admit_runs_while_the_lock_is_held():
    """The admission prefill takes no engine lock, so it overlaps a chunk
    that holds it; the splice then waits for the lock."""
    port = _port(stream_chunk=4, new_token_buckets=[32])
    solo = port.generate("bb", 8)
    sess = port.start_session(["aa"], [24])
    sess.step()
    assert not sess.prefill_warm(1)
    out = {}
    with port._lock:  # a chunk in flight on another thread
        t = threading.Thread(target=lambda: out.setdefault("prep", sess.prepare_admit(
            ["bb"], [8], temperature=[0.0])))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "prepare_admit waited on the engine lock"
    assert sess.prefill_warm(1)
    (tag,) = sess.splice(out["prep"])
    assert _drive(sess)[tag] == solo


def test_sampled_sessions_repeat_under_one_seed():
    """A session samples from a generator of its own: the same seed gives
    the same rows, and a sampled batch between its chunks changes nothing."""
    a, b = (_port(temperature=1.0, top_k=20, stream_chunk=4) for _ in range(2))
    prompts, wants = ["one", "two", "three"], [16, 12, 16]
    quiet = _drive(a.start_session(prompts, wants))
    sess = b.start_session(prompts, wants)
    busy = dict(sess.step())
    b.generate_batch(["noise"] * 3, [16] * 3)
    busy.update(_drive(sess))
    assert busy == quiet and len(set(quiet.values())) == 3
    assert _drive(a.start_session(prompts, wants)) != quiet  # the draw moved on


def test_session_config_is_the_jax_engines():
    jax_eng, port = _pair(**SESS)
    for field in ("stream_chunk", "session_min_rows", "gen_max_batch",
                  "gen_flush_deadline_ms", "gen_tenant_lane_depth"):
        assert getattr(port.config, field) == getattr(jax_eng.config, field), field
    assert dataclasses.asdict(port.model_cfg) == dataclasses.asdict(jax_eng.model_cfg)
