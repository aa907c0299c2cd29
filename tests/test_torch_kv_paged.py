"""The port's paged KV (symbiont_tpu_torch/kv/, the paged branches of
models/gpt.py and engine/lm.py) against the JAX package on the CPU:

- the page pool and the radix cache: the JAX unit cases, and one random
  sequence of operations run on both copies with equal results;
- `flat_slot_index`, `scatter_prompt`, `merge_row_state` and a paged
  `merge_rows` bit-equal to JAX's on the same inputs (pool pages past the
  scratch page, which holds whichever duplicate write lands last);
- engines on the same weights (tests/test_torch_lm.py's `_pair`, f32): a
  paged session with an admission and a cancel token-identical to the
  port's dense one and to JAX's paged one, kv_quant none and int8;
  `generate_batch` and streams; radix hits (a full hit runs no prefill, a
  partial one shares pages); pages and gauges back at baseline after a
  cancel; `update_params` clearing the radix cache; the `can_admit` page
  boundary; a splice refused once the budget is gone."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.kv import paged as jpaged
from symbiont_tpu.kv.pool import PagePool as JaxPagePool
from symbiont_tpu.kv.radix import RadixCache as JaxRadixCache
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.obs import engine_timeline as jtimeline
from symbiont_tpu.utils.telemetry import Metrics as JaxMetrics
from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.engine.lm import LmEngine
from symbiont_tpu_torch.kv import paged
from symbiont_tpu_torch.kv.pool import PagePool, PoolExhausted, register_zero_gauges
from symbiont_tpu_torch.kv.radix import RadixCache
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.obs import engine_timeline as ttimeline
from symbiont_tpu_torch.utils.telemetry import Metrics, metrics
from tests.test_torch_lm import _pair

PAGED = dict(prompt_buckets=[16, 64], new_token_buckets=[32], kv_page_tokens=16,
             stream_chunk=4, session_min_rows=4, gen_max_batch=4)


def _drain(sess) -> dict:
    out = {}
    while not sess.done():
        out.update(sess.step())
    out.update(sess._drain_all())
    return out


# ------------------------------------------------------------------ the pool


def _pool(n_pages=8, page=4, registry=None, cls=PagePool):
    kw = dict(num_layers=1, n_pages=n_pages, page_tokens=page, kv_heads=2, head_dim=4,
              quantized=False, dtype_label="f32")
    if cls is PagePool:
        return PagePool(dtype=torch.float32, registry=registry or Metrics(), device="cpu", **kw)
    return cls(dtype=np.float32, registry=registry or JaxMetrics(), **kw)


def test_pool_alloc_release_refcount():
    pool = _pool(n_pages=5)
    pages = pool.alloc(3)
    assert len(set(pages)) == 3 and 0 not in pages  # scratch never handed out
    assert pool.pages_free == 1 and pool.pages_live == 3
    pool.retain(pages[0])  # a second row maps the same page
    pool.release(pages[0])
    assert pool.pages_live == 3
    for pid in pages:
        pool.release(pid)
    assert pool.pages_live == 0 and pool.pages_free == 4
    with pytest.raises(AssertionError):
        pool.release(pages[0])  # a double release is a fault, not a no-op


def test_pool_committed_pages_retained_then_lru_evicted():
    reg = Metrics()
    pool = _pool(n_pages=5, registry=reg)
    a, b, c = pool.alloc(3)
    for pid in (a, b):
        pool.commit(pid)
    for pid in (a, b, c):
        pool.release(pid)
    assert pool.pages_retained == 2 and pool.pages_free == 2
    pool.touch(a)  # b becomes the least recently used
    got = pool.alloc(3)  # more than free: evicts b
    assert len(got) == 3 and b in got and a not in got
    assert reg.get("kv.radix_evictions", pool.labels) == 1


def test_pool_exhausted_after_evicting_everything():
    pool = _pool(n_pages=4)
    held = pool.alloc(3)
    with pytest.raises(PoolExhausted):
        pool.alloc(1)
    pool.release(held[0])
    assert pool.alloc(1)


def test_pool_bytes_gauges_and_zero_registration():
    reg = Metrics()
    register_zero_gauges("float32", "int8", registry=reg)
    labels = {"service": "lm", "kv_dtype": "int8"}
    assert reg.gauge_get("kv.pages_free", labels) == 0.0
    pool = PagePool(2, 6, 4, 2, 8, torch.float32, quantized=True, dtype_label="int8",
                    registry=reg, device="cpu")
    assert pool.k.dtype == torch.int8 and pool.k_scale.shape == (2, 6, 4, 2)
    assert pool.device_bytes == 2 * (2 * 6 * 4 * 2 * 8) + 2 * 4 * (2 * 6 * 4 * 2)
    assert reg.gauge_get("kv.pages_free", labels) == 5  # the pool's reader took over
    assert not pool.k.any() and not pool.k_scale.any()  # zeroed


def test_radix_match_commit_fork_and_eviction():
    pool = _pool(n_pages=16, page=4)
    radix = RadixCache(pool, page_tokens=4)
    P, pad = 8, 0
    row1 = np.arange(1, 9, dtype=np.int32)  # blocks (1,2,3,4), (5,6,7,8)
    pages1 = pool.alloc(2)
    logits = np.full(11, 7.0, np.float32)
    radix.commit(P, pad, row1, pages1, logits)
    m = radix.match(P, pad, row1)  # a full hit: both pages and the logits
    assert m.blocks == 2 and m.pages == pages1 and m.logits[0] == 7.0
    assert radix.peek(P, pad, row1) == 8
    # the copy-on-write fork at block 1
    row2 = row1.copy()
    row2[4:] = 9
    m2 = radix.match(P, pad, row2)
    assert m2.blocks == 1 and m2.pages == [pages1[0]] and m2.logits is None
    fork = pool.alloc(1)[0]
    radix.commit(P, pad, row2, [pages1[0], fork], logits)
    assert radix.match(P, pad, row2).blocks == 2
    assert radix.match(P, pad + 1, row1).blocks == 0  # another pad, another trie
    for pid in pages1 + [fork]:
        pool.release(pid)
    radix.forget_page(pages1[0])  # the shared root page: both branches go
    assert radix.match(P, pad, row1).blocks == 0 and radix.match(P, pad, row2).blocks == 0
    assert radix.stats["committed_pages"] == 0 and pool.pages_retained == 0


def test_pool_and_radix_follow_jax_through_a_random_sequence():
    """One seeded sequence of allocations, retains, releases, commits,
    matches, evictions and clears, applied to the JAX copy and the port's:
    every return value and counter agrees."""
    rng = np.random.default_rng(11)
    pools = [_pool(n_pages=12, page=4), _pool(n_pages=12, page=4, cls=JaxPagePool)]
    radixes = [RadixCache(pools[0], 4), JaxRadixCache(pools[1], 4)]
    held: list = []  # (pid) refs held by "rows", mirrored on both
    prompts = [rng.integers(1, 5, 8).astype(np.int32) for _ in range(4)]
    trace = [[], []]
    for step in range(400):
        op = rng.integers(0, 6)
        if op == 0:
            n = int(rng.integers(1, 4))
            outs = []
            for pool in pools:
                try:
                    outs.append(pool.alloc(n))
                except Exception as e:
                    outs.append(type(e).__name__)
            assert str(outs[0]) == str(outs[1]) or outs[0] == outs[1], step
            if isinstance(outs[0], list):
                held += outs[0]
        elif op == 1 and held:
            pid = held.pop(int(rng.integers(len(held))))
            for pool in pools:
                pool.release(pid)
        elif op == 2 and held:
            pid = held[int(rng.integers(len(held)))]
            for pool in pools:
                pool.retain(pid)
            held.append(pid)
        elif op == 3 and len(held) >= 2:
            row = prompts[int(rng.integers(len(prompts)))]
            pages = [held[int(rng.integers(len(held)))] for _ in range(2)]
            for radix in radixes:
                radix.commit(8, 0, row, pages, np.ones(3, np.float32))
        elif op == 4:
            row = prompts[int(rng.integers(len(prompts)))]
            for t, radix in zip(trace, radixes):
                m = radix.match(8, 0, row)
                t.append((m.pages, None if m.logits is None else m.logits.tolist()))
        elif op == 5 and rng.random() < 0.1:
            for radix in radixes:
                radix.clear()
        for t, pool, radix in zip(trace, pools, radixes):
            t.append((pool.pages_free, pool.pages_live, pool.pages_retained,
                      dict(radix.stats)))
    assert trace[0] == trace[1]


# -------------------------------------------------------- device-side ops


def _pools_np(rng, quant: bool, L=2, NP=9, page=4, kvh=2, hd=8):
    shape = (L, NP, page, kvh, hd)
    if quant:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.random(shape[:-1], np.float32), rng.random(shape[:-1], np.float32))
    empty = np.zeros((L, 0, page, kvh), np.float32)
    return (rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32),
            empty, empty.copy())


def test_flat_slot_index_matches_jax():
    pt = np.array([[3, 1, 0], [2, 5, 4]], np.int32)
    slots = np.arange(11)
    want = np.asarray(jpaged.flat_slot_index(jnp.asarray(pt), jnp.asarray(slots), 4))
    got = paged.flat_slot_index(torch.from_numpy(pt).long(), torch.from_numpy(slots), 4)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
def test_scatter_prompt_matches_jax_in_place(quant):
    rng = np.random.default_rng(3 + quant)
    pools = _pools_np(rng, quant)
    L, B2, T, P = 2, 3, 12, 8
    staged_np = _pools_np(rng, quant, NP=B2, page=T)  # [L, B2, T, ...] as a dense cache
    # row 0 fresh in both blocks, row 1's block 0 shared (scratch), row 2 not admitted
    table = np.array([[4, 7], [0, 2], [0, 0]], np.int64)
    jcls, tcls = (jgpt.QuantKVCache, tgpt.QuantKVCache) if quant else (jgpt.KVCache, tgpt.KVCache)
    fields = staged_np if quant else staged_np[:2]
    want = jpaged.scatter_prompt(*map(jnp.asarray, pools),
                                 jcls(*map(jnp.asarray, fields), jnp.asarray(P, jnp.int32)),
                                 jnp.asarray(table, jnp.int32), P)
    tpools = [torch.from_numpy(a.copy()) for a in pools]
    got = paged.scatter_prompt(*tpools, tcls(*[torch.from_numpy(a) for a in fields], P),
                               torch.from_numpy(table), P)
    assert all(g is t for g, t in zip(got, tpools))  # in place
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])  # past scratch
    assert np.array_equal(tpools[0].numpy()[:, 4], staged_np[0][:, 0, :4])


def test_merge_row_state_matches_jax_in_place():
    rng = np.random.default_rng(5)
    B, Bb, T, P, length = 4, 2, 20, 8, 13

    def state(rows):
        return (rng.standard_normal((rows, 33), np.float32),
                rng.integers(1, P, rows).astype(np.int64), rng.random(rows) < 0.3,
                rng.random((rows, T)) < 0.8)

    a, b = state(B), state(Bb)
    row_map = np.array([-1, 1, -1, 0])
    want = jpaged.merge_row_state(*map(jnp.asarray, a), *map(jnp.asarray, b),
                                  jnp.asarray(row_map, jnp.int32), jnp.asarray(length),
                                  prompt_width=P)
    ta = [torch.from_numpy(x.copy()) for x in a]
    got = paged.merge_row_state(*ta, *[torch.from_numpy(x) for x in b], row_map, length, P)
    assert all(g is t for g, t in zip(got, ta))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
def test_paged_merge_rows_matches_jax(quant):
    """gpt.merge_rows on a PagedKVCache: the staged rows' fresh blocks land
    in the pool, the row state merges with its gap masked, the new page
    table is the session's; bit-equal to the JAX package's."""
    rng = np.random.default_rng(7 + quant)
    pools = _pools_np(rng, quant)
    B, Bb, P, length, n_blocks = 4, 2, 8, 13, 5
    T = 20
    staged_np = _pools_np(rng, quant, NP=Bb, page=T)
    fields = staged_np if quant else staged_np[:2]
    row_map = np.array([-1, 1, -1, 0])
    scatter = np.array([[3, 6], [0, 8]], np.int64)
    page_table = rng.integers(1, 9, (B, n_blocks)).astype(np.int64)
    a = (rng.standard_normal((B, 33), np.float32), rng.integers(1, P, B).astype(np.int64),
         rng.random(B) < 0.3, rng.random((B, T)) < 0.8)
    b = (rng.standard_normal((Bb, 33), np.float32), rng.integers(1, P, Bb).astype(np.int64),
         np.zeros(Bb, bool), rng.random((Bb, T)) < 0.8)
    jcls, tcls = (jgpt.QuantKVCache, tgpt.QuantKVCache) if quant else (jgpt.KVCache, tgpt.KVCache)
    jcache = jpaged.PagedKVCache(*map(jnp.asarray, pools), jnp.asarray(page_table, jnp.int32),
                                 jnp.asarray(length, jnp.int32))
    want = jgpt.merge_rows(jcache, *map(jnp.asarray, a),
                           (jcls(*map(jnp.asarray, fields), jnp.asarray(P, jnp.int32)),
                            jnp.asarray(scatter, jnp.int32), jnp.asarray(page_table, jnp.int32)),
                           *map(jnp.asarray, b), jnp.asarray(row_map, jnp.int32),
                           prompt_width=P)
    tpools = [torch.from_numpy(x.copy()) for x in pools]
    tcache = paged.PagedKVCache(*tpools, torch.from_numpy(page_table), length)
    ta = [torch.from_numpy(x.copy()) for x in a]
    got = tgpt.merge_rows(tcache, *ta, (tcls(*[torch.from_numpy(x) for x in fields], P),
                                        torch.from_numpy(scatter), torch.from_numpy(page_table)),
                          *[torch.from_numpy(x) for x in b], row_map, prompt_width=P)
    assert got[0].length == length and all(g is t for g, t in zip(got[0][:4], tpools))
    for g, w in zip(got[0][:4], want[0][:4]):
        assert np.array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])
    assert np.array_equal(got[0].page_table.numpy(), page_table)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- engines


@pytest.fixture(scope="module", params=["none", "int8"], ids=["f32kv", "int8kv"])
def paged_pair(request):
    jax_eng, port = _pair(**PAGED, kv_quant=request.param, kv_layout="paged")
    dense = LmEngine(dataclasses.replace(port.config, kv_layout="dense"), params=port.params,
                     model_cfg=port.model_cfg, device="cpu")
    flash = LmEngine(dataclasses.replace(port.config, attn_impl="flash"), params=port.params,
                     model_cfg=port.model_cfg, device="cpu")
    return jax_eng, port, dense, flash


def _admit_and_cancel(eng) -> dict:
    sess = eng.start_session(["hello world this is a test"], [12], temperature=0.0)
    out = {}
    for _ in range(2):
        out.update(sess.step())
    assert None not in sess.admit(["the quick brown fox"], [8], temperature=0.0)
    victim = sess.admit(["to be cancelled"], [20], temperature=0.0)[0]
    assert sess.cancel_tag(victim)
    out.update(_drain(sess))
    return out


def test_paged_session_matches_dense_and_jax(paged_pair):
    jax_eng, port, dense, flash = paged_pair
    want = _admit_and_cancel(dense)
    assert _admit_and_cancel(port) == want
    assert _admit_and_cancel(flash) == want  # the flash prefill's plain version
    assert _admit_and_cancel(jax_eng) == want
    assert port.pool.pages_live == 0  # every row returned its pages


def test_paged_generate_batch_and_stream_match_dense(paged_pair):
    jax_eng, port, dense, _ = paged_pair
    prompts = ["hello world this is a test", "the quick brown fox"]
    want = dense.generate_batch(prompts, [8, 8], temperature=0.0)
    assert port.generate_batch(prompts, [8, 8], temperature=0.0) == want
    assert jax_eng.generate_batch(prompts, [8, 8], temperature=0.0) == want
    stream = "".join(port.generate_stream("stream me please", 12, temperature=0.0))
    assert stream == "".join(dense.generate_stream("stream me please", 12, temperature=0.0))


def _paged_port(**kw):
    return _pair(**{**PAGED, "kv_layout": "paged", **kw})[1]


def test_full_radix_hit_runs_no_prefill(monkeypatch):
    port = _paged_port()
    cold = _drain(port.start_session(["repeat prompt radix"], [8], temperature=0.0))
    assert port.radix.stats["committed_pages"] > 0
    calls = []
    real = tgpt.prefill
    monkeypatch.setattr(tgpt, "prefill", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ttimeline.engine_timeline.clear()
    sess = port.start_session(["repeat prompt radix"], [8], temperature=0.0)
    assert sess.rows[0].radix_hit and calls == []
    assert _drain(sess) == cold
    assert port.radix.stats["full_hits"] == 1
    summ = ttimeline.engine_timeline.summary()
    assert summ["decode_radix_hit_pct"] == 100.0 and summ["decode_ttft_hit_ms_p50"] > 0
    assert summ["decode_pages_live_pct"] > 0


def test_partial_radix_hit_shares_pages():
    port = _paged_port()
    _drain(port.start_session(["repeat prompt radix"], [8], temperature=0.0))
    committed = port.radix.stats["committed_pages"]
    # same length, divergent tail: the fork commits only the fresh blocks
    _drain(port.start_session(["repeat prompt RADIX"], [8], temperature=0.0))
    assert port.radix.stats["hits"] >= 1
    assert 0 < port.radix.stats["committed_pages"] - committed < committed


def test_paged_timeline_and_hits_match_jax():
    """The radix hit counts and the timeline's paged records on one
    schedule (a cold start, then a full hit and a partial one admitted)."""
    jax_eng, port = _pair(**PAGED, kv_layout="paged")
    records = []
    for eng, tl in ((jax_eng, jtimeline.engine_timeline), (port, ttimeline.engine_timeline)):
        tl.clear()
        _drain(eng.start_session(["repeat prompt radix", "second row"], [8, 8]))
        sess = eng.start_session(["repeat prompt radix"], [12])
        sess.step()
        sess.admit(["repeat prompt RADIX"], [4])
        _drain(sess)
        events = [{k: e[k] for k in ("kind", "rows", "hit_tokens", "prompt_tokens", "pages_live",
                                     "pages_free", "pages_total", "radix_hit") if k in e}
                  for e in tl.events() if e["kind"] in ("admit", "step", "finish")]
        summ = tl.summary()
        records.append((events, dict(eng.radix.stats),
                        {k: summ[k] for k in ("decode_radix_hit_pct", "decode_pages_live_pct")}))
    assert records[1] == records[0]


def test_cancel_returns_pages_and_gauges_reach_baseline():
    port = _paged_port(kv_radix=False)
    labels = {"service": "lm", "kv_dtype": "float32"}
    total = port.pool.pages_free
    sess = port.start_session(["first prompt here"], [16], temperature=0.0)
    sess.step()  # decode blocks past the prompt exist now
    tag = sess.admit(["second prompt joins"], [8], temperature=0.0)[0]
    assert port.pool.pages_live > 0 and port.pages_reserved() > 0
    assert metrics.gauge_get("kv.pages_live", labels) == port.pool.pages_live
    assert metrics.gauge_get("lm.kv_stranded_rows", labels) == 0  # paged rows hold pages
    assert 0 < metrics.gauge_get("kv.page_fragmentation_pct", labels) < 100
    assert sess.cancel_tag(tag)
    for t in [r.tag for r in sess.rows if r is not None]:
        sess.cancel_tag(t)
    assert port.pool.pages_live == 0 and port.pool.pages_free == total
    assert port.kv_row_counts() == (0, 0)
    assert metrics.gauge_get("kv.pages_free", labels) == total


def test_update_params_clears_radix():
    port = _paged_port()
    _drain(port.start_session(["repeat prompt radix"], [8], temperature=0.0))
    assert port.radix.stats["committed_pages"] > 0
    port.update_params(port.params)
    assert port.radix.stats["committed_pages"] == 0 and port.pool.pages_retained == 0


def test_can_admit_page_accounting_boundary():
    # 1 row a session, P 16 + new 32 = 3 blocks; 4 usable pages hold one
    port = _paged_port(session_min_rows=1, gen_max_batch=1, prompt_buckets=[16],
                       kv_pool_pages=5, kv_radix=False)
    assert port.can_admit(1, 0)
    sess = port.start_session(["hold the pool"], [32], temperature=0.0)
    assert not port.can_admit(1, 0)  # 3 reserved + 1 free < 3 needed
    _drain(sess)
    assert port.can_admit(1, 0)


def test_can_admit_radix_hit_needs_fewer_pages():
    port = _paged_port(session_min_rows=1, gen_max_batch=1, prompt_buckets=[16],
                       kv_pool_pages=6)
    _drain(port.start_session(["warm this prompt"], [32], temperature=0.0))
    # 5 usable pages, 1 committed and retained; hold 3: a cold admission
    # (3 fresh, 2 available) is refused, the warm one (1 shared + 2) fits
    held = port.pool.alloc(3)
    assert port.can_admit(1, 0, prompts=["warm this prompt"], max_new_tokens=[32])
    assert not port.can_admit(1, 0, prompts=["cold prompt here"], max_new_tokens=[32])
    assert port._pages_needed(1) == 3
    for pid in held:
        port.pool.release(pid)


def test_paged_splice_refused_when_the_budget_is_gone():
    port = _paged_port()
    sess = port.start_session(["hello world this is a test"], [8], temperature=0.0)
    prep = sess.prepare_admit(["late arrival"], [32])
    while not sess.done():
        sess.step()
    assert sess.splice(prep) == [None]  # refused, not truncated
    assert port.pool.pages_live == 0  # the refusal leaked nothing


def test_pool_bytes_claim_replaces_the_dense_claim():
    from symbiont_tpu_torch.obs.hbm import hbm_ledger

    port = _paged_port()
    rows = {r["subsystem"]: r for r in hbm_ledger.rows()}
    assert rows["kv.page_pool"]["bytes"] >= port.pool.device_bytes
    assert rows["kv.radix_retained"]["overlay"]
    labels = {"service": "lm", "kv_dtype": "float32"}
    assert metrics.gauge_get("lm.kv_cache_bytes", labels) == port.pool.device_bytes
    # auto sizing: one session batch at the largest buckets, x2, + scratch
    assert port.pool.n_pages == 2 * 4 * -(-(64 + 32) // 16) + 1
