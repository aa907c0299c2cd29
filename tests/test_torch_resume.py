"""Durable generation on the port's LmEngine against the JAX engine's, on
the CPU at float32 on the same weights (tests/test_torch_lm.py's `_pair`):
a greedy stream journalled by the port and killed at a chunk boundary
resumes from its tail, on a fresh engine, to the JAX engine's resume of the
same tail delta for delta and to the port's own uninterrupted stream token
for token, under dense, paged and paged int8 KV; the adopter journals the
orphan before its first delta and counts `gen.resumes`; a tail taken in
the speculative state (its pending token, its slot margin) resumes to the
JAX resume and to the spec-off stream; a sampled stream resumes on an
engine of another seed to the uninterrupted stream of its own seed, and a
JAX sampled tail (a threefry key) is refused; `BatchSession` rows journal
the records JAX's rows journal, admitted rows too, and a cancel marks its
row done."""

import pytest

from symbiont_tpu.resilience.genlog import GenJournal as JaxGenJournal
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.resilience.genlog import GenJournal
from symbiont_tpu_torch.utils.telemetry import metrics
from tests.test_torch_lm import _pair, _port
from tests.test_torch_spec import _pair_spec

STREAM = dict(stream_chunk=4, new_token_buckets=[8, 16], prompt_buckets=[8, 16, 64])
PROMPT = "the quick brown fox jumps"
LAYOUTS = [("dense", "none"), ("paged", "none"), ("paged", "int8")]


@pytest.fixture(scope="module", params=LAYOUTS, ids=["dense", "paged", "paged-int8kv"])
def engines(request):
    layout, kv_quant = request.param
    return _pair("llama", 2, **STREAM, kv_layout=layout, kv_quant=kv_quant, kv_page_tokens=8)


def _journalled(eng, journal, prompt, max_new, task_id, kill_after=None, **kw):
    """Stream with `journal` attached; with `kill_after`, abandon the stream
    once that many deltas arrived (nothing after the kill's journal append
    runs: the SIGKILL's stand-in). → the deltas received."""
    eng.journal = journal
    got = []
    try:
        gen = eng.generate_stream(prompt, max_new, task_id=task_id, **kw)
        for delta in gen:
            got.append(delta)
            if kill_after is not None and len(got) >= kill_after:
                gen.close()
                break
    finally:
        eng.journal = None
    return got


def _resume(eng, rec, journal=None):
    eng.journal = journal
    try:
        return list(eng.generate_stream("", rec["max_new"], temperature=rec["temperature"],
                                        top_k=rec["top_k"], task_id=rec["task_id"],
                                        stream=rec["stream"], resume=rec))
    finally:
        eng.journal = None


@pytest.mark.parametrize("kill_after", [1, 2])
def test_greedy_resume_matches_jax_and_the_uninterrupted_stream(engines, tmp_path, kill_after):
    jax_eng, port = engines
    ref_j = GenJournal(tmp_path / "ref.genlog")
    ref = "".join(_journalled(port, ref_j, PROMPT, 16, "ref"))
    assert ref == "".join(jax_eng.generate_stream(PROMPT, 16))
    ref_tokens = ref_j.live_tails()["ref"]["tokens"]
    assert len(ref_tokens) == 16

    _journalled(port, GenJournal(tmp_path / "dead.genlog"), PROMPT, 16, "kill-me",
                kill_after=kill_after)
    rec = GenJournal.take_orphans(tmp_path / "dead.genlog")["kill-me"]
    assert rec["key"] is None and len(rec["tokens"]) == 4 * kill_after
    assert rec["seq"] == kill_after - 1  # the last chunk's seq: it replays

    adopted = GenJournal(tmp_path / "adopter.genlog")
    resumes0 = metrics.get("gen.resumes")
    deltas = _resume(port, rec, adopted)
    assert deltas == _resume(jax_eng, rec)
    assert rec["text"] + "".join(deltas) == ref
    assert adopted.live_tails()["kill-me"]["tokens"] == ref_tokens
    assert metrics.get("gen.resumes") == resumes0 + 1


def test_the_adopter_journals_the_orphan_before_its_first_delta(engines, tmp_path):
    _, port = engines
    _journalled(port, GenJournal(tmp_path / "dead.genlog"), PROMPT, 16, "t", kill_after=2)
    rec = GenJournal.take_orphans(tmp_path / "dead.genlog")["t"]
    adopted = GenJournal(tmp_path / "adopter.genlog")
    port.journal = adopted
    try:
        gen = port.generate_stream("", rec["max_new"], task_id="t", resume=rec)
        first = next(gen)  # the replayed last chunk
        tail = adopted.live_tails()["t"]
        assert tail["tokens"] == rec["tokens"] and tail["seq"] == rec["seq"]
        assert rec["text"] + first == "".join(_journalled(port, None, PROMPT, 8, "x"))
        gen.close()
    finally:
        port.journal = None
    ev = [e for e in engine_timeline.events() if e["kind"] == "resume"][-1]
    assert ev["tokens"] == len(rec["tokens"]) and ev["prefill_ms"] > 0


def test_spec_state_resume_matches_jax_and_spec_off(tmp_path):
    jax_eng, port, off = _pair_spec(prompt_buckets=[16, 64])
    prompt = "the quick brown fox"
    ref = "".join(off.generate_stream(prompt, 24, temperature=0.0))
    _journalled(port, GenJournal(tmp_path / "dead.genlog"), prompt, 24, "s", kill_after=1,
                temperature=0.0)
    rec = GenJournal.take_orphans(tmp_path / "dead.genlog")["s"]
    assert rec["spec"] is True and rec["spec_slots"] is not None  # pending + margin
    deltas = _resume(port, rec)
    assert deltas == _resume(jax_eng, rec)
    assert rec["text"] + "".join(deltas) == ref


SAMPLED = dict(STREAM, temperature=0.8, top_k=8)


def test_sampled_resume_on_another_seed_matches_the_uninterrupted_stream(tmp_path):
    prompt = "sampling is stochastic"
    ref = "".join(_port(seed=7, **SAMPLED).generate_stream(prompt, 16))
    _journalled(_port(seed=7, **SAMPLED), GenJournal(tmp_path / "s.genlog"), prompt, 16, "s",
                kill_after=2)
    rec = GenJournal.take_orphans(tmp_path / "s.genlog")["s"]
    assert len(rec["key"]) == 1 and rec["key_splits"] == 2
    other = _port(seed=99, **SAMPLED)
    assert "".join(other.generate_stream(prompt, 16)) != ref  # another seed, other text
    assert rec["text"] + "".join(_resume(other, rec)) == ref


def test_a_sampled_tail_of_the_jax_engine_is_refused(engines, tmp_path):
    jax_eng, port = engines
    jax_eng.journal = JaxGenJournal(tmp_path / "j.genlog")
    try:
        gen = jax_eng.generate_stream(PROMPT, 16, temperature=0.8, top_k=8, task_id="j")
        next(gen)
        gen.close()
    finally:
        jax_eng.journal = None
    rec = JaxGenJournal.take_orphans(tmp_path / "j.genlog")["j"]
    assert len(rec["key"]) == 2  # threefry key data
    with pytest.raises(ValueError, match="package"):
        _resume(port, rec)


def _session_records(eng, journal, task_ids, cancel_row=None):
    eng.journal = journal
    try:
        s = eng.start_session(["hello", "a longer prompt here"], [12, 12], temperature=0.0,
                              task_ids=task_ids)
        s.step()
        first = journal.live_tails()
        if cancel_row is not None:
            assert s.cancel_tag(s.rows[cancel_row].tag)
        while not s.done():
            s.step()
        s._drain_all()
        return first, journal.live_tails()
    finally:
        eng.journal = None


def test_session_rows_journal_as_jax_rows_do_and_a_cancel_marks_done(engines, tmp_path):
    jax_eng, port = engines
    ids = ["row-a", "row-b"]
    j_first, j_last = _session_records(jax_eng, JaxGenJournal(tmp_path / "j.genlog"), ids)
    t_first, t_last = _session_records(port, GenJournal(tmp_path / "t.genlog"), ids)
    keys = ("stream", "prompt_ids", "max_new", "temperature", "top_k", "tokens", "chunk_start",
            "seq", "key", "key_splits", "spec")
    for want, got in ((j_first, t_first), (j_last, t_last)):
        assert set(got) == set(ids)
        assert {t: {k: got[t][k] for k in keys} for t in ids} == \
            {t: {k: want[t][k] for k in keys} for t in ids}
    assert t_first["row-a"]["stream"] is False and t_first["row-a"]["prompt_ids"]
    # finished rows stay journalled (the service marks them done once
    # their result is published); a cancelled row is done at once
    _, after_cancel = _session_records(port, GenJournal(tmp_path / "c.genlog"), ids,
                                       cancel_row=1)
    assert set(after_cancel) == {"row-a"}


def test_admitted_rows_journal_their_prompt(engines, tmp_path):
    _, port = engines
    journal = port.journal = GenJournal(tmp_path / "a.genlog")
    try:
        s = port.start_session(["hello"], [12], temperature=0.0, task_ids=["first"])
        s.step()
        prep = s.prepare_admit(["newcomer"], [8], temperature=0.0, task_ids=["late"])
        assert s.splice(prep) != [None]
        s.step()
        tail = journal.live_tails()["late"]
        # the exact ids the admission prefilled: the tail that fits the
        # session's prompt bucket
        assert tail["prompt_ids"] == port.tokenizer.encode("newcomer", 64)[-s.P:]
        assert 1 <= len(tail["tokens"]) <= 8
        while not s.done():
            s.step()
    finally:
        port.journal = None
