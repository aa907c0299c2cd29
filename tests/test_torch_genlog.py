"""The port's generation journal (`resilience/genlog.py`) and the
supervisor's rescue of a dead worker's tails, case for case with the JAX
package's: round trip and survivor reload, a record without task id
dropped, max_tasks eviction, compaction under max_bytes, a torn last line
skipped, degrade-on-write-error, `take_orphans` rotating the file aside,
and `ProcessSupervisor._rescue_gen_orphans` republishing the live tails
(and skipping without a journal env or a bus). Every case runs on both
packages (`pkg`), so one behaviour counts for each; a greedy tail written by
either package's journal reads the same in the other's."""

import asyncio
import json
import types

import pytest

import symbiont_tpu.resilience.genlog as jgenlog
import symbiont_tpu.resilience.procsup as jprocsup
import symbiont_tpu.subjects as jsubjects
import symbiont_tpu.utils.telemetry as jtelemetry
import symbiont_tpu_torch.resilience.genlog as tgenlog
import symbiont_tpu_torch.resilience.procsup as tprocsup
import symbiont_tpu_torch.subjects as tsubjects
import symbiont_tpu_torch.utils.telemetry as ttelemetry

PACKAGES = {
    "jax": types.SimpleNamespace(genlog=jgenlog, procsup=jprocsup, subjects=jsubjects,
                                 metrics=jtelemetry.metrics),
    "port": types.SimpleNamespace(genlog=tgenlog, procsup=tprocsup, subjects=tsubjects,
                                  metrics=ttelemetry.metrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _rec(task_id, tokens, seq=0, **kw):
    base = dict(task_id=task_id, tenant="t", stream=True, prompt_ids=[1, 2, 3], max_new=16,
                temperature=0.0, top_k=0, tokens=list(tokens),
                chunk_start=max(0, len(tokens) - 4), text="", seq=seq, key=None, key_splits=0)
    base.update(kw)
    return base


def test_journal_round_trip_and_survivor_reload(pkg, tmp_path):
    path = tmp_path / "gen.genlog"
    j = pkg.genlog.GenJournal(path)
    j.append(_rec("a", [5, 6]))
    j.append(_rec("a", [5, 6, 7, 8], seq=1))
    j.append(_rec("b", [9]))
    assert len(j) == 2
    tails = j.live_tails()
    assert tails["a"]["tokens"] == [5, 6, 7, 8] and tails["a"]["seq"] == 1  # last wins
    j.mark_done("a")
    assert "a" not in j.live_tails()
    j.mark_done("a")  # idempotent
    j.mark_done("never-seen")
    assert set(pkg.genlog.GenJournal(path).live_tails()) == {"b"}


def test_record_without_task_id_is_dropped(pkg, tmp_path):
    j = pkg.genlog.GenJournal(tmp_path / "g.genlog")
    j.append({"tokens": [1]})
    assert len(j) == 0


def test_max_tasks_evicts_the_oldest(pkg, tmp_path):
    j = pkg.genlog.GenJournal(tmp_path / "g.genlog", max_tasks=3)
    for i in range(5):
        j.append(_rec(f"t{i}", [i]))
    assert len(j) == 3 and set(j.live_tails()) == {"t2", "t3", "t4"}


def test_compaction_bounds_the_file(pkg, tmp_path):
    path = tmp_path / "g.genlog"
    j = pkg.genlog.GenJournal(path, max_bytes=2000)
    for i in range(100):
        j.append(_rec("hot", list(range(i % 8))))
    assert path.stat().st_size < 2000
    assert set(j.live_tails()) == {"hot"}
    assert set(pkg.genlog.GenJournal.take_orphans(path)) == {"hot"}


def test_torn_last_line_is_skipped(pkg, tmp_path):
    path = tmp_path / "g.genlog"
    pkg.genlog.GenJournal(path).append(_rec("ok", [1, 2]))
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"task_id": "torn", "tok')  # a SIGKILL in the append
    assert set(pkg.genlog.GenJournal.take_orphans(path)) == {"ok"}


def test_write_error_disables_the_journal(pkg, tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("x")  # the journal's parent is a file: open() fails
    j = pkg.genlog.GenJournal(blocker / "g.genlog")
    before = pkg.metrics.get("gen.journal_errors", 0)
    j.append(_rec("a", [1]))
    assert j.enabled is False
    assert pkg.metrics.get("gen.journal_errors", 0) == before + 1
    j.append(_rec("b", [2]))  # a no-op now; decoding goes on
    assert len(j) == 0


def test_take_orphans_rotates_the_file_aside(pkg, tmp_path):
    path = tmp_path / "g.genlog"
    j = pkg.genlog.GenJournal(path)
    j.append(_rec("live", [1]))
    j.append(_rec("finished", [2]))
    j.mark_done("finished")
    assert set(pkg.genlog.GenJournal.take_orphans(path)) == {"live"}
    assert not path.exists() and path.with_suffix(".genlog.orphaned").exists()
    assert pkg.genlog.GenJournal.take_orphans(path) == {}  # a second verdict: nothing


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_greedy_tail_reads_the_same_in_both_packages(tmp_path, writer, reader):
    path = tmp_path / "x.genlog"
    w = PACKAGES[writer].genlog.GenJournal(path)
    w.append(_rec("g", [4, 5, 6], seq=2, text="ab"))
    w.append(_rec("done", [1]))
    w.mark_done("done")
    tails = PACKAGES[reader].genlog.GenJournal.take_orphans(path)
    want = _rec("g", [4, 5, 6], seq=2, text="ab")
    assert set(tails) == {"g"} and {k: tails["g"][k] for k in want} == want


class _StubBus:
    def __init__(self):
        self.published = []

    async def publish(self, subject, data, headers=None):
        self.published.append((subject, data))


def _gen_worker(pkg, tmp_path, role="genw"):
    return pkg.procsup._Worker(pkg.procsup.WorkerSpec(
        role=role, argv=["true"],
        env={"SYMBIONT_GEN_JOURNAL_ENABLED": "1", "SYMBIONT_GEN_JOURNAL_DIR": str(tmp_path),
             "SYMBIONT_RUNNER_ROLE": role}))


def test_rescue_republishes_the_live_tails(pkg, tmp_path):
    async def run():
        path = tmp_path / "genw.genlog"
        j = pkg.genlog.GenJournal(path)
        j.append(_rec("o1", [1, 2]))
        j.append(_rec("o2", [3]))
        j.append(_rec("fin", [4]))
        j.mark_done("fin")
        sup = pkg.procsup.ProcessSupervisor()
        sup._bus = _StubBus()
        before = pkg.metrics.get("gen.orphans", 0)
        await sup._rescue_gen_orphans(_gen_worker(pkg, tmp_path))
        assert pkg.metrics.get("gen.orphans", 0) == before + 2
        assert not path.exists()
        bodies = {json.loads(d)["task_id"]: json.loads(d) for s, d in sup._bus.published
                  if s == pkg.subjects.TASKS_GENERATION_RESUME}
        assert set(bodies) == {"o1", "o2"}
        assert bodies["o1"]["attempt"] == 0 and bodies["o1"]["record"]["tokens"] == [1, 2]
        await sup._rescue_gen_orphans(_gen_worker(pkg, tmp_path))  # the same death again
        assert len(sup._bus.published) == 2

    asyncio.run(run())


def test_rescue_skips_without_journal_env_or_bus(pkg, tmp_path):
    async def run():
        path = tmp_path / "genw.genlog"
        pkg.genlog.GenJournal(path).append(_rec("o1", [1]))
        sup = pkg.procsup.ProcessSupervisor()
        sup._bus = _StubBus()
        await sup._rescue_gen_orphans(
            pkg.procsup._Worker(pkg.procsup.WorkerSpec(role="plain", argv=["true"])))
        assert sup._bus.published == [] and path.exists()
        sup._bus = None  # the broker is down: the scan waits, the file stays
        await sup._rescue_gen_orphans(_gen_worker(pkg, tmp_path))
        assert path.exists()

    asyncio.run(run())
