"""The port's contract linter (symbiont_tpu_torch/lint/) against the JAX
package's (symbiont_tpu/lint/).

Four contracts, each proven here:

1. every copied rule family (wiring, data plane, async, locks, parity,
   knobs) gives the SAME findings as JAX's on the same synthetic tree, only
   the package prefix rewritten, and each seeded violation fires;
2. the allowlist machinery works both ways — a matching entry suppresses
   exactly its site, and a stale entry is itself an error;
3. the torch rules (``torch-host-sync-in-loop``,
   ``graph-capture-in-function``) fire on the torch forms and stay silent
   on host reads;
4. the real repo is CLEAN under the port's live allowlist, and that
   allowlist's host-sync table is the runtime inventory in both
   directions: ``known_sync_sites()`` reads it, and every site string that
   reaches ``dispatch_ledger.note_host_sync`` names one of its scopes.
"""

from __future__ import annotations

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from symbiont_tpu.lint import run as jax_run
from symbiont_tpu_torch.lint import repo_root, run
from symbiont_tpu_torch.lint.allowlist import ALLOWLISTS, TORCH_HOST_SYNC_ALLOWED
from symbiont_tpu_torch.lint.rules import RULES

pytestmark = pytest.mark.lint

REPO = repo_root()
PKG = "symbiont_tpu_torch"


def _write(root: Path, rel: str, body: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))


def _rules_of(findings):
    return {f.rule for f in findings}


def _run(root, rule_ids=None, allowlists=None):
    return run(root=root, rule_ids=rule_ids,
               allowlists=allowlists if allowlists is not None else {})


# ------------------------------------------------- fixtures, either package

def _wiring_tree(root: Path, pkg: str = PKG) -> Path:
    _write(root, f"{pkg}/subjects.py", '''
        GOOD_SUB = "tasks.good"
        DEAD_SUB = "data.dead.limb"
        UNCONSUMED = "events.unconsumed"
        ALL_SUBJECTS = [GOOD_SUB, UNCONSUMED]
        ''')
    _write(root, f"{pkg}/services/svc.py", f'''
        from {pkg} import subjects

        class Svc:
            async def setup(self, bus):
                await bus.subscribe(subjects.GOOD_SUB)
                await bus.subscribe(subjects.DEAD_SUB)

            async def emit(self, bus):
                await bus.publish(subjects.GOOD_SUB, b"{{}}")
                await bus.publish(subjects.UNCONSUMED, b"{{}}")
        ''')
    return root


def _dataplane_tree(root: Path, pkg: str = PKG) -> Path:
    _write(root, f"{pkg}/services/hot.py", '''
        from dataclasses import asdict

        class Hot:
            async def handle(self, msg):
                vec = [float(x) for x in msg.data]
                d = asdict(msg)
                return vec, d, "f16"
        ''')
    return root


def _async_tree(root: Path, pkg: str = PKG) -> Path:
    _write(root, f"{pkg}/services/blocky.py", '''
        import time

        class Blocky:
            async def handle(self, msg):
                time.sleep(0.1)
                with open("/tmp/x") as f:
                    f.read()
                self.store.search([1.0], 5)
                with self._lock:
                    pass

            async def indirect(self):
                self._sync_io()

            def _sync_io(self):
                with open("/tmp/y") as f:
                    return f.read()
        ''')
    _write(root, f"{pkg}/services/clean.py", '''
        import asyncio

        class Clean:
            async def handle(self, msg):
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, lambda: open("/tmp/z"))
                await loop.run_in_executor(None, self.store.search, [1], 5)
        ''')
    _write(root, f"{pkg}/obs/waity.py", '''
        import asyncio

        class W:
            async def handle(self):
                await asyncio.wait_for(self._ready.wait(), timeout=5)

            async def bad(self, w):
                w.proc.wait(timeout=5)
        ''')
    return root


def _locks_tree(root: Path, pkg: str = PKG) -> Path:
    _write(root, f"{pkg}/engine/locky.py", '''
        import threading

        class AB:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def two(self):
                with self._b_lock:
                    self._take_a()

            def _take_a(self):
                with self._a_lock:
                    pass

        class Re:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
        ''')
    _write(root, f"{pkg}/engine/relock.py", '''
        import threading

        class Ok:
            def __init__(self):
                self._lock = threading.RLock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
        ''')
    _write(root, f"{pkg}/obs/meter.py", '''
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()

            def flush(self):
                with self._lock:
                    metrics.inc("meter.flushes")
        ''')
    return root


def _parity_tree(root: Path, pkg: str = PKG) -> Path:
    _write(root, f"{pkg}/subjects.py", '''
        TASKS_GOOD = "tasks.good"
        ALL_SUBJECTS = []
        ''')
    _write(root, f"{pkg}/utils/telemetry.py", '''
        TRACE_HEADER = "X-Trace-Id"
        TENANT_HEADER = "X-Symbiont-Tenant"
        ''')
    _write(root, f"{pkg}/schema/frames.py", '''
        import struct
        FRAME_HEADER = "X-Symbiont-Frame"
        FRAME_MAGIC = b"SYTF"
        FRAME_VERSION = 1
        DTYPE_F32 = 1
        DTYPE_F16 = 2
        _HDR = struct.Struct("<4sBBHII")
        _SIZE_BY_DTYPE = {DTYPE_F32: 4, DTYPE_F16: 2}
        ''')
    _write(root, f"{pkg}/runner.py", '''
        import json, os

        class Stack:
            async def _heartbeat_loop(self, role, interval_s):
                payload = json.dumps({"role": role, "pid": os.getpid()})
                return payload
        ''')
    _write(root, "native/services/common.hpp", '''
        inline const char* TASKS_GOOD = "tasks.goodX";
        inline const char* TENANT_HEADER = "X-Symbiont-Ten4nt";
        constexpr uint8_t FRAME_VERSION = 1;
        constexpr uint8_t FRAME_DTYPE_F32 = 1;
        constexpr uint8_t FRAME_DTYPE_F16 = 9;
        constexpr size_t FRAME_HDR_LEN = 12;
        // "SYTF" magic; only tensor/f32 wired here
        inline const char* ct = "tensor/f32";
        inline size_t frame_elem_size(uint8_t dtype) {
          if (dtype == FRAME_DTYPE_F32) return 4;
          if (dtype == FRAME_DTYPE_F16) return 2;
          return 0;
        }
        inline std::string heartbeat_payload(const std::string& role) {
          std::string out = "{\\"role\\": \\"";
          out += "\\", \\"pid_\\": ";
          return out;
        }
        ''')
    _write(root, "native/services/rogue.cpp", '''
        #include "common.hpp"
        int main() {
          bus.publish("engine.subject.nobody.serves", "{}");
          headers["X-Symbiont-Unknown"] = "1";
        }
        ''')
    return root


def _knobs_tree(root: Path, pkg: str = PKG) -> Path:
    _write(root, f"{pkg}/mod.py", '''
        import os
        A = os.environ.get("SYMBIONT_DOCUMENTED_KNOB")
        B = os.environ.get("SYMBIONT_SECRET_KNOB")
        ''')
    _write(root, "native/services/shell.cpp", '''
        auto v = env_or("SYMBIONT_SECRET_CPP_KNOB", "1");
        ''')
    _write(root, "docs/KNOBS.md", "| `SYMBIONT_DOCUMENTED_KNOB` | documented |\n")
    return root


FAMILIES = {
    "wiring": (_wiring_tree, ["subject-dead-limb"]),
    "dataplane": (_dataplane_tree, ["no-per-float-conversion", "no-asdict-on-ingest",
                                    "no-hardcoded-frame-dtype"]),
    "async": (_async_tree, ["async-blocking-call"]),
    "locks": (_locks_tree, ["lock-order-cycle"]),
    "parity": (_parity_tree, ["cpp-parity"]),
    "knobs": (_knobs_tree, ["knob-doc-drift"]),
}


def _normal(findings, pkg):
    return sorted((f.file.replace(pkg + "/", "<pkg>/", 1), f.line, f.rule, f.severity)
                  for f in findings)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_finds_what_jax_finds(tmp_path, family):
    """The same synthetic tree under each package's prefix, through each
    package's engine: the same (file, line, rule, severity) findings."""
    build, rule_ids = FAMILIES[family]
    jax_root = build(tmp_path / "jax", "symbiont_tpu")
    port_root = build(tmp_path / "port", PKG)
    want, _ = jax_run(root=jax_root, rule_ids=rule_ids, allowlists={})
    got, _ = _run(port_root, rule_ids=rule_ids)
    assert got, f"{family}: the seeded violations found nothing"
    assert _normal(got, PKG) == _normal(want, "symbiont_tpu")


def test_rule_scopes_are_no_narrower_than_jax():
    """Each copied rule's scope constants are JAX's with the prefix
    rewritten (locks adds graphs.py); the torch rules cover JAX's
    counterparts' files."""
    from symbiont_tpu.lint.rules import (asynchygiene as ja, dataplane as jd,
                                         jaxhygiene as jh, locks as jl,
                                         parity as jp, wiring as jw)
    from symbiont_tpu_torch.lint.rules import (asynchygiene as ta, dataplane as td,
                                               locks as tl, parity as tp,
                                               torchhygiene as th, wiring as tw)

    def port(paths):
        return {p.replace("symbiont_tpu/", PKG + "/", 1) for p in paths}

    assert set(ta.SCOPE_DIRS) >= port(ja.SCOPE_DIRS)
    assert set(tl.SCOPE_DIRS) >= port(jl.SCOPE_DIRS) | {f"{PKG}/graphs.py"}
    assert port([jd.SCOPE_DIR]) == {td.SCOPE_DIR}
    assert port([jw.PY_SUBJECTS]) == {tw.PY_SUBJECTS}
    for name in ("PY_SUBJECTS", "PY_TELEMETRY", "PY_FRAMES", "PY_RUNNER"):
        assert port([getattr(jp, name)]) == {getattr(tp, name)}
    assert tp.CPP_COMMON == jp.CPP_COMMON
    assert set(th.SYNC_FILES) >= port(jh.SYNC_FILES)
    assert set(th.SCOPE_DIRS) >= port(jh.SCOPE_DIRS) | {f"{PKG}/graphs.py"}
    assert tl.METRICS_LOCK.startswith(PKG + ".utils.telemetry.")
    assert tl.TRACE_LOCK.startswith(PKG + ".obs.trace_store.")


# --------------------------------------------------------------- wiring


def test_dead_limb_rule_fires(tmp_path):
    findings, _ = _run(_wiring_tree(tmp_path), rule_ids=["subject-dead-limb"])
    dead = [f for f in findings if f.rule == "subject-dead-limb"]
    assert len(dead) == 1 and "data.dead.limb" in dead[0].message
    duplex = [f for f in findings if f.rule == "subject-full-duplex"]
    assert len(duplex) == 1 and "events.unconsumed" in duplex[0].message


def test_dead_limb_allowlist_suppresses_and_goes_stale(tmp_path):
    root = _wiring_tree(tmp_path)
    findings, _ = _run(root, rule_ids=["subject-dead-limb"],
                       allowlists={"subject-unproduced": {"DEAD_SUB": "test"}})
    assert not [f for f in findings if f.rule == "subject-dead-limb"]
    assert not [f for f in findings if f.rule == "stale-allowlist"]
    findings, _ = _run(root, rule_ids=["subject-dead-limb"],
                       allowlists={"subject-unproduced": {"DEAD_SUB": "t", "NEVER_SEEN": "t"}})
    stale = [f for f in findings if f.rule == "stale-allowlist"]
    assert len(stale) == 1 and "NEVER_SEEN" in stale[0].message
    assert stale[0].file == f"{PKG}/lint/allowlist.py"


# ------------------------------------------------------------ data plane


def test_dataplane_rules_fire(tmp_path):
    findings, _ = _run(_dataplane_tree(tmp_path),
                       rule_ids=["no-per-float-conversion", "no-asdict-on-ingest",
                                 "no-hardcoded-frame-dtype"])
    assert _rules_of(findings) >= {"no-per-float-conversion", "no-asdict-on-ingest",
                                   "no-hardcoded-frame-dtype"}
    assert any("Hot.handle" in f.message for f in findings)


def test_dataplane_allowlist_is_site_exact(tmp_path):
    root = _dataplane_tree(tmp_path)
    allow = {"no-per-float-conversion": {(f"{PKG}/services/hot.py", "Hot.handle"): "test"}}
    findings, _ = _run(root, rule_ids=["no-per-float-conversion"], allowlists=allow)
    assert not findings
    allow = {"no-per-float-conversion": {(f"{PKG}/services/hot.py", "Hot.other"): "test"}}
    findings, _ = _run(root, rule_ids=["no-per-float-conversion"], allowlists=allow)
    assert _rules_of(findings) == {"no-per-float-conversion", "stale-allowlist"}


# ------------------------------------------------------- event loop rule


def test_blocking_call_rule_fires_per_category(tmp_path):
    findings, _ = _run(_async_tree(tmp_path), rule_ids=["async-blocking-call"])
    msgs = "\n".join(f.message for f in findings)
    assert "time.sleep" in msgs
    assert "open()" in msgs
    assert "store/graph call" in msgs
    assert "with self._lock" in msgs
    assert any("indirect" in f.message and "_sync_io" in f.message for f in findings)
    # executor-routed work (nested lambda/def scopes) is NOT flagged
    assert not [f for f in findings if "clean.py" in f.file]


def test_wait_for_event_wait_idiom_not_flagged(tmp_path):
    findings, _ = _run(_async_tree(tmp_path), rule_ids=["async-blocking-call"])
    waity = [f for f in findings if "waity.py" in f.file]
    assert len(waity) == 1, waity
    assert "W.bad" in waity[0].message and "proc.wait" in waity[0].message


# -------------------------------------------------------------- lock order


def test_lock_order_cycle_and_self_deadlock_fire(tmp_path):
    root = _locks_tree(tmp_path)
    findings, _ = _run(root, rule_ids=["lock-order-cycle"])
    rules = _rules_of(findings)
    assert {"lock-order-cycle", "lock-self-deadlock"} <= rules, findings
    cycle = next(f for f in findings if f.rule == "lock-order-cycle")
    assert "locky.AB._a_lock" in cycle.message and "locky.AB._b_lock" in cycle.message
    assert not [f for f in findings if "relock" in f.message]  # RLock re-entry
    # a call into the metrics registry under a lock is an edge to the
    # port's modeled registry lock, not a cycle
    assert not [f for f in findings if "meter" in f.file]
    mod = f"{PKG}.engine.locky"
    allow = {"lock-order": {
        f"{mod}.AB._a_lock -> {mod}.AB._b_lock -> {mod}.AB._a_lock": "t",
        f"{mod}.Re._lock -> {mod}.Re._lock": "t"}}
    findings, _ = _run(root, rule_ids=["lock-order-cycle"], allowlists=allow)
    assert not findings, findings


def test_graphs_side_lock_is_in_the_lock_graph():
    """graphs.py is in the lock rule's scope: its `_side_lock` is a known
    lock, and the port's real graph has no cycle through it."""
    from symbiont_tpu_torch.lint.engine import LintContext
    from symbiont_tpu_torch.lint.rules import locks

    edges, kinds = locks._analyze(LintContext(REPO, allowlists={}))
    assert kinds[f"{PKG}.graphs._side_lock"] == "Lock"
    assert kinds[f"{PKG}.graphs._capture_lock"] == "Lock"
    assert (f"{PKG}.graphs._capture_lock", f"{PKG}.graphs._side_lock") in edges
    assert not locks._cycles(edges)


# ---------------------------------------------------------- torch hygiene


def test_graph_capture_rule_fires(tmp_path):
    """The capture rule stands where jax-static-args and jax-jit-in-function
    stand: CUDA-graph captures and torch.compile outside the executable
    cache, in a body, in __init__, at module level and as a decorator."""
    _write(tmp_path, f"{PKG}/models/badgraph.py", '''
        import torch

        FAST = torch.compile(lambda x: x + 1)

        class M:
            def __init__(self):
                self.g = torch.cuda.CUDAGraph()

            def per_call(self, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x + 1
                return y

        @torch.compile
        def step(x):
            return x
        ''')
    findings, _ = _run(tmp_path, rule_ids=["graph-capture-in-function"])
    sites = sorted((f.line, f.message.split(":")[0]) for f in findings)
    assert sites == [(4, "<module>"), (8, "M.__init__"), (11, "M.per_call"),
                     (12, "M.per_call"), (16, "step")], sites
    allow = {"graph-capture-in-function": {(f"{PKG}/models/badgraph.py", "M.per_call"): "t"}}
    findings, _ = _run(tmp_path, rule_ids=["graph-capture-in-function"], allowlists=allow)
    assert len(findings) == 3 and not _rules_of(findings) & {"stale-allowlist"}


def test_torch_host_sync_rule_fires(tmp_path):
    _write(tmp_path, f"{PKG}/engine/engine.py", '''
        import numpy as np
        import torch

        class E:
            def dispatch(self, batches):
                out = []
                for b in batches:
                    out.append(np.asarray(b))
                    out.append(b.tolist())
                    out.append(float(b))
                return out

            def scalar(self, x):
                return x.item()

            def waits(self, x, done):
                done.synchronize()
                torch.cuda.synchronize()
                return x.cpu(), x.to("cpu"), x.to(device=torch.device("cpu"))

            def moves(self, x):
                return x.to("cuda"), x.to(torch.float32)
        ''')
    findings, _ = _run(tmp_path, rule_ids=["torch-host-sync-in-loop"])
    got = sorted((f.line, f.message.split(":")[0]) for f in findings)
    # the two `.to(...)` findings on line 20 render alike and count once
    assert got == [(9, "E.dispatch"), (10, "E.dispatch"), (11, "E.dispatch"),
                   (15, "E.scalar"), (18, "E.waits"), (19, "E.waits"), (20, "E.waits"),
                   (20, "E.waits")], got


def test_host_reads_are_not_syncs(tmp_path):
    """`.numpy()` reads a tensor already on the host (torch refuses it on
    a CUDA tensor), host-data literals are no device pulls, and
    `.tolist()`/`np.asarray` outside a loop are left to the JAX rule's
    per-iteration judgement."""
    _write(tmp_path, f"{PKG}/engine/engine.py", '''
        import numpy as np

        class E:
            def fetch(self, hosts, widths):
                for h in hosts:
                    a = h.float().numpy()
                for w in widths:
                    lens = np.asarray([min(w, 8) for _ in range(3)])
                return a, lens, hosts[0].tolist(), np.asarray(hosts[0])
        ''')
    findings, _ = _run(tmp_path, rule_ids=["torch-host-sync-in-loop"])
    assert not findings, findings


def test_a_site_helper_reports_its_wait_at_each_caller(tmp_path):
    """A helper that takes its counter's `site` from its caller (as
    TorchEngine._fetch does) reports its wait under each caller's scope —
    the name its counter carries — not under its own."""
    _write(tmp_path, f"{PKG}/engine/engine.py", '''
        class E:
            def _fetch(self, pending, out, site):
                done.synchronize()
                ledger.note_host_sync(site)

            def embed(self):
                self._fetch([], None, "E.embed")

            def rerank(self):
                self._fetch([], None, "E.rerank")

            def _other(self, x):
                return x.cpu()

            def uses_other(self, x):
                return self._other(x)
        ''')
    findings, _ = _run(tmp_path, rule_ids=["torch-host-sync-in-loop"])
    got = sorted((f.line, f.message.split(":")[0]) for f in findings)
    assert got == [(8, "E.embed"), (11, "E.rerank"), (14, "E._other")], got
    assert "self._fetch() at" in findings[0].message


def test_nested_def_sites_report_once_under_their_own_scope(tmp_path):
    _write(tmp_path, f"{PKG}/engine/engine.py", '''
        class E:
            def outer(self, xs):
                def inner(v):
                    return v.item()
                return [inner(x) for x in xs]
        ''')
    findings, _ = _run(tmp_path, rule_ids=["torch-host-sync-in-loop"])
    assert len(findings) == 1, findings
    assert "E.outer.inner" in findings[0].message


# ------------------------------------------------------------- cpp parity


def test_cpp_parity_rule_fires_on_every_surface(tmp_path):
    findings, _ = _run(_parity_tree(tmp_path), rule_ids=["cpp-parity"])
    msgs = "\n".join(f.message for f in findings)
    assert "subject constant TASKS_GOOD drifted" in msgs
    assert "header constant TENANT_HEADER drifted" in msgs
    assert "dtype byte drifted for 'f16'" in msgs
    assert "'tensor/f16' missing" in msgs
    assert "header length drifted" in msgs
    assert "heartbeat payload fields drifted" in msgs
    assert "engine.subject.nobody.serves" in msgs
    assert "X-Symbiont-Unknown" in msgs and f"nowhere in {PKG}/" in msgs


# -------------------------------------------------------------- knob drift


def test_knob_doc_drift_rule_fires(tmp_path):
    findings, _ = _run(_knobs_tree(tmp_path), rule_ids=["knob-doc-drift"])
    names = "\n".join(f.message for f in findings)
    assert "SYMBIONT_SECRET_KNOB" in names
    assert "SYMBIONT_SECRET_CPP_KNOB" in names
    assert "SYMBIONT_DOCUMENTED_KNOB" not in names


# ------------------------------------------------------- engine plumbing


def test_unparseable_file_is_a_finding(tmp_path):
    _write(tmp_path, f"{PKG}/services/broken.py", "def f(:\n    pass\n")
    findings, _ = _run(tmp_path, rule_ids=["async-blocking-call"])
    assert any(f.rule == "lint-parse" for f in findings)


@pytest.mark.parametrize("root, rel, found", [
    ("build/checkout", f"{PKG}/services/hot.py", True),
    ("checkout", f"{PKG}/services/build/hot.py", False),
    ("checkout", f"{PKG}/services/__pycache__/hot.py", False),
])
def test_skip_dirs_are_judged_below_the_scanned_dir(tmp_path, root, rel, found):
    """A checkout under a directory named build/ is scanned whole; a build/
    or cache dir inside the scanned tree is skipped."""
    _write(tmp_path / root, rel, "from dataclasses import asdict\n\n"
                                 "def f(m):\n    return asdict(m)\n")
    findings, _ = _run(tmp_path / root, rule_ids=["no-asdict-on-ingest"])
    assert bool(findings) is found, findings


def test_unknown_rule_id_raises():
    with pytest.raises(KeyError):
        run(root=REPO, rule_ids=["no-such-rule"], allowlists={})


def test_findings_render_structured(tmp_path):
    findings, _ = _run(_dataplane_tree(tmp_path), rule_ids=["no-asdict-on-ingest"])
    head, rule, sev = findings[0].render().split(" ")[:3]
    assert head.startswith(f"{PKG}/services/hot.py:")
    assert rule == "no-asdict-on-ingest" and sev == "error"


# ------------------------------------------------------- the real repo


def test_repo_is_clean_with_live_allowlists():
    """Zero findings on the real tree under the port's allowlist, every
    entry still live."""
    findings, ctx = run(root=REPO)
    assert not findings, "\n" + "\n".join(f.render() for f in findings)
    assert ctx.allowlists is ALLOWLISTS


def test_every_allowlist_entry_names_a_port_site_and_a_reason():
    for table in ALLOWLISTS.values():
        for entry, reason in table.items():
            if isinstance(entry, tuple):
                assert entry[0].startswith(PKG + "/"), entry
            assert isinstance(reason, str) and len(reason) > 20, (entry, reason)


@pytest.mark.parametrize("table", sorted(k for k, v in ALLOWLISTS.items() if v))
def test_a_stale_entry_in_each_table_is_an_error(table):
    """The live allowlist plus one entry that matches no site: exactly one
    stale-allowlist finding, and nothing else."""
    entry = (f"{PKG}/engine/lm.py", "Nowhere.at_all") if isinstance(
        next(iter(ALLOWLISTS[table])), tuple) else "NO_SUCH_SUBJECT"
    allow = {k: dict(v) for k, v in ALLOWLISTS.items()}
    allow[table][entry] = "a stale entry for this test"
    owner = [r.id for r in RULES if r.allow_key == table]
    findings, _ = run(root=REPO, rule_ids=owner, allowlists=allow)
    assert [(f.rule, f.file) for f in findings] == [("stale-allowlist",
                                                     f"{PKG}/lint/allowlist.py")]
    assert repr(entry) in findings[0].message


SEEDED = {
    "wiring": (_wiring_tree, "subject-dead-limb"),
    "dataplane": (_dataplane_tree, "no-asdict-on-ingest"),
    "async": (_async_tree, "async-blocking-call"),
    "locks": (_locks_tree, "lock-order-cycle"),
    "parity": (_parity_tree, "cpp-parity"),
    "knobs": (_knobs_tree, "knob-doc-drift"),
}


def _cli(*args):
    return subprocess.run([sys.executable, "-m", f"{PKG}.lint", *args], cwd=REPO,
                          capture_output=True, text=True)


def test_cli_exit_codes(tmp_path):
    clean = _cli()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    dirty = _cli("--root", str(_dataplane_tree(tmp_path)), "--rules", "no-asdict-on-ingest")
    assert dirty.returncode == 1
    assert "no-asdict-on-ingest error" in dirty.stdout
    assert _cli("--rules", "bogus").returncode == 2


@pytest.mark.parametrize("family", sorted(SEEDED) + ["capture", "sync"])
def test_cli_fails_on_a_seeded_violation_of_each_family(tmp_path, family):
    """A tree holding one family's seeded violation: the CLI exits 1 and
    names the family's rule."""
    if family == "capture":
        _write(tmp_path, f"{PKG}/graphs.py",
               "import torch\n\ndef g():\n    return torch.cuda.CUDAGraph()\n")
        rule = "graph-capture-in-function"
    elif family == "sync":
        _write(tmp_path, f"{PKG}/engine/lm.py", "def f(x):\n    return x.item()\n")
        rule = "torch-host-sync-in-loop"
    else:
        build, rule = SEEDED[family]
        build(tmp_path)
    out = _cli("--root", str(tmp_path), "--rules", rule)
    assert out.returncode == 1
    assert f" {rule} error " in out.stdout, out.stdout


def test_cli_list_rules():
    out = _cli("--list")
    assert out.returncode == 0
    for rid in ("subject-dead-limb", "async-blocking-call", "lock-order-cycle",
                "graph-capture-in-function", "torch-host-sync-in-loop", "cpp-parity",
                "knob-doc-drift"):
        assert rid in out.stdout
    assert "jax-" not in out.stdout


# ------------------------------------------------- the host-sync inventory


def test_known_sync_sites_read_the_allowlist():
    """Direction 1: the runtime's site list IS the allowlist's scopes."""
    from symbiont_tpu_torch.obs import xprof

    assert not hasattr(xprof, "KNOWN_SYNC_SITES")
    assert xprof.known_sync_sites() == tuple(sorted(s for _f, s in TORCH_HOST_SYNC_ALLOWED))


def test_every_counted_site_is_inventoried():
    """Direction 2: every site string that reaches note_host_sync in the
    port — directly, or through TorchEngine._fetch(..., site) — names an
    allowlisted scope, and every allowlisted scope is counted somewhere."""
    allow = {scope for _f, scope in TORCH_HOST_SYNC_ALLOWED}
    counted = set()
    for py in (REPO / PKG).rglob("*.py"):
        if py.name == "xprof.py" or "lint" in py.parts:
            continue
        text = py.read_text()
        counted |= set(re.findall(r'note_host_sync\(\s*"([^"]+)"', text))
        counted |= set(re.findall(r'self\._fetch\([^()]*"([^"]+)"\)', text))
    assert {"TorchEngine.embed_texts", "TorchEngine.rerank"} <= counted
    assert counted == allow, (sorted(counted), sorted(allow))


def test_register_zero_exports_every_inventoried_site():
    from symbiont_tpu_torch.obs.xprof import DispatchLedger, known_sync_sites
    from symbiont_tpu_torch.utils.telemetry import Metrics

    led = DispatchLedger(registry=Metrics())
    led.register_zero()
    counters = led.registry.snapshot()["counters"]
    series = {k for k in counters if k.startswith("engine.host_syncs_total{")}
    assert series == {f'engine.host_syncs_total{{site="{s}"}}' for s in known_sync_sites()}
    assert all(counters[k] == 0 for k in series)


def test_draw_seed_waits_on_no_device(monkeypatch):
    """The repaired site: LmEngine._draw_seed draws on the host — no
    torch op, no .item() — and the same seed gives the same draws."""
    import torch

    from symbiont_tpu_torch.config import LmConfig
    from symbiont_tpu_torch.engine.lm import LmEngine

    cfg = LmConfig(enabled=True, arch="llama", hidden_size=16, num_layers=1, num_heads=2,
                   intermediate_size=32, max_positions=64, dtype="float32",
                   prompt_buckets=[8], new_token_buckets=[8], seed=7)
    a, b = LmEngine(cfg, device="cpu"), LmEngine(cfg, device="cpu")

    def no_device_draw(*args, **kw):
        raise AssertionError("a seed draw went through torch")

    monkeypatch.setattr(torch, "randint", no_device_draw)
    draws = [a._draw_seed() for _ in range(4)]
    assert draws == [b._draw_seed() for _ in range(4)]
    assert len(set(draws)) == 4 and all(0 <= d < 2 ** 62 for d in draws)
