"""Rule: event-loop blocking-call detector (``async-blocking-call``).

Copy of the JAX package's `symbiont_tpu/lint/rules/asynchygiene.py`, over
the port's `services/`, `resilience/` and `obs/`.

"Answer Fast" (arxiv 2206.11062) and Demystifying BERT (arxiv 2104.08335)
both locate serving throughput death in the host path — and an event loop
stalled behind a WAL fsync or a subprocess fork is the canonical host-path
slow bleed: every coroutine in the process (SSE writers, bus pumps,
heartbeats) waits behind it, and nothing crashes, so nothing alerts. The
repo's convention is explicit (services/coalesce.py store_executor,
EngineService._run_blocking): blocking work rides an executor, the loop
never does it inline.

This rule walks every ``async def`` in the configured scope dirs
(services/, resilience/, obs/) and flags, in the coroutine's OWN scope
(nested ``def``/``lambda`` bodies are other scopes — they typically run ON
an executor):

- known blocking calls by dotted name (``time.sleep``, ``os.fsync``,
  ``subprocess.*``, ``urllib.request.urlopen``, ``socket.create_connection``,
  builtin ``open``, pathlib I/O methods);
- store/graph-surface calls (``self.store.*`` / ``self.vector_store.*`` /
  ``self.graph_store.*`` / ``self.inner.*``) — blocking by contract
  (embedded WAL fsync, external HTTP);
- synchronous lock acquisition: a plain ``with`` on a lock-named attribute
  or an un-awaited ``.acquire()`` (engine/threading locks can be held
  across device dispatches — an event loop must never wait on one);
- un-awaited ``.wait(...)`` calls (subprocess/threading-style waits);
- one level of ``self._helper()`` indirection: a direct call to a sync
  method of the same class whose body contains one of the I/O categories
  above is flagged at the call site (lock/wait categories stay local —
  one level down they are usually a bounded critical section by design).

Allowlist entries are ``(repo-relative-file, dotted-scope)`` pairs naming
the ASYNC function (see allowlist.py ASYNC_BLOCKING_ALLOWED)."""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from symbiont_tpu_torch.lint.engine import (
    Finding,
    LintContext,
    Rule,
    dotted_name,
    iter_own_scope as _iter_own,
    scoped_functions,
)

RULE_ID = "async-blocking-call"

SCOPE_DIRS = ("symbiont_tpu_torch/services", "symbiont_tpu_torch/resilience",
              "symbiont_tpu_torch/obs")

# exact dotted-call blocklist (module-qualified blocking primitives)
BLOCKING_DOTTED = {
    "time.sleep", "sleep",
    "os.fsync", "os.replace", "os.rename", "os.remove", "os.makedirs",
    "shutil.copy", "shutil.copyfile", "shutil.copytree", "shutil.rmtree",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "urllib.request.urlopen", "socket.create_connection",
    "requests.get", "requests.post", "requests.put", "requests.delete",
}
# blocking by METHOD name regardless of receiver (pathlib-style file I/O)
BLOCKING_METHODS = {"read_text", "write_text", "read_bytes", "write_bytes",
                    "mkdir", "unlink", "touch", "rmdir", "fsync"}
# receivers whose whole call surface is blocking by contract
STORE_PREFIXES = ("self.store.", "self.vector_store.", "self.graph_store.",
                  "self.inner.")


def _awaited_calls(node: ast.AST) -> Set[int]:
    """Calls DIRECTLY under an await (``await x.f()``)."""
    return {id(n.value) for n in ast.walk(node) if isinstance(n, ast.Await)
            and isinstance(n.value, ast.Call)}


def _await_subtree_calls(node: ast.AST) -> Set[int]:
    """Every Call anywhere under an await expression — the looser net the
    ``.wait()`` check uses, so the standard
    ``await asyncio.wait_for(event.wait(), t)`` idiom is not flagged."""
    out: Set[int] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Await):
            out.update(id(c) for c in ast.walk(n.value)
                       if isinstance(c, ast.Call))
    return out


def _is_lockish(name: Optional[str]) -> bool:
    return bool(name) and "lock" in name.rsplit(".", 1)[-1].lower()


def _io_blocking(n: ast.Call) -> Optional[Tuple[str, str]]:
    """(dotted-or-method name, description) when the call is in one of the
    I/O blocking categories — THE single classifier, shared by the direct
    check and the one-level indirection scan so the two can never
    diverge."""
    d = dotted_name(n.func)
    if d in BLOCKING_DOTTED or d == "open":
        return d, f"blocking call {d}()"
    if isinstance(n.func, ast.Attribute) and n.func.attr in BLOCKING_METHODS:
        return n.func.attr, f"blocking file I/O .{n.func.attr}()"
    if d and d.startswith(STORE_PREFIXES):
        return d, (f"store/graph call {d}() on the event loop (route "
                   "through store_executor()/default executor)")
    return None


def _io_hits(body_owner: ast.AST) -> List[Tuple[int, str]]:
    """(line, description) for I/O-category blocking calls in the node's
    own scope — the subset safe to judge one call level down."""
    hits: List[Tuple[int, str]] = []
    for n in _iter_own(body_owner):
        if isinstance(n, ast.Call):
            io = _io_blocking(n)
            if io is not None:
                hits.append((n.lineno, io[1]))
    return hits


def _class_methods(tree: ast.AST) -> Dict[str, Dict[str, ast.FunctionDef]]:
    out: Dict[str, Dict[str, ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out[node.name] = {
                m.name: m for m in node.body
                if isinstance(m, ast.FunctionDef)}
    return out


def _async_defs(tree: ast.AST):
    """(async-def node, dotted scope path, enclosing class name) tuples
    (the shared scoped-functions walker, filtered to coroutines)."""
    return [(fn, scope, cls) for fn, scope, cls in scoped_functions(tree)
            if isinstance(fn, ast.AsyncFunctionDef)]


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.py_files(*SCOPE_DIRS):
        tree = ctx.tree(path)
        if tree is None:
            continue
        rel = ctx.rel(path)
        methods_by_class = _class_methods(tree)
        for fn, scope, cls in _async_defs(tree):
            awaited = _awaited_calls(fn)
            await_subtree = _await_subtree_calls(fn)
            hits: List[Tuple[int, str]] = []
            for n in _iter_own(fn):
                if isinstance(n, ast.With):  # sync with on a lock object
                    for item in n.items:
                        d = dotted_name(item.context_expr)
                        if _is_lockish(d):
                            hits.append((
                                n.lineno,
                                f"synchronous `with {d}:` held on the event "
                                "loop (use an executor or asyncio.Lock)"))
                if not isinstance(n, ast.Call):
                    continue
                d = dotted_name(n.func)
                io = _io_blocking(n)
                if io is not None:
                    if io[0] == "sleep" and id(n) in awaited:
                        continue  # `await sleep(...)` is asyncio.sleep
                        # imported bare — time.sleep is never awaitable
                    hits.append((n.lineno, io[1]))
                elif (isinstance(n.func, ast.Attribute)
                      and n.func.attr == "acquire" and id(n) not in awaited
                      and _is_lockish(dotted_name(n.func.value))):
                    hits.append((n.lineno,
                                 f"un-awaited {d}() lock acquisition"))
                elif (isinstance(n.func, ast.Attribute)
                      and n.func.attr == "wait"
                      and id(n) not in await_subtree):
                    hits.append((n.lineno,
                                 f"un-awaited blocking {d}()"))
                elif (d and cls and d.startswith("self.")
                      and "." not in d[len("self."):]):
                    # one level of indirection into a sync method of the
                    # same class: I/O categories only
                    target = methods_by_class.get(cls, {}).get(d[5:])
                    if target is not None:
                        for line, desc in _io_hits(target):
                            hits.append((
                                n.lineno,
                                f"{d}() at {rel}:{line} runs a {desc}"))
            for line, msg in hits:
                if ctx.allowed(RULE_ID, (rel, scope)):
                    continue
                findings.append(Finding(
                    rel, line, RULE_ID, "error",
                    f"async {scope}: {msg}"))
    return findings


RULES = [Rule(
    id=RULE_ID,
    doc="blocking calls (sleep/file I/O/fsync/store/subprocess/locks) "
        "inside async functions not routed through an executor",
    check=check,
    allow_key=RULE_ID,
)]
