"""Rule: lock-order analysis (``lock-order-cycle``, ``lock-self-deadlock``).

Copy of the JAX package's `symbiont_tpu/lint/rules/locks.py`, over the
port's counterparts of its directories plus `graphs.py`, whose
`_side_lock` every CUDA-graph replay and capture warm-up takes.

The threaded half of the stack (engine executable caches, batcher queues,
the vector store's RLock'd corpus, the metrics registry, the flight
recorder, circuit breakers) already carries one documented ordering
convention — telemetry.Metrics._eval_gauge_fns evaluates callback gauges
OUTSIDE the registry lock precisely because "a callback may take an
engine/batcher lock; holding ours too invites ordering deadlocks". This
rule makes that convention machine-checked:

1. discover every lock object statically: ``self.<attr> = threading.Lock()
   / RLock() / Condition()`` (identity ``module.Class.attr``) and
   module-level equivalents (``module.<name>``);
2. build the acquisition graph: an edge A → B whenever code acquires B
   while holding A — via direct ``with`` nesting, or via calls resolved
   one module deep (self-methods and same-module functions, to a
   fixpoint), plus two modeled cross-module singletons: any
   ``metrics.*()`` / ``self.registry.*()`` call acquires the metrics
   registry lock, any ``trace_store.*()`` call acquires the flight
   recorder lock;
3. flag every cycle (A→…→A across ≥2 locks: a deadlock hazard the moment
   two threads interleave) and every self-edge on a NON-reentrant
   ``threading.Lock`` (re-acquisition deadlocks a single thread; RLock
   self-edges are legal re-entrancy and stay silent).

Allowlist entries are canonical cycle strings (``"a.B.c -> d.E.f -> a.B.c"``)
— see allowlist.py LOCK_ORDER_ALLOWED. An allowlisted cycle documents a
dynamically-guarded ordering the analysis cannot see; prefer restructuring
over allowlisting."""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from symbiont_tpu_torch.lint.engine import Finding, LintContext, Rule, dotted_name

CYCLE_RULE = "lock-order-cycle"
SELF_RULE = "lock-self-deadlock"
ALLOW_KEY = "lock-order"

SCOPE_DIRS = ("symbiont_tpu_torch/engine", "symbiont_tpu_torch/obs",
              "symbiont_tpu_torch/memory", "symbiont_tpu_torch/graph",
              "symbiont_tpu_torch/resilience", "symbiont_tpu_torch/services",
              "symbiont_tpu_torch/bus", "symbiont_tpu_torch/utils",
              "symbiont_tpu_torch/graphs.py")

_LOCK_CTORS = {
    "threading.Lock": "Lock", "threading.RLock": "RLock",
    # Condition() defaults to an internal RLock: re-entry is legal, so it
    # participates in cycle detection but never in the self-edge check
    "threading.Condition": "RLock", "Lock": "Lock", "RLock": "RLock",
    "Condition": "RLock", "asyncio.Lock": "asyncio",
    "asyncio.Condition": "asyncio",
}

# cross-module singletons every scoped module may call into; modeled as
# one lock each (their public surface acquires it internally). Ids use
# the same dotted-module spelling _module_base produces, so the modeled
# lock and the one discovered in the module itself unify.
METRICS_LOCK = "symbiont_tpu_torch.utils.telemetry.Metrics._lock"
TRACE_LOCK = "symbiont_tpu_torch.obs.trace_store.TraceStore._lock"
_SINGLETON_RECEIVERS = {
    "metrics": METRICS_LOCK,
    "self.registry": METRICS_LOCK,
    "trace_store": TRACE_LOCK,
}


class _FnInfo:
    __slots__ = ("key", "direct", "calls", "nest_edges")

    def __init__(self, key):
        self.key = key
        self.direct: List[Tuple[str, int]] = []       # (lock, line)
        # (callee_key_or_singleton_lock, line, frozenset(held))
        self.calls: List[Tuple[object, int, frozenset]] = []
        self.nest_edges: List[Tuple[str, str, int]] = []  # (A, B, line)


def _module_base(rel: str) -> str:
    """Repo-relative dotted module path ('symbiont_tpu_torch.engine.lm') — bare
    stems would collide across the scope dirs (every package has an
    __init__.py), silently merging two modules' lock namespaces and
    function indices."""
    return rel[:-len(".py")].replace("/", ".").replace("\\", ".")


class _ModuleScan:
    """One module's lock registry + per-function acquisition summaries."""

    def __init__(self, path: Path, tree: ast.AST, rel: str):
        self.rel = rel
        self.mod = _module_base(rel)
        self.lock_kind: Dict[str, str] = {}       # lock id -> kind
        self.class_locks: Dict[str, Dict[str, str]] = {}  # cls -> attr -> id
        self.module_locks: Dict[str, str] = {}    # name -> id
        self.fns: Dict[object, _FnInfo] = {}      # (cls|None, name) -> info
        self._discover_locks(tree)
        self._scan_functions(tree)

    # ------------------------------------------------------------- discovery

    def _discover_locks(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or not isinstance(
                    node.value, ast.Call):
                continue
            ctor = dotted_name(node.value.func)
            kind = _LOCK_CTORS.get(ctor or "")
            if kind is None:
                continue
            for tgt in node.targets:
                d = dotted_name(tgt)
                if d and d.startswith("self.") and "." not in d[5:]:
                    attr = d[5:]
                    cls = self._enclosing_class(tree, node)
                    if cls:
                        lock_id = f"{self.mod}.{cls}.{attr}"
                        self.lock_kind[lock_id] = kind
                        self.class_locks.setdefault(cls, {})[attr] = lock_id
                elif isinstance(tgt, ast.Name):
                    lock_id = f"{self.mod}.{tgt.id}"
                    self.lock_kind[lock_id] = kind
                    self.module_locks[tgt.id] = lock_id

    @staticmethod
    def _enclosing_class(tree: ast.AST, target: ast.AST) -> Optional[str]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if sub is target:
                        return node.name
        return None

    # -------------------------------------------------------------- scanning

    def _scan_functions(self, tree: ast.AST) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        self._scan_fn(m, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_fn(node, None)

    def _resolve_lock(self, expr: ast.AST, cls: Optional[str]
                      ) -> Optional[str]:
        d = dotted_name(expr)
        if not d:
            return None
        if d.startswith("self.") and cls:
            return self.class_locks.get(cls, {}).get(d[5:])
        return self.module_locks.get(d)

    def _scan_fn(self, fn: ast.AST, cls: Optional[str]) -> None:
        info = _FnInfo((cls, fn.name))
        self.fns[info.key] = info

        def process(node: ast.AST, held: frozenset) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # nested scopes run elsewhere
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = set(held)
                for item in node.items:
                    process(item.context_expr, held)
                    lock = self._resolve_lock(item.context_expr, cls)
                    if lock is not None:
                        info.direct.append((lock, node.lineno))
                        for h in inner:
                            info.nest_edges.append((h, lock, node.lineno))
                        inner.add(lock)
                for stmt in node.body:
                    process(stmt, frozenset(inner))
                return
            if isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d:
                    lock = self._resolve_call_lock(d, cls)
                    if lock is not None:
                        info.direct.append((lock, node.lineno))
                        for h in held:
                            info.nest_edges.append((h, lock, node.lineno))
                    else:
                        callee = self._resolve_callee(d, cls)
                        if callee is not None:
                            info.calls.append((callee, node.lineno, held))
            for child in ast.iter_child_nodes(node):
                process(child, held)

        for stmt in fn.body:
            process(stmt, frozenset())

    def _resolve_call_lock(self, dotted: str, cls: Optional[str]
                           ) -> Optional[str]:
        """`X.acquire()` on a registered lock, or a call on a modeled
        cross-module singleton."""
        if dotted.endswith(".acquire"):
            return self._resolve_lock_from_dotted(dotted[:-len(".acquire")],
                                                  cls)
        recv, _, _meth = dotted.rpartition(".")
        if recv in _SINGLETON_RECEIVERS:
            return _SINGLETON_RECEIVERS[recv]
        return None

    def _resolve_lock_from_dotted(self, d: str, cls: Optional[str]
                                  ) -> Optional[str]:
        if d.startswith("self.") and cls:
            return self.class_locks.get(cls, {}).get(d[5:])
        return self.module_locks.get(d)

    def _resolve_callee(self, dotted: str, cls: Optional[str]):
        """Same-class method or same-module function reference (resolved
        against the function index during the global fixpoint)."""
        if dotted.startswith("self.") and "." not in dotted[5:] and cls:
            return ("fn", self.mod, cls, dotted[5:])
        if "." not in dotted:
            return ("fn", self.mod, None, dotted)
        return None


def _analyze(ctx: LintContext) -> Tuple[Dict[Tuple[str, str], List[Tuple[str, int]]],
                                        Dict[str, str]]:
    """Build the global edge map {(A, B): [(file:line sites)]} and the
    lock-kind table."""
    scans: List[_ModuleScan] = []
    for path in ctx.py_files(*SCOPE_DIRS):
        tree = ctx.tree(path)
        if tree is None:
            continue
        scans.append(_ModuleScan(path, tree, ctx.rel(path)))

    # transitive acquired-set fixpoint per (module, cls, fn)
    fn_index: Dict[Tuple[str, Optional[str], str], Tuple[_ModuleScan, _FnInfo]] = {}
    for scan in scans:
        for (cls, name), info in scan.fns.items():
            fn_index[(scan.mod, cls, name)] = (scan, info)
    acquired: Dict[Tuple[str, Optional[str], str], Set[str]] = {
        k: {lock for lock, _ in info.direct}
        for k, (_, info) in fn_index.items()}
    changed = True
    while changed:
        changed = False
        for k, (scan, info) in fn_index.items():
            acc = acquired[k]
            before = len(acc)
            for callee, _line, _held in info.calls:
                _, mod, cls, name = callee
                target = (mod, cls, name)
                if target in acquired:
                    acc |= acquired[target]
                elif cls is not None and (mod, None, name) in acquired:
                    acc |= acquired[(mod, None, name)]
            if len(acc) != before:
                changed = True

    edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
    kinds: Dict[str, str] = {}
    for scan in scans:
        kinds.update(scan.lock_kind)
    kinds.setdefault(METRICS_LOCK, "Lock")
    kinds.setdefault(TRACE_LOCK, "Lock")
    for k, (scan, info) in fn_index.items():
        for a, b, line in info.nest_edges:
            edges.setdefault((a, b), []).append((scan.rel, line))
        for callee, line, held in info.calls:
            if not held:
                continue
            _, mod, cls, name = callee
            target = (mod, cls, name)
            if target not in acquired and cls is not None:
                target = (mod, None, name)
            for b in acquired.get(target, ()):
                for a in held:
                    edges.setdefault((a, b), []).append((scan.rel, line))
    return edges, kinds


def _cycles(edges: Dict[Tuple[str, str], list]) -> List[List[str]]:
    """Elementary cycles over the lock graph (DFS; the graph is tiny)."""
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str], seen: Set[str]) -> None:
        for nxt in graph.get(node, ()):
            if nxt == start and len(path) > 1:
                # canonicalize: rotate so the smallest node leads
                i = path.index(min(path))
                cycles.add(tuple(path[i:] + path[:i]))
            elif nxt not in seen and nxt >= start:
                dfs(start, nxt, path + [nxt], seen | {nxt})

    for start in sorted(graph):
        dfs(start, start, [start], {start})
    return [list(c) for c in sorted(cycles)]


def check(ctx: LintContext) -> List[Finding]:
    edges, kinds = _analyze(ctx)
    findings: List[Finding] = []
    for cycle in _cycles(edges):
        label = " -> ".join(cycle + [cycle[0]])
        if ctx.allowed(ALLOW_KEY, label):
            continue
        site_bits = []
        for a, b in zip(cycle, cycle[1:] + [cycle[0]]):
            f, line = edges[(a, b)][0]
            site_bits.append(f"{a}->{b} at {f}:{line}")
        f0, l0 = edges[(cycle[0], cycle[1] if len(cycle) > 1
                        else cycle[0])][0]
        findings.append(Finding(
            f0, l0, CYCLE_RULE, "error",
            f"lock-order cycle {label} (deadlock hazard): "
            + "; ".join(site_bits)))
    for (a, b), sites in sorted(edges.items()):
        if a == b and kinds.get(a) == "Lock":
            label = f"{a} -> {a}"
            if ctx.allowed(ALLOW_KEY, label):
                continue
            f, line = sites[0]
            findings.append(Finding(
                f, line, SELF_RULE, "error",
                f"non-reentrant {a} re-acquired while already held "
                f"(single-thread deadlock); first site {f}:{line}"))
    return findings


RULES = [Rule(
    id=CYCLE_RULE,
    doc="lock-acquisition graph over the threaded engine/batcher/obs code: "
        "cycles and non-reentrant re-acquisition are deadlock hazards",
    check=check,
    allow_key=ALLOW_KEY,
    emits=(SELF_RULE,),
)]
