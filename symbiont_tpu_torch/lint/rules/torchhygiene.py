"""Rule family: host-sync and graph-capture hygiene over the port's
``engine/``, ``models/`` and ``graphs.py``.

Counterpart of the JAX package's `symbiont_tpu/lint/rules/jaxhygiene.py`.
A device→host sync the dispatch layer did not mean to make, or an
executable built per call, is the same slow-bleed class as a blocked event
loop: nothing crashes, the serving path just gets slower. On CUDA both are
worse than on a TPU: every single-device engine executable is a CUDA graph
(`graphs.Executable`), a sync inside a capture breaks it, and a capture
outside the executable cache records a fresh graph per call. Two rules:

- ``torch-host-sync-in-loop`` (counterpart of ``jax-host-sync-in-loop``),
  over the host dispatch layer (engine/engine.py, engine/lm.py,
  engine/batcher.py):

  * ``.item()`` anywhere is a per-scalar sync;
  * ``.cpu()``, ``.to("cpu")``, ``torch.cuda.synchronize()`` and an event's
    or a stream's ``.synchronize()`` are waits on the device wherever they
    stand: torch has no lazy materialization that a later read triggers,
    so each such call IS the sync, and the rule flags it in or out of a
    loop (wider than JAX, whose ``np.asarray`` is its only form);
  * inside a ``for``/``while`` body, ``.tolist()`` and ``np.asarray`` /
    ``np.array`` / ``float`` on a value that may be a device tensor (the
    JAX rule's heuristic: names, attributes, subscripts, call results).
    These are ambiguous between host and device values, so they count
    only per iteration, as in JAX;
  * ``.numpy()`` is never flagged: torch refuses it on a CUDA tensor
    (TypeError), so it only reads a tensor already on the host. The sync
    is whatever brought the tensor there, and the rule flags that call:
    ``TorchEngine._fetch`` waits once on its copies' event
    (``done.synchronize()``) and then reads ``host.float().numpy()`` per
    group, which is no sync;
  * one level of ``self._helper()`` indirection: a method that takes its
    counter's ``site`` from its caller (a parameter named ``site``) reports
    its waits at each ``self.`` call site in its class, under the caller's
    scope. That is the name the runtime counter carries
    (``self._fetch(pending, out, "TorchEngine.embed_texts")``), so the
    allowlist and the ``engine.host_syncs_total{site}`` series are one
    inventory.

  Allowlisted sites are the inventory of every deliberate device→host sync
  on the serving path (TORCH_HOST_SYNC_ALLOWED), and ``obs/xprof.
  known_sync_sites()`` reads it.
- ``graph-capture-in-function`` (counterpart of ``jax-jit-in-function``),
  over engine/, models/ and graphs.py: ``torch.cuda.CUDAGraph()``,
  ``torch.cuda.graph(...)``, ``torch.cuda.make_graphed_callables(...)``
  and ``torch.compile`` (called or as a decorator) anywhere, ``__init__``
  and module level included, except an allowlisted executable-cache
  builder (TORCH_GRAPH_CAPTURE_ALLOWED: ``graphs.Executable.capture``).

``jax-static-args`` has no counterpart: torch has no trace-time static
arguments. A new shape reaches a new capture through ``ExecCache``'s keys,
and the capture rule covers where captures may be made.

Allowlist entries are ``(repo-relative-file, dotted-scope)`` pairs."""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from symbiont_tpu_torch.lint.engine import (
    Finding,
    LintContext,
    Rule,
    dotted_name,
    iter_own_scope,
    scoped_functions,
)

CAPTURE_RULE = "graph-capture-in-function"
SYNC_RULE = "torch-host-sync-in-loop"

SCOPE_DIRS = ("symbiont_tpu_torch/engine", "symbiont_tpu_torch/models",
              "symbiont_tpu_torch/graphs.py")
# host dispatch layer for the sync rule (models/ runs inside captures and
# eager forwards; convert.py is load-time host code)
SYNC_FILES = ("symbiont_tpu_torch/engine/engine.py",
              "symbiont_tpu_torch/engine/lm.py",
              "symbiont_tpu_torch/engine/batcher.py")

_LOOP_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                    "float"}
_CAPTURE_CALLS = {"torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
                  "torch.cuda.graph", "cuda.graph",
                  "torch.cuda.make_graphed_callables", "make_graphed_callables",
                  "torch.compile"}


def _device_ish(arg: ast.AST) -> bool:
    """Heuristic: expressions that can hold device tensors (names, attrs,
    subscripts, call results) — literals and comprehensions are host data."""
    return isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript,
                            ast.Call, ast.Starred))


def _to_cpu(node: ast.Call) -> bool:
    """`x.to("cpu")`, `x.to(device="cpu")` or `x.to(torch.device("cpu"))`."""
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and dotted_name(a.func) == "torch.device":
            a = a.args[0] if a.args else None
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def _sync_hits(fn: ast.AST) -> List[Tuple[int, str]]:
    """(line, description) for every host sync in `fn`'s own scope."""
    own = list(iter_own_scope(fn))
    in_loop: Set[int] = set()
    for lp in own:
        if isinstance(lp, (ast.For, ast.While)):
            in_loop.update(id(n) for n in iter_own_scope(lp))
    hits: List[Tuple[int, str]] = []
    for node in own:
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        looped = id(node) in in_loop
        if attr == "item" and not node.args:
            hits.append((node.lineno, ".item() is a per-scalar device sync — "
                         "keep the value on the device or fetch the whole "
                         "batch once"))
        elif (attr in ("cpu", "synchronize") and not node.args) or (
                attr == "to" and _to_cpu(node)):
            what = {"cpu": ".cpu()", "to": '.to("cpu")'}.get(attr, f"{d or ''}.synchronize()")
            hits.append((node.lineno, f"{what} waits on the device"
                         + (" once per iteration" if looped else "")
                         + " — fetch once per dispatched batch or chunk, "
                         "or allowlist the site as a deliberate sync"))
        elif looped and ((attr == "tolist" and not node.args) or (
                d in _LOOP_SYNC_CALLS and node.args
                and _device_ish(node.args[0]))):
            what = ".tolist()" if attr == "tolist" else f"{d}()"
            hits.append((node.lineno, f"{what} on a device value inside a "
                         "loop forces a device→host sync per iteration — "
                         "hoist the fetch out of the loop or allowlist the "
                         "site as a deliberate chunk-boundary sync"))
    return hits


def _site_helpers(fns) -> Dict[Tuple[str, str], list]:
    """(class, method) -> [(caller scope, call line)] for each method that
    takes its counter's `site` from its caller (a parameter named `site`),
    over its `self.<name>(...)` calls from its own class."""
    helpers = {(cls, fn.name) for fn, scope, cls in fns
               if cls and scope == f"{cls}.{fn.name}"
               and "site" in {a.arg for a in fn.args.args + fn.args.kwonlyargs}}
    calls: Dict[Tuple[str, str], list] = {}
    for fn, scope, cls in fns:
        for node in iter_own_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if (d and cls and d.startswith("self.") and d.count(".") == 1
                    and (cls, d[5:]) in helpers):
                calls.setdefault((cls, d[5:]), []).append((scope, node.lineno))
    return calls


def _check_host_sync(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.py_files(*SYNC_FILES):
        tree = ctx.tree(path)
        if tree is None:
            continue
        rel = ctx.rel(path)
        fns = scoped_functions(tree)
        helpers = _site_helpers(fns)
        hits: List[Tuple[str, int, str]] = []  # (scope, line, message)
        for fn, scope, cls in fns:
            own = _sync_hits(fn)
            callers = helpers.get((cls, fn.name)) if scope == f"{cls}.{fn.name}" else None
            if callers and own:
                for caller, line in callers:
                    for at, desc in own:
                        hits.append((caller, line,
                                     f"self.{fn.name}() at {rel}:{at}: {desc}"))
                continue
            hits.extend((scope, line, desc) for line, desc in own)
        for scope, line, desc in hits:
            if ctx.allowed(SYNC_RULE, (rel, scope)):
                continue
            findings.append(Finding(rel, line, SYNC_RULE, "error",
                                    f"{scope}: {desc}"))
    return findings


def _capture_name(node: ast.AST) -> Optional[str]:
    """The capture API `node` names, called or bare (a decorator)."""
    target = node.func if isinstance(node, ast.Call) else node
    d = dotted_name(target)
    return d if d in _CAPTURE_CALLS else None


def _check_graph_capture(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.py_files(*SCOPE_DIRS):
        tree = ctx.tree(path)
        if tree is None:
            continue
        rel = ctx.rel(path)
        sites: List[Tuple[str, int, str]] = []
        fns = scoped_functions(tree)
        for owner, scope in [(tree, "<module>")] + [(f, s) for f, s, _ in fns]:
            for node in iter_own_scope(owner):
                if isinstance(node, ast.Call) and _capture_name(node):
                    sites.append((scope, node.lineno, _capture_name(node)))
        # decorators sit outside every own scope: judged under the def
        for fn, scope, _cls in fns:
            for dec in fn.decorator_list:
                if _capture_name(dec):
                    sites.append((scope, dec.lineno, _capture_name(dec)))
        for scope, line, name in sites:
            if ctx.allowed(CAPTURE_RULE, (rel, scope)):
                continue
            findings.append(Finding(
                rel, line, CAPTURE_RULE, "error",
                f"{scope}: {name} outside the executable cache records or "
                "compiles a fresh program per call — go through "
                "graphs.Executable / ExecCache, or register the site as an "
                "executable-cache builder in the allowlist"))
    return findings


RULES = [
    Rule(id=CAPTURE_RULE,
         doc="CUDA-graph capture or torch.compile outside an allowlisted "
             "executable-cache builder (a fresh program per call)",
         check=_check_graph_capture,
         allow_key=CAPTURE_RULE),
    Rule(id=SYNC_RULE,
         doc="device→host syncs in the host dispatch layer (.item() and "
             "device waits anywhere; .tolist()/np.asarray/float in loops)",
         check=_check_host_sync,
         allow_key=SYNC_RULE),
]
