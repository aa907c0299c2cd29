"""Contract-linter core: context, findings, allowlist bookkeeping, runner.

Copy of the JAX package's `symbiont_tpu/lint/engine.py`, over the port:
`repo_root()` resolves from this package's location, the default
allowlists are the port's own (`symbiont_tpu_torch/lint/allowlist.py`),
a stale entry's finding names that file, and `LintContext.files_scanned()`
counts the files a run read. One repair: `py_files` skips `build/`,
`dist/` and cache dirs below the scanned dir only, where JAX's judges the
whole absolute path and so scans nothing of a checkout under a `build/`.

The ad-hoc static scans that used to live inside tests/test_pipeline_wiring.py
(subject wiring, per-float bans, frame-dtype bans) proved the approach: the
bug classes that ship silently here — a dead consumer limb, a blocking call
on the event loop, a lock-order inversion, a drifted C++ mirror of a wire
constant, an undocumented knob — are all *statically visible*. This package
graduates those scans into one rule engine:

- ``python -m symbiont_tpu_torch.lint`` runs every rule over the repo and prints
  structured ``file:line rule-id severity message`` findings, exiting
  non-zero on ANY finding;
- every deliberate exception lives in ONE central allowlist module
  (``symbiont_tpu_torch/lint/allowlist.py``) with a reason string, and a stale
  entry — one whose site no longer exists — is itself an error, so the
  allowlist can only ever shrink ratchet-style (the convention
  test_pipeline_wiring.py established);
- rules are pure functions over a ``LintContext`` (parsed ASTs + raw text
  under a root directory), so tests/test_torch_lint.py proves each rule
  fires by pointing the SAME engine at synthetic known-violation trees.

Rule catalog and how to add a rule: docs/LINTING.md (the JAX package's
catalog; the port's rules are the same families, `jax-*` replaced by
`rules/torchhygiene.py`).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# severity levels, strongest first. Everything the engine ships today is an
# "error" (rc != 0); "warn" is rendered and counted but exists for
# downstream tooling that may want a soft-launch phase for a new rule.
SEVERITIES = ("error", "warn")


@dataclass(frozen=True)
class Finding:
    """One structured lint finding (sortable, hashable, renderable)."""

    file: str      # repo-relative path
    line: int      # 1-based; 0 when the finding is repo-level
    rule: str      # rule id (kebab-case)
    severity: str  # one of SEVERITIES
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line} {self.rule} {self.severity} {self.message}"

    def sort_key(self) -> Tuple[str, int, str]:
        return (self.file, self.line, self.rule)


@dataclass(frozen=True)
class Rule:
    """One registered rule: ``check(ctx)`` yields Findings. ``allow_key``
    names the central-allowlist table the rule consults (usually its own
    id); None means the rule takes no exceptions. ``emits`` lists any
    ADDITIONAL finding ids the check produces beyond its own id (one pass
    may judge two related contracts) — ``--rules <emitted-id>`` selects
    the owning rule, so every id printed in a finding is reproducible."""

    id: str
    doc: str
    check: callable
    allow_key: Optional[str] = None
    emits: Tuple[str, ...] = ()


STALE_RULE_ID = "stale-allowlist"

_PY_SKIP_DIRS = {"__pycache__", ".git", "build", "dist"}


class LintContext:
    """Shared state for one lint run: file discovery with caching, parsed
    ASTs, and allowlist hit-tracking (the staleness ratchet)."""

    def __init__(self, root, allowlists: Optional[Dict[str, dict]] = None):
        self.root = Path(root).resolve()
        if allowlists is None:
            from symbiont_tpu_torch.lint.allowlist import ALLOWLISTS
            allowlists = ALLOWLISTS
        # rule id -> {entry: reason}; entries are rule-defined (documented
        # per table in allowlist.py)
        self.allowlists: Dict[str, dict] = allowlists
        self._hits: Dict[str, set] = {}
        self._text: Dict[Path, str] = {}
        self._tree: Dict[Path, Optional[ast.AST]] = {}
        self.parse_failures: List[Finding] = []

    # ------------------------------------------------------------ discovery

    def rel(self, path: Path) -> str:
        return str(Path(path).resolve().relative_to(self.root))

    def py_files(self, *rel_dirs: str) -> List[Path]:
        """Python files under the given repo-relative dirs (sorted); a
        missing dir contributes nothing (synthetic fixture trees carry only
        the files a rule needs)."""
        out: List[Path] = []
        for d in rel_dirs:
            base = self.root / d
            if base.is_file() and base.suffix == ".py":
                out.append(base)
                continue
            if not base.is_dir():
                continue
            # skip dirs are judged below the scanned dir: a checkout that
            # itself sits under a directory named build/ is still scanned
            out.extend(p for p in base.rglob("*.py")
                       if not _PY_SKIP_DIRS & set(p.relative_to(base).parts))
        return sorted(set(out))

    def native_files(self, *rel_dirs: str) -> List[Path]:
        out: List[Path] = []
        for d in rel_dirs or ("native",):
            base = self.root / d
            if not base.is_dir():
                continue
            for ext in ("*.cpp", "*.hpp", "*.h"):
                out.extend(base.rglob(ext))
        return sorted(set(out))

    # -------------------------------------------------------------- content

    def text(self, path: Path) -> str:
        path = Path(path)
        if path not in self._text:
            self._text[path] = path.read_text(errors="replace")
        return self._text[path]

    def files_scanned(self) -> int:
        """Distinct files this run has read (Python, native and docs)."""
        return len(self._text)

    def tree(self, path: Path) -> Optional[ast.AST]:
        """Parsed AST, or None on a syntax error (recorded once as a
        finding — an unparseable file must fail the run loudly, not
        silently escape every AST rule)."""
        path = Path(path)
        if path not in self._tree:
            try:
                self._tree[path] = ast.parse(self.text(path),
                                             filename=str(path))
            except SyntaxError as e:
                self._tree[path] = None
                self.parse_failures.append(Finding(
                    self.rel(path), int(e.lineno or 0), "lint-parse",
                    "error", f"file does not parse: {e.msg}"))
        return self._tree[path]

    # ------------------------------------------------------------ allowlist

    def allowed(self, rule_key: str, entry) -> bool:
        """True when `entry` is allowlisted for `rule_key`; records the hit
        either way so stale_entries() can report entries nothing matched."""
        table = self.allowlists.get(rule_key) or {}
        if entry in table:
            self._hits.setdefault(rule_key, set()).add(entry)
            return True
        return False

    def stale_entries(self, rule_key: str) -> list:
        table = self.allowlists.get(rule_key) or {}
        hits = self._hits.get(rule_key, set())
        return sorted(e for e in table if e not in hits)


def _dedup(findings: Iterable[Finding]) -> List[Finding]:
    seen, out = set(), []
    for f in findings:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def run(root=None, rule_ids: Optional[Sequence[str]] = None,
        allowlists: Optional[Dict[str, dict]] = None,
        ) -> Tuple[List[Finding], LintContext]:
    """Run the rule engine. Returns (sorted findings, the context).

    ``rule_ids=None`` runs every registered rule; a subset runs only those
    (allowlist staleness is then judged only for the rules that ran — an
    unexercised table cannot be called stale)."""
    from symbiont_tpu_torch.lint.rules import RULES

    if root is None:
        root = repo_root()
    ctx = LintContext(root, allowlists=allowlists)
    selected = list(RULES)
    if rule_ids is not None:
        wanted = set(rule_ids)
        known = set()
        for r in RULES:
            known.add(r.id)
            known.update(r.emits)
        unknown = wanted - known
        if unknown:
            raise KeyError(f"unknown rule id(s): {sorted(unknown)} "
                           f"(known: {sorted(known)})")
        selected = [r for r in RULES
                    if r.id in wanted or wanted & set(r.emits)]
    findings: List[Finding] = []
    for rule in selected:
        findings.extend(rule.check(ctx))
        # stale allowlist entries are errors of the same rank as real
        # violations: a dead exception is a hole the next regression
        # walks through unseen
        if rule.allow_key:
            for entry in ctx.stale_entries(rule.allow_key):
                findings.append(Finding(
                    "symbiont_tpu_torch/lint/allowlist.py", 0, STALE_RULE_ID,
                    "error",
                    f"allowlist entry for rule {rule.id!r} no longer "
                    f"matches any site — prune it: {entry!r}"))
    findings.extend(ctx.parse_failures)
    return sorted(_dedup(findings), key=Finding.sort_key), ctx


def repo_root() -> Path:
    """The repo this package is installed from (lint targets its own
    source tree — the package layout IS the contract being linted)."""
    return Path(__file__).resolve().parents[2]


# --------------------------------------------------------- shared AST helpers

def scoped_functions(tree: ast.AST) -> List[Tuple[ast.AST, str,
                                                  Optional[str]]]:
    """(def-node, dotted scope path, enclosing class name) for every
    def/async-def in the module, depth-first — THE walker behind every
    rule that names sites by dotted scope, so site spelling can never
    diverge between rules (and allowlist entries stay portable)."""
    out: List[Tuple[ast.AST, str, Optional[str]]] = []

    def visit(node: ast.AST, stack: List[str], cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, stack + [child.name], child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                path = stack + [child.name]
                out.append((child, ".".join(path), cls))
                visit(child, path, cls)
            else:
                visit(child, stack, cls)

    visit(tree, [], None)
    return out


def scope_sites(path_text: str, pattern: re.Pattern,
                skip_comments: bool = True) -> List[Tuple[str, int]]:
    """(dotted-scope, line-no) for every `pattern` hit, qualifying nested
    scopes with an indent stack (``EngineService._rerank.op``) — the exact
    site-naming convention the pipeline-wiring scans established, so the
    migrated allowlist entries keep their spelling. Comment lines are
    skipped by default: bans are about code, and the docs that EXPLAIN a
    ban must be allowed to name it."""
    scope_re = re.compile(r"^(\s*)(?:(?:async\s+)?def|class)\s+(\w+)")
    sites: List[Tuple[str, int]] = []
    stack: List[Tuple[int, str]] = []  # (indent, name)
    for lineno, line in enumerate(path_text.splitlines(), 1):
        m = scope_re.match(line)
        if m:
            indent = len(m.group(1))
            while stack and stack[-1][0] >= indent:
                stack.pop()
            stack.append((indent, m.group(2)))
        if skip_comments and line.lstrip().startswith("#"):
            continue
        if pattern.search(line):
            sites.append((".".join(n for _, n in stack) or "<module>",
                          lineno))
    return sites


def iter_own_scope(node: ast.AST):
    """Yield `node`'s descendants WITHOUT descending into nested
    function/lambda bodies — those are other scopes (typically running on
    an executor, or reported under their own dotted scope by
    scoped_functions, never double-reported under the enclosing one)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from iter_own_scope(child)


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for Name/Attribute chains; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
