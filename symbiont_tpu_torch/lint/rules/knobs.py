"""Rule: knob/doc drift (``knob-doc-drift``).

Copy of the JAX package's `symbiont_tpu/lint/rules/knobs.py`, over the
port's literal reads and `native/`. A knob only the port reads has its
row in README.md's section on the port.

Statically complements the RUNTIME metric-drift check in
tests/test_obs_doc_drift.py: that test proves every registered metric has
an OBSERVABILITY.md row; this rule proves every ``SYMBIONT_*`` environment
variable read ANYWHERE — Python (``os.environ.get`` / ``os.environ[...]``
/ ``os.getenv``) or the native C++ tree (``env_or`` / ``getenv``) — has a
documentation row in ``README.md`` or ``docs/*.md``. An undocumented knob
is operationally invisible: it ships, someone sets it in one deployment,
and the next operator cannot discover it without grepping source.

Scope note: the config layer's systematic ``SYMBIONT_<SECTION>_<FIELD>``
overrides (config.py ``_apply_overrides``) are constructed at runtime and
are documented as a CONVENTION (one row per section); this rule covers the
LITERAL reads — exactly the ad-hoc knobs that bypass the config system and
therefore its documentation trail. A literal read of a config-derived name
(the C++ shells read several) still needs its row: the shells' env
contract IS their deployment interface.

No allowlist: the fix for an undocumented knob is a docs row, not an
exception (docs/DEPLOYMENT.md "Environment knob reference" is the default
home)."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from symbiont_tpu_torch.lint.engine import Finding, LintContext, Rule

RULE_ID = "knob-doc-drift"

_PY_READ = re.compile(
    r"(?:environ\.get\(\s*|environ\[\s*|getenv\(\s*)"
    r"[\"'](SYMBIONT_[A-Z0-9_]+)[\"']")
_CPP_READ = re.compile(
    r"(?:env_or|getenv)\(\s*\"(SYMBIONT_[A-Z0-9_]+)\"")

DOC_FILES = ("README.md",)
DOC_DIRS = ("docs",)


def _documented_vars(ctx: LintContext) -> str:
    chunks = []
    for rel in DOC_FILES:
        p = ctx.root / rel
        if p.is_file():
            chunks.append(ctx.text(p))
    for d in DOC_DIRS:
        base = ctx.root / d
        if base.is_dir():
            for p in sorted(base.glob("*.md")):
                chunks.append(ctx.text(p))
    return "\n".join(chunks)


def _reads(ctx: LintContext) -> List[Tuple[str, int, str]]:
    out: List[Tuple[str, int, str]] = []
    for p in ctx.py_files("symbiont_tpu_torch"):
        text = ctx.text(p)
        for m in _PY_READ.finditer(text):
            out.append((ctx.rel(p), text[:m.start()].count("\n") + 1,
                        m.group(1)))
    for p in ctx.native_files():
        text = ctx.text(p)
        for m in _CPP_READ.finditer(text):
            out.append((ctx.rel(p), text[:m.start()].count("\n") + 1,
                        m.group(1)))
    return out


def check(ctx: LintContext) -> List[Finding]:
    docs = _documented_vars(ctx)
    findings: List[Finding] = []
    first_site: Dict[str, Tuple[str, int]] = {}
    for rel, line, var in _reads(ctx):
        first_site.setdefault(var, (rel, line))
    for var in sorted(first_site):
        # exact-name match: a knob that is a PREFIX of a documented one
        # (SYMBIONT_API_FUSED_SEARCH vs ..._TIMEOUT_S) is not documented
        # by the longer row
        if re.search(re.escape(var) + r"(?![A-Z0-9_])", docs):
            continue
        rel, line = first_site[var]
        findings.append(Finding(
            rel, line, RULE_ID, "error",
            f"env knob {var} is read here but documented nowhere in "
            "README.md or docs/*.md — add a row (docs/DEPLOYMENT.md "
            "'Environment knob reference' is the default home)"))
    return findings


RULES = [Rule(
    id=RULE_ID,
    doc="every literal SYMBIONT_* env read (Python or C++) must have a "
        "docs row",
    check=check,
)]
