"""Rule: subject-wiring analysis (``subject-dead-limb``,
``subject-full-duplex``).

Copy of the JAX package's `symbiont_tpu/lint/rules/wiring.py`: the
subject table is the port's `subjects.py`, the Python producers and
consumers are the port's, and `native/` is read as before.

The reference SHIPPED a dead limb — knowledge_graph_service subscribed
``data.processed_text.tokenized`` while nothing published it (SURVEY.md
fact #3): the whole knowledge-graph path was silently inert in v0.3.0.
This rule (graduated from tests/test_pipeline_wiring.py, which now runs it
as a thin shim) makes that bug class impossible to reintroduce: it walks
every Python AND native C++ source for ``subjects.<NAME>`` /
``subjects::<NAME>`` references (and literal subject strings in the C++
tree), classifies each site as producer (publish / request / engine_call)
or consumer (subscribe / durable_subscribe / _subscribe_loop), and flags

- any subscribed-but-never-published subject (``subject-dead-limb``;
  allowlist SUBJECTS_UNPRODUCED_ALLOWED documents deliberately exported
  RPC endpoints with no in-repo caller — an entry whose subscription
  disappears is stale and errors);
- any reference-parity pipeline subject (the ``ALL_SUBJECTS`` table)
  missing either direction (``subject-full-duplex``)."""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from symbiont_tpu_torch.lint.engine import Finding, LintContext, Rule

DEAD_RULE = "subject-dead-limb"
DUPLEX_RULE = "subject-full-duplex"
ALLOW_KEY = "subject-unproduced"

PY_SUBJECTS = "symbiont_tpu_torch/subjects.py"

# producer call tokens: the Python bus surface plus the native helper that
# wraps request-reply to the engine plane (native/services/common.hpp)
_PRODUCER_CALLS = ("publish(", "request(", "engine_call(")
# consumer call tokens; "await sub(" covers engine_service's local alias
# `sub = self._subscribe_loop`
_CONSUMER_CALLS = ("durable_subscribe(", "_subscribe_loop(", "subscribe(",
                   "await sub(")
_NEITHER_CALLS = ("add_stream(",)  # capture config, not production

_CONST_REF = re.compile(r"subjects(?:\.|::)([A-Z][A-Z0-9_]*)")


def subject_constants(ctx: LintContext) -> Dict[str, str]:
    """NAME -> value for every real subject constant in subjects.py
    (queue-group names — the ``q.`` namespace — are subscription
    arguments, not subjects), plus the names listed in ALL_SUBJECTS."""
    tree = ctx.tree(ctx.root / PY_SUBJECTS)
    consts: Dict[str, str] = {}
    if tree is None:
        return consts
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            v = node.value.value
            if isinstance(v, str) and not v.startswith("q."):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id.isupper():
                        consts[tgt.id] = v
    return consts


def all_subjects_names(ctx: LintContext) -> List[str]:
    """The ALL_SUBJECTS table as constant NAMES (full-duplex contract)."""
    tree = ctx.tree(ctx.root / PY_SUBJECTS)
    if tree is None:
        return []
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "ALL_SUBJECTS"
                        for t in node.targets)
                and isinstance(node.value, ast.List)):
            return [el.id for el in node.value.elts
                    if isinstance(el, ast.Name)]
    return []


def _classify(context: str):
    """Nearest preceding call token wins (multi-line calls put the callee
    before the subject argument)."""
    best_pos, best_kind = -1, None
    for token, kind in (
            [(t, "producer") for t in _PRODUCER_CALLS]
            + [(t, "consumer") for t in _CONSUMER_CALLS]
            + [(t, None) for t in _NEITHER_CALLS]):
        i = context.rfind(token)
        if i > best_pos:
            best_pos, best_kind = i, kind
    return best_kind if best_pos >= 0 else None


def scan(ctx: LintContext) -> Tuple[Dict[str, Set[str]],
                                    Dict[str, Set[str]]]:
    """(producers, consumers): subject-constant NAME -> set of
    repo-relative files with at least one site of that kind."""
    consts = subject_constants(ctx)
    by_value = {v: k for k, v in consts.items()}
    producers: Dict[str, Set[str]] = {}
    consumers: Dict[str, Set[str]] = {}
    files = [p for p in ctx.py_files("symbiont_tpu_torch")
             if p.name != "subjects.py"]
    native = ctx.native_files()
    for f in files + native:
        text = ctx.text(f)
        hits = [(m.start(), m.group(1)) for m in _CONST_REF.finditer(text)
                if m.group(1) in consts]
        if f in native:
            # native code may also use the literal subject string (e.g.
            # knowledge_graph.cpp's engine_call(bus, "engine.graph.save"))
            for value, name in by_value.items():
                for m in re.finditer(re.escape(f'"{value}"'), text):
                    hits.append((m.start(), name))
        for pos, name in hits:
            kind = _classify(text[max(0, pos - 200):pos])
            target = {"producer": producers,
                      "consumer": consumers}.get(kind)
            if target is not None:
                target.setdefault(name, set()).add(ctx.rel(f))
    return producers, consumers


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    consts = subject_constants(ctx)
    if not consts:
        return findings
    producers, consumers = scan(ctx)
    dead = set(consumers) - set(producers)
    for name in sorted(dead):
        if ctx.allowed(ALLOW_KEY, name):
            continue
        findings.append(Finding(
            PY_SUBJECTS, 0, DEAD_RULE, "error",
            f"dead limb: {consts[name]!r} ({name}) is subscribed in "
            f"{sorted(consumers[name])} but published nowhere — the "
            "reference's data.processed_text.tokenized bug class"))
    # an allowlist entry stays LIVE while its subscription exists (it
    # documents a deliberately-exported endpoint); it only goes stale when
    # nothing subscribes it any more — the original staleness convention
    for name in ctx.allowlists.get(ALLOW_KEY, {}):
        if name in consumers:
            ctx.allowed(ALLOW_KEY, name)
    for name in all_subjects_names(ctx):
        if name not in producers:
            findings.append(Finding(
                PY_SUBJECTS, 0, DUPLEX_RULE, "error",
                f"pipeline subject {consts.get(name, name)!r} has no "
                "producer (ALL_SUBJECTS is the full-duplex parity table)"))
        if name not in consumers:
            findings.append(Finding(
                PY_SUBJECTS, 0, DUPLEX_RULE, "error",
                f"pipeline subject {consts.get(name, name)!r} has no "
                "consumer (ALL_SUBJECTS is the full-duplex parity table)"))
    return findings


RULES = [Rule(
    id=DEAD_RULE,
    doc="subscribed-but-never-published subjects (dead limbs) and "
        "one-directional pipeline subjects",
    check=check,
    allow_key=ALLOW_KEY,
    emits=(DUPLEX_RULE,),
)]
