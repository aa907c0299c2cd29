"""Rule family: data-plane regression guards over ``services/``
(graduated from tests/test_pipeline_wiring.py; the test file is now a thin
shim over these rules).

Copy of the JAX package's `symbiont_tpu/lint/rules/dataplane.py`, over the
port's `services/`.

- ``no-per-float-conversion``: a ``[float(x) for ...]`` list comprehension
  inside services/ is exactly the per-float serialization wall the binary
  tensor-frame plane removed (docs/PERF.md "data plane") — bulk floats ride
  schema/frames or ``ndarray.tolist()``. Allowlisted: bounded latency-path
  payloads (top-k scores), FLOAT_LIST_ALLOWED.
- ``no-asdict-on-ingest``: ``dataclasses.asdict`` recursively materializes
  a dict per field per call — the per-message churn the zero-churn decode
  removed. Payload dicts on message paths are built directly (their keys
  pinned by tests/test_store_wire_fixtures.py). ASDICT_ALLOWED is empty
  and should stay that way.
- ``no-hardcoded-frame-dtype``: the SYTF dtype registry (name ↔ header
  byte ↔ numpy dtype ↔ content type) lives in schema/frames.py and
  NOWHERE else; a service hand-rolling a frame header, magic, dtype byte
  or dtype-name literal is how a future dtype ends up half-wired. Exactly
  one encoder may map a negotiated encoding value to a dtype name
  (FRAME_DTYPE_ALLOWED).

Sites are named ``(repo-relative file, dotted scope)`` via the shared
indent-stack scanner (engine.scope_sites) so allowlist entries pin ONE
exact function, not every handler's inner ``op``. Comment lines are
exempt: a ban is about code, and the docs that EXPLAIN the ban must be
allowed to name it."""

from __future__ import annotations

import re
from typing import List, Set, Tuple

from symbiont_tpu_torch.lint.engine import (
    Finding,
    LintContext,
    Rule,
    scope_sites,
)

FLOAT_RULE = "no-per-float-conversion"
ASDICT_RULE = "no-asdict-on-ingest"
DTYPE_RULE = "no-hardcoded-frame-dtype"

SCOPE_DIR = "symbiont_tpu_torch/services"

_FLOAT_LIST = re.compile(r"\[\s*float\(")
_ASDICT = re.compile(r"\basdict\s*\(")
# hand-rolled content types, the frame magic, dtype-constant references,
# or quoted dtype-name literals — anywhere in services/
_FRAME_DTYPE = re.compile(r"""tensor/f|SYTF|DTYPE_F|["']f(?:16|32)["']""")


def pattern_sites(ctx: LintContext,
                  pattern: re.Pattern) -> Set[Tuple[str, str, int]]:
    """(file, dotted-scope, line) for every pattern hit in services/."""
    sites: Set[Tuple[str, str, int]] = set()
    for f in ctx.py_files(SCOPE_DIR):
        rel = ctx.rel(f)
        for scope, line in scope_sites(ctx.text(f), pattern):
            sites.add((rel, scope, line))
    return sites


def _check(ctx: LintContext, pattern: re.Pattern, rule_id: str,
           message: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel, scope, line in sorted(pattern_sites(ctx, pattern)):
        if ctx.allowed(rule_id, (rel, scope)):
            continue
        findings.append(Finding(rel, line, rule_id, "error",
                                f"{scope}: {message}"))
    return findings


def check_float(ctx: LintContext) -> List[Finding]:
    return _check(
        ctx, _FLOAT_LIST, FLOAT_RULE,
        "per-float Python conversion on a services/ message path — the "
        "serialization wall the tensor-frame data plane removed "
        "(docs/PERF.md 'data plane'). Use schema/frames or "
        "ndarray.tolist() instead")


def check_asdict(ctx: LintContext) -> List[Finding]:
    return _check(
        ctx, _ASDICT, ASDICT_RULE,
        "dataclasses.asdict on a services/ message path — per-message "
        "dict churn the zero-churn ingest decode removed (schema/frames "
        "decode_embeddings_lazy + direct payload dict build). Build the "
        "dict directly instead")


def check_dtype(ctx: LintContext) -> List[Finding]:
    return _check(
        ctx, _FRAME_DTYPE, DTYPE_RULE,
        "hard-coded frame dtype outside schema/frames.py — the dtype "
        "registry is centralized there so new dtypes (f16 was the first) "
        "wire every hop at once. Call frames.attach_frame/encode_frame "
        "with a negotiated name instead")


RULES = [
    Rule(id=FLOAT_RULE,
         doc="[float(x) for ...] banned on services/ message paths",
         check=check_float, allow_key=FLOAT_RULE),
    Rule(id=ASDICT_RULE,
         doc="dataclasses.asdict banned on services/ message paths",
         check=check_asdict, allow_key=ASDICT_RULE),
    Rule(id=DTYPE_RULE,
         doc="frame dtype knowledge banned outside schema/frames.py",
         check=check_dtype, allow_key=DTYPE_RULE),
]
