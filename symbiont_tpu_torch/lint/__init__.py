"""Contract linter: AST/static analysis over the repo's own invariants.

``python -m symbiont_tpu_torch.lint`` — run every rule, print structured
``file:line rule-id severity message`` findings, exit non-zero on any.
Copy of the JAX package's `symbiont_tpu/lint/__init__.py`, over the port's
tree with the port's own allowlist (`allowlist.py`). See docs/LINTING.md
for the rule catalog and allowlist policy."""

from symbiont_tpu_torch.lint.engine import (  # noqa: F401
    Finding,
    LintContext,
    Rule,
    repo_root,
    run,
)
