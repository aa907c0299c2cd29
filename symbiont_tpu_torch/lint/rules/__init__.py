"""Rule registry: every rule module contributes its RULES list here.

Copy of the JAX package's `symbiont_tpu/lint/rules/__init__.py`, with
`torchhygiene` where JAX registers `jaxhygiene`.

Order matters only for output grouping; findings are sorted by site. A new
rule family = a new module with a ``RULES`` list + an import line below
(and, if it takes exceptions, a table in allowlist.py)."""

from __future__ import annotations

from symbiont_tpu_torch.lint.rules import (
    asynchygiene,
    dataplane,
    knobs,
    locks,
    parity,
    torchhygiene,
    wiring,
)

RULES = (
    list(wiring.RULES)
    + list(dataplane.RULES)
    + list(asynchygiene.RULES)
    + list(locks.RULES)
    + list(torchhygiene.RULES)
    + list(parity.RULES)
    + list(knobs.RULES)
)

_ids = [r.id for r in RULES]
assert len(_ids) == len(set(_ids)), f"duplicate rule ids: {_ids}"
