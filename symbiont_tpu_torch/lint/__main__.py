"""CLI: ``python -m symbiont_tpu_torch.lint [--root DIR] [--rules a,b] [--list]``.

Exit codes: 0 clean, 1 findings (including stale allowlist entries),
2 usage error. Output is one ``file:line rule-id severity message`` line
per finding — grep/CI friendly, stable ordering.

Copy of the JAX package's `symbiont_tpu/lint/__main__.py`."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from symbiont_tpu_torch.lint.engine import repo_root, run
    from symbiont_tpu_torch.lint.rules import RULES

    parser = argparse.ArgumentParser(
        prog="python -m symbiont_tpu_torch.lint",
        description="the port's contract linter (docs/LINTING.md)")
    parser.add_argument("--root", default=None,
                        help="tree to lint (default: this repo)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--list", action="store_true", dest="list_rules",
                        help="list registered rules and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(f"{rule.id:28s} {rule.doc}")
            for sub in rule.emits:
                print(f"{sub:28s} ^ emitted by {rule.id} (same --rules "
                      "selector)")
        print(f"{'stale-allowlist':28s} engine-emitted: an allowlist entry "
              "whose site no longer exists (runs with every rule)")
        print(f"{'lint-parse':28s} engine-emitted: a scanned Python file "
              "that does not parse")
        return 0

    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    try:
        findings, _ctx = run(root=args.root or repo_root(),
                             rule_ids=rule_ids)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.render())
    if findings:
        print(f"\n{len(findings)} finding(s). See docs/LINTING.md "
              "(allowlist policy: symbiont_tpu_torch/lint/allowlist.py).",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
