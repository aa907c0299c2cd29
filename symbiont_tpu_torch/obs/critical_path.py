"""Latency attribution: the blocking chain of a parent-linked trace tree.

Copy of the JAX package's `symbiont_tpu/obs/critical_path.py`.

The flight recorder (obs/trace_store.py) answers "what spans ran"; this
module answers the question the ROADMAP's north star is judged by — "where
did the end-to-end time actually GO". Three ideas, all computed from the
same tree ``TraceStore.trace_tree`` already builds:

- **self-time vs child-time**: a span's duration includes every child that
  runs *within* its interval; ``self_ms`` is the duration minus the merged
  coverage of its children's intervals (clipped to the span). Children in
  this tree are CAUSAL, not nested — a bus-hop child routinely starts after
  its publishing parent already returned — and the clipping handles that:
  a child running outside the parent's interval removes nothing from the
  parent's self-time.
- **the blocking chain**: end-to-end latency ends when the LAST span ends;
  the chain is the parent-linked path from the root to that last-ending
  descendant. It is the minimal set of hops whose self-times explain the
  trace's wall clock; everything off the chain overlapped something on it.
- **the dominant hop**: the chain entry with the largest self-time — the
  one-line verdict (`"preprocessing.handle self-time 61.9% of e2e"`) an
  operator reads before anything else.

Served at ``GET /api/traces/<id>/critical_path`` (services/api.py), and
aggregated fleet-wide by ``aggregate_stage_attribution`` into ``stage.*``
series (fraction of e2e latency per hop, grouped by root span name) that
the bench e2e tier archives and docs/PERF.md renders as the "where the
time goes" table.

Like the trace store itself: no symbiont imports above the obs layer, no
device, pure arithmetic over recorded spans.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from symbiont_tpu_torch.obs.trace_store import TraceStore


def _merged_coverage(intervals: List[Tuple[float, float]],
                     lo: float, hi: float) -> float:
    """Total length of the union of ``intervals`` clipped to [lo, hi]."""
    clipped = sorted((max(lo, a), min(hi, b)) for a, b in intervals
                     if b > lo and a < hi)
    covered, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        elif b > cur_b:
            cur_b = b
    if cur_b is not None:
        covered += cur_b - cur_a
    return covered


def annotate_self_times(tree: dict) -> dict:
    """Mutate-and-return: add ``self_ms``/``child_ms``/``end_ms`` to every
    node of a ``trace_tree`` result (nodes carry start_ms/duration_ms/
    children)."""
    stack = list(tree["roots"])
    while stack:  # iterative: a deep causal chain must not hit the
        node = stack.pop()  # interpreter recursion limit
        a = node["start_ms"]
        b = a + node["duration_ms"]
        node["end_ms"] = round(b, 3)
        kids = [(c["start_ms"], c["start_ms"] + c["duration_ms"])
                for c in node["children"]]
        covered = _merged_coverage(kids, a, b)
        node["child_ms"] = round(covered, 3)
        node["self_ms"] = round(max(0.0, node["duration_ms"] - covered), 3)
        stack.extend(node["children"])
    return tree


def _subtree_ends(roots: List[dict]) -> Dict[int, float]:
    """One post-order pass: id(node) → latest end time anywhere in the
    node's subtree. Iterative and memoized — the chain walk below must be
    O(total spans), not O(spans × chain length)."""
    ends: Dict[int, float] = {}
    stack: List[Tuple[dict, bool]] = [(r, False) for r in roots]
    while stack:
        node, expanded = stack.pop()
        if not expanded:
            stack.append((node, True))
            stack.extend((c, False) for c in node["children"])
        else:
            end = node["start_ms"] + node["duration_ms"]
            for c in node["children"]:
                end = max(end, ends[id(c)])
            ends[id(node)] = end
    return ends


def blocking_chain(tree: dict) -> List[dict]:
    """The parent-linked path from a root to the last-ending descendant.

    Root choice: the root whose subtree contains the trace's final end
    (orphaned roots — parents evicted or hops through the span-less native
    workers — compete on equal footing, so a partial trace still yields a
    chain). At each step, descend into the child whose SUBTREE ends last;
    stop when the current span itself outlasts every child subtree."""
    if not tree["roots"]:
        return []
    ends = _subtree_ends(tree["roots"])
    root = max(tree["roots"], key=lambda n: ends[id(n)])
    chain = [root]
    node = root
    while node["children"]:
        blocker = max(node["children"], key=lambda n: ends[id(n)])
        own_end = node["start_ms"] + node["duration_ms"]
        if ends[id(blocker)] < own_end:
            break  # the span's own tail, not any child, gates its end
        chain.append(blocker)
        node = blocker
    return chain


def critical_path(tree: dict) -> dict:
    """Full attribution report for one ``trace_tree`` result.

    ``gap_ms`` is the e2e time no chain span claims as self-time: bus queue
    waits between hops, scheduling, and anything that ran in processes that
    record no spans. It is reported, not hidden — a large gap IS a finding
    (the pipeline waited, it did not compute)."""
    annotate_self_times(tree)
    chain = blocking_chain(tree)
    e2e = tree["duration_ms"] or 0.0

    def share(ms: float) -> float:
        return round(100.0 * ms / e2e, 1) if e2e > 0 else 0.0

    chain_out = [{
        "name": n["name"],
        "span_id": n["span_id"],
        "start_ms": n["start_ms"],
        "duration_ms": n["duration_ms"],
        "self_ms": n["self_ms"],
        "child_ms": n["child_ms"],
        "status": n["status"],
        "share_of_e2e_pct": share(n["self_ms"]),
    } for n in chain]
    chain_self = sum(n["self_ms"] for n in chain)
    gap_ms = round(max(0.0, e2e - chain_self), 3)
    dominant = (max(chain_out, key=lambda n: n["self_ms"])
                if chain_out else None)
    verdict = None
    if dominant is not None:
        verdict = (f"{dominant['name']} self-time {dominant['self_ms']} ms "
                   f"= {dominant['share_of_e2e_pct']}% of e2e "
                   f"{round(e2e, 3)} ms")
        if gap_ms > (dominant["self_ms"] or 0.0):
            verdict += (f" (but untraced gap {gap_ms} ms dominates — the "
                        f"pipeline waited between hops)")
    return {
        "trace_id": tree["trace_id"],
        "e2e_ms": e2e,
        "span_count": tree["span_count"],
        "error_count": tree["error_count"],
        "chain": chain_out,
        "chain_self_ms": round(chain_self, 3),
        "gap_ms": gap_ms,
        "gap_pct": share(gap_ms),
        "dominant": dominant,
        "verdict": verdict,
    }


def compute(store: TraceStore, trace_id: str) -> Optional[dict]:
    """Critical-path report for one recorded trace; None when the flight
    recorder holds nothing for this id (evicted or never recorded)."""
    tree = store.trace_tree(trace_id)
    if tree is None:
        return None
    return critical_path(tree)


# ------------------------------------------------- fleet-wide attribution

def safe_key(name: str) -> str:
    """Span name → archive-field-safe fragment (dots and hostile chars
    become underscores; bench fields must stay flat identifiers)."""
    return re.sub(r"[^a-zA-Z0-9_]", "_", name).strip("_")


def aggregate_stage_attribution(store: TraceStore, limit: int = 512,
                                min_spans: int = 2) -> Dict[str, dict]:
    """Mean per-hop share of e2e latency across the recorder's traces,
    grouped by ROOT span name (one pipeline = one root: ``api.submit_url``
    is the ingest pipeline, ``api.generate_text`` the generation one).

    Only blocking-chain hops are attributed, so per-trace shares (plus the
    untraced gap) sum to ≤100% even when parallel fan-out overlaps. Traces
    with fewer than ``min_spans`` spans are skipped — a lone root span has
    no chain to attribute. One ring pass total (``spans_by_trace``); over
    ``limit`` distinct traces, the NEWEST-recorded win."""
    from symbiont_tpu_torch.obs.trace_store import tree_from_spans

    out: Dict[str, dict] = {}
    if limit <= 0:
        return out
    groups = list(store.spans_by_trace().items())[-int(limit):]
    for trace_id, spans in groups:
        if len(spans) < min_spans:
            continue
        tree = tree_from_spans(trace_id, spans)
        report = critical_path(tree)
        if not report["chain"] or report["e2e_ms"] <= 0:
            continue
        root_name = report["chain"][0]["name"]
        agg = out.setdefault(root_name, {
            "count": 0, "e2e_ms_sum": 0.0, "gap_sum": 0.0, "stages": {}})
        agg["count"] += 1
        agg["e2e_ms_sum"] += report["e2e_ms"]
        agg["gap_sum"] += report["gap_pct"] / 100.0
        for hop in report["chain"]:
            agg["stages"][hop["name"]] = (
                agg["stages"].get(hop["name"], 0.0)
                + hop["share_of_e2e_pct"] / 100.0)
    for root_name, agg in out.items():
        n = agg.pop("count")
        agg["count"] = n
        agg["e2e_ms"] = round(agg.pop("e2e_ms_sum") / n, 3)
        agg["gap_frac"] = round(agg.pop("gap_sum") / n, 4)
        agg["stages"] = {hop: round(s / n, 4)
                        for hop, s in agg["stages"].items()}
    return out


def export_stage_gauges(attr: Dict[str, dict], registry=None) -> None:
    """Publish an aggregation as ``stage.*`` gauges (docs/OBSERVABILITY.md):
    ``stage.fraction{pipeline,stage}``, ``stage.gap_fraction{pipeline}``,
    ``stage.e2e_ms{pipeline}``, ``stage.traces{pipeline}``. The bench e2e
    tier calls this right before archiving ``metrics_snapshot``, so the
    fleet view rides every BENCH_*.json line."""
    from symbiont_tpu_torch.utils.telemetry import metrics as _global_metrics

    registry = registry or _global_metrics
    for pipeline, agg in attr.items():
        for hop, frac in agg["stages"].items():
            registry.gauge_set("stage.fraction", frac,
                               labels={"pipeline": pipeline, "stage": hop})
        registry.gauge_set("stage.gap_fraction", agg["gap_frac"],
                           labels={"pipeline": pipeline})
        registry.gauge_set("stage.e2e_ms", agg["e2e_ms"],
                           labels={"pipeline": pipeline})
        registry.gauge_set("stage.traces", agg["count"],
                           labels={"pipeline": pipeline})
