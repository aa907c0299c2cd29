"""Chrome Trace Format export of a recorded trace (Perfetto-loadable).

Copy of the JAX package's `symbiont_tpu/obs/chrome_trace.py`.

The flight recorder's JSON tree is greppable; a TIMELINE is how humans find
the 400 ms hole between two hops. This module renders any recorded trace as
Chrome Trace Format JSON (the "JSON Array/Object format" both
chrome://tracing and https://ui.perfetto.dev open directly):

- one PROCESS lane per role: spans stitched across OS processes by the
  fleet telemetry plane (obs/fleet.py) carry ``role``/``pid`` fields — each
  role renders as its own pid with a ``process_name`` metadata event, so a
  multi-process trace shows separate Perfetto process tracks instead of
  collapsing every service into threads of one fake process. Spans without
  role metadata (a single-process recording) keep the historical lane
  (pid 1, "symbiont flight recorder") byte-for-byte;
- one track (tid) per SERVICE within each process — the first dot-segment
  of the span name, same convention the Prometheus service label uses;
- every span is a complete event (``ph: "X"``, microsecond ``ts``/``dur``)
  carrying span/parent/trace ids and the span's recorded fields in
  ``args``;
- error spans are flagged: ``args.status == "error"`` plus a
  ``cname: "terrible"`` color hint (red in chrome://tracing; Perfetto
  ignores unknown cnames gracefully).

Served at ``GET /api/traces/<id>/export?fmt=chrome`` (services/api.py);
``scripts/trace_export_demo.sh`` is the one-liner. The exact output shape
is pinned by a golden file (tests/goldens/chrome_trace_golden.json) — a
format drift breaks the golden test, not an operator's tooling.

Determinism contract (what the golden test relies on): processes are
ordered first-seen (by span start; the local lane uses pid 1), and within
each process events are metadata first (process name, then thread names in
tid order), then all spans by (ts, span_id); tids are assigned to services
in first-seen span-start order within their process. When a role carries
no OS pid, a synthetic pid is assigned in first-seen order from 100001.
No clocks, no randomness — the export is a pure function of the recorded
spans.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from symbiont_tpu_torch.obs.trace_store import SpanRecord

_PID = 1
_LOCAL_PROCESS_NAME = "symbiont flight recorder"
_SYNTHETIC_PID_BASE = 100000


def service_of(span_name: str) -> str:
    return span_name.split(".", 1)[0]


def _lane_of(r: SpanRecord, synthetic: Dict[str, int],
             assigned: Dict[int, str]) -> Tuple[int, str]:
    """(pid, process_name) for one span. Local spans (no role field) keep
    the historical single-process lane; stitched remote spans get one lane
    per role, keyed on the origin's real pid when the telemetry carried it
    — UNLESS that pid collides with the local lane (a containerized worker
    runs as PID 1) or with another role's already-claimed pid, in which
    case the role falls back to its deterministic synthetic pid: lanes
    must never merge two processes into one flapping track."""
    role = (r.fields or {}).get("role")
    if not isinstance(role, str) or not role:
        return _PID, _LOCAL_PROCESS_NAME

    def synth() -> int:
        if role not in synthetic:
            synthetic[role] = _SYNTHETIC_PID_BASE + len(synthetic) + 1
        return synthetic[role]

    pid = (r.fields or {}).get("pid")
    if isinstance(pid, (int, float)) and not isinstance(pid, bool) \
            and int(pid) > 0 and int(pid) != _PID \
            and assigned.setdefault(int(pid), role) == role:
        return int(pid), role
    return synth(), role


def export_timeline(trace_id: str, spans: Sequence[SpanRecord],
                    events: Sequence[dict]) -> dict:
    """One Perfetto document carrying BOTH the flight recorder's span
    lanes AND the engine timeline's counter tracks (``ph: "C"``) — the
    decode plane's per-step occupancy / KV-rows / queue-depth / padding
    series interleaved with the spans that caused them, on one time axis.
    Served at ``GET /api/engine/timeline?fmt=chrome``; golden-pinned.

    Counter tracks (values per ``ts``; Perfetto renders stacked areas):

    - ``decode.rows``       — live vs free batch-slab rows (occupancy);
    - ``decode.kv_rows``    — live vs STRANDED KV rows (the HBM paged-KV
      will reclaim — ``lm.kv_stranded_rows`` over time);
    - ``engine.queue.<kind>`` — batcher queue depth samples;
    - ``embed.flush_tokens`` — real vs padding token slots per dispatched
      embed batch (the packing-opportunity series);
    - ``hbm.subsystem_bytes`` — per-subsystem device-memory claims from
      the hbm ledger (obs/hbm.py), sampled at decode chunk boundaries.

    Admit / finish / cancel land as instant events (``ph: "i"``) on the
    counters' process lane. Determinism: the span half is exactly
    ``export_spans`` (metadata first, spans by (ts, span_id)); counter and
    instant events append after it sorted by (ts, name). No clocks, no
    randomness — a pure function of the recorded data."""
    doc = export_spans(trace_id, list(spans))
    tev = doc["traceEvents"]
    if not any(e.get("ph") == "M" and e.get("pid") == _PID
               and e.get("name") == "process_name" for e in tev):
        # counters need a home lane even when no local span rendered one
        tev.insert(0, {"ph": "M", "name": "process_name", "pid": _PID,
                       "args": {"name": _LOCAL_PROCESS_NAME}})
    extra: List[dict] = []

    def counter(name: str, t: float, series: dict) -> None:
        extra.append({"ph": "C", "name": name, "pid": _PID,
                      "ts": round(t * 1e6, 1), "args": series})

    def instant(name: str, t: float, args: dict) -> None:
        extra.append({"ph": "i", "s": "p", "name": name, "pid": _PID,
                      "tid": 0, "ts": round(t * 1e6, 1), "args": args})

    for ev in events:
        kind, t = ev.get("kind"), ev.get("t", 0.0)
        if kind == "step":
            counter("decode.rows", t, {
                "live": ev["rows_live"],
                "free": ev["rows_capacity"] - ev["rows_live"]})
            counter("decode.kv_rows", t, {
                "live": ev["kv_rows_live"],
                "stranded": (ev["kv_rows_allocated"]
                             - ev["kv_rows_live"])})
        elif kind == "queue":
            counter(f"engine.queue.{ev['queue']}", t,
                    {"depth": ev["depth"]})
        elif kind == "flush":
            counter("embed.flush_tokens", t, {
                "real": ev["real_tokens"],
                "padding": ev["total_tokens"] - ev["real_tokens"]})
        elif kind == "mem":
            # per-subsystem HBM ledger sample (obs/hbm.py): every non-meta
            # key is a subsystem's byte claim — one stacked-area track
            series = {k: v for k, v in ev.items() if k not in ("kind", "t")}
            if series:
                counter("hbm.subsystem_bytes", t, series)
        elif kind in ("admit", "finish", "cancel"):
            args = {k: v for k, v in ev.items() if k not in ("kind", "t")}
            instant(f"decode.{kind}", t, args)
    extra.sort(key=lambda e: (e["ts"], e["name"]))
    tev.extend(extra)
    doc["otherData"]["counter_events"] = sum(
        1 for e in extra if e["ph"] == "C")
    doc["otherData"]["instant_events"] = sum(
        1 for e in extra if e["ph"] == "i")
    return doc


def export_spans(trace_id: str, spans: Sequence[SpanRecord]) -> dict:
    """Render one trace's SpanRecords as a Chrome Trace Format object."""
    ordered = sorted(spans, key=lambda r: (r.start_s, r.span_id))
    synthetic: Dict[str, int] = {}
    assigned: Dict[int, str] = {}  # real pid → the role that claimed it
    # processes in first-seen order; per-process service → tid tables
    proc_order: List[Tuple[int, str]] = []
    tids: Dict[Tuple[int, str], int] = {}
    lanes: List[Tuple[int, str]] = []
    for r in ordered:
        lane = _lane_of(r, synthetic, assigned)
        lanes.append(lane)
        if lane not in proc_order:
            proc_order.append(lane)
        key = (lane[0], service_of(r.name))
        if key not in tids:
            tids[key] = sum(1 for (p, _s) in tids if p == lane[0]) + 1

    events: List[dict] = []
    for pid, pname in proc_order:
        events.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": pname},
        })
        threads = sorted(((svc, tid) for (p, svc), tid in tids.items()
                          if p == pid), key=lambda kv: kv[1])
        for svc, tid in threads:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": svc}})
    for r, (pid, _pname) in zip(ordered, lanes):
        ev = {
            "ph": "X",
            "name": r.name,
            "cat": service_of(r.name),
            "pid": pid,
            "tid": tids[(pid, service_of(r.name))],
            "ts": round(r.start_s * 1e6, 1),       # µs, Chrome's unit
            "dur": round(r.duration_ms * 1e3, 1),  # µs
            "args": {
                "trace_id": r.trace_id,
                "span_id": r.span_id,
                "parent_id": r.parent_id,
                "status": r.status,
                **r.fields,
            },
        }
        if r.status != "ok":
            ev["cname"] = "terrible"  # chrome://tracing red; Perfetto: noop
        events.append(ev)
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": trace_id,
            "span_count": len(ordered),
            "error_count": sum(1 for r in ordered if r.status != "ok"),
            "generator": "symbiont_tpu_torch/obs/chrome_trace.py",
        },
        "traceEvents": events,
    }
