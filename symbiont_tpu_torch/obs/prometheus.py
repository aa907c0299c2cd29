"""Prometheus text exposition (format 0.0.4) over the telemetry registry.

Copy of the JAX package's `symbiont_tpu/obs/prometheus.py`.

`GET /api/metrics` is a JSON dump — fine for humans with curl, invisible to
every standard scraper. This module renders the same registry as Prometheus
text exposition for `GET /metrics`:

- counters → `symbiont_<name>_total` (TYPE counter)
- gauges (value + callback) → `symbiont_<name>` (TYPE gauge)
- histograms → TYPE summary: `{quantile="0.5|0.95|0.99"}` series plus
  `_sum`/`_count`, and exact-extreme companions `_min`/`_max` gauges (the
  reservoir decimates; min/max are tracked exactly — see _Histogram).
- span-duration series ADDITIONALLY render as a real Prometheus histogram
  family `symbiont_span_duration_ms_hist` (`_bucket{le=...}` cumulative
  series from the exact per-bucket counts, plus `_sum`/`_count`) — summary
  quantiles cannot be aggregated across processes, `le` buckets can, so
  fleet p99s come from the `_hist` family and the summary stays for
  single-process compatibility. Bucket bounds: `ObsConfig
  .histogram_buckets_ms` (default telemetry.DEFAULT_BUCKET_BOUNDS_MS).

Exemplars: when the scraper negotiates OpenMetrics (`Accept:
application/openmetrics-text`, or `render(..., openmetrics=True)`),
`_hist_bucket` samples carry the latest trace-id exemplar seen in that
bucket (`... # {trace_id="..."} <value> <ts>`) — a bad bucket links to a
concrete flight-recorder trace (`GET /api/traces/<id>`). The default
0.0.4 rendering omits them (that format has no exemplar syntax).

Label conventions (docs/OBSERVABILITY.md): explicitly-labeled series pass
their labels through; legacy dot-concatenated names are split so the first
segment becomes a `service` label instead of being fused into the metric
name — `perception.scrape_failed` → `symbiont_scrape_failed_total
{service="perception"}`. Span series get a `span` label carrying the full
span name plus the service label: `span.api.search.ms` →
`symbiont_span_duration_ms{service="api",span="api.search"}`. The
`process.*` host gauges (obs/device.py) render WITHOUT the `symbiont_`
prefix — `process_resident_memory_bytes` etc. are a cross-ecosystem
convention every scrape-based alert rule expects verbatim.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

_NAME_PREFIX = "symbiont_"
_INVALID_NAME_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_INVALID_LABEL_CHARS = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))

# services whose dot-prefixed legacy counters should fold into a
# service="..." label (anything else keeps its full name — guessing labels
# out of arbitrary dotted names would mint garbage label sets)
_KNOWN_SERVICES = frozenset({
    "api", "perception", "preprocessing", "vector_memory",
    "knowledge_graph", "text_generator", "engine", "lm", "batcher", "bus",
    "slo",
})


def _metric_name(raw: str, suffix: str = "") -> str:
    name = _INVALID_NAME_CHARS.sub("_", raw).strip("_") or "unnamed"
    if name[0].isdigit():
        name = "_" + name
    if name.startswith("process_"):
        # the standard process_* family (obs/device.py) keeps its
        # ecosystem-wide names unprefixed
        return f"{name}{suffix}"
    return f"{_NAME_PREFIX}{name}{suffix}"


def _label_name(raw: str) -> str:
    name = _INVALID_LABEL_CHARS.sub("_", raw) or "label"
    if name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(v: str) -> str:
    """Exposition-format label escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_label_name(k)}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if f != int(f) else str(int(f))


def _split_legacy(raw: str, labels: Dict[str, str]
                  ) -> Tuple[str, Dict[str, str]]:
    """Fold a known dot-concatenated prefix into a service label. Series
    that already carry labels pass through untouched (new-style callers
    label explicitly)."""
    if "." in raw:
        head, rest = raw.split(".", 1)
        if head in _KNOWN_SERVICES and "service" not in labels:
            return rest, {**labels, "service": head}
    return raw, labels


def _span_series(raw: str) -> Optional[Tuple[str, str]]:
    """`span.<name>.<ms|errors>` → (kind, span-name)."""
    if raw.startswith("span."):
        body = raw[len("span."):]
        for kind in ("ms", "errors"):
            if body.endswith("." + kind):
                return kind, body[: -(len(kind) + 1)]
    return None


class _Family:
    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []


def _family(families: Dict[str, _Family], name: str, kind: str,
            help_text: str) -> _Family:
    fam = families.get(name)
    if fam is None:
        fam = families[name] = _Family(name, kind, help_text)
    return fam


def _span_labels(span_name: str, labels: Dict[str, str]) -> Dict[str, str]:
    out = {**labels, "span": span_name}
    out.setdefault("service", span_name.split(".", 1)[0])
    return out


def _fmt_le(bound) -> str:
    """Prometheus `le` label values: decimal floats, `+Inf` terminal."""
    return bound if bound == "+Inf" else repr(float(bound))


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar: ` # {label="v"} value timestamp` (None → "")."""
    if ex is None:
        return ""
    value, labels, ts = ex
    inner = ",".join(f'{_label_name(k)}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return f" # {{{inner}}} {_fmt_value(value)} {ts:.3f}"


CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")


def render(registry: Optional[Metrics] = None,
           openmetrics: bool = False,
           extra_labels: Optional[Dict[str, str]] = None) -> str:
    """Render the registry as Prometheus text exposition. With
    ``openmetrics=True``, histogram bucket samples carry exemplars and the
    output terminates with ``# EOF`` (serve it under
    CONTENT_TYPE_OPENMETRICS; the family naming stays shared between the
    two renderings). ``extra_labels`` (the fleet plane's ``role`` label)
    merge under every sample's own labels — an explicitly-carried label of
    the same name wins, so ``procsup.up{role="broker"}`` keeps naming its
    TARGET role."""
    families: Dict[str, _Family] = {}
    _render_registry_into(families, registry or _global_metrics,
                          openmetrics, extra_labels)
    return _format_families(families, openmetrics)


def _render_registry_into(families: Dict[str, "_Family"],
                          registry: Metrics, openmetrics: bool,
                          extra_labels: Optional[Dict[str, str]] = None
                          ) -> None:
    ex = registry.export()
    if extra_labels:
        for kind in ("counters", "gauges", "histograms"):
            ex[kind] = [(n, {**extra_labels, **lb}, v)
                        for n, lb, v in ex[kind]]

    # OpenMetrics counter naming: the FAMILY (TYPE/HELP) name must not end
    # in the reserved `_total` suffix — samples carry it, the family does
    # not (the reference parser rejects "clashing names" otherwise, and a
    # failed parse loses the WHOLE scrape). 0.0.4 keeps the historical
    # family-name-includes-_total rendering byte-for-byte.
    def counter_family(base_name: str, help_text: str) -> Tuple[_Family, str]:
        sample_name = f"{base_name}_total"
        fam = _family(families,
                      base_name if openmetrics else sample_name,
                      "counter", help_text)
        return fam, sample_name

    for raw, labels, value in ex["counters"]:
        sp = _span_series(raw)
        if sp is not None and sp[0] == "errors":
            fam, sample = counter_family(_metric_name("span_errors"),
                                         "Errored span exits by span name.")
            fam.samples.append(
                f"{sample}{_fmt_labels(_span_labels(sp[1], labels))} "
                f"{_fmt_value(value)}")
            continue
        name, labels = _split_legacy(raw, labels)
        fam, sample = counter_family(_metric_name(name), f"Counter {raw}.")
        fam.samples.append(f"{sample}{_fmt_labels(labels)} "
                           f"{_fmt_value(value)}")

    for raw, labels, value in ex["gauges"]:
        name, labels = _split_legacy(raw, labels)
        fam = _family(families, _metric_name(name), "gauge",
                      f"Gauge {raw}.")
        fam.samples.append(f"{fam.name}{_fmt_labels(labels)} "
                           f"{_fmt_value(value)}")

    for raw, labels, summary in ex["histograms"]:
        sp = _span_series(raw)
        if sp is not None and sp[0] == "ms":
            base, labels = "span_duration_ms", _span_labels(sp[1], labels)
            help_text = "Span duration in milliseconds by span name."
            # the REAL histogram family rides alongside the summary:
            # cumulative `le` buckets aggregate honestly across processes
            # (quantile labels never did), exemplars link buckets to traces
            hfam = _family(families, _metric_name(base, "_hist"),
                           "histogram",
                           "Span duration in milliseconds by span name "
                           "(cumulative le buckets; fleet-aggregatable).")
            exemplars = summary.get("exemplars") or []
            for i, (bound, cum) in enumerate(summary.get("buckets", [])):
                blabels = {**labels, "le": _fmt_le(bound)}
                suffix = (_exemplar_suffix(exemplars[i])
                          if openmetrics and i < len(exemplars) else "")
                hfam.samples.append(
                    f"{hfam.name}_bucket{_fmt_labels(blabels)} "
                    f"{_fmt_value(cum)}{suffix}")
            hfam.samples.append(
                f"{hfam.name}_sum{_fmt_labels(labels)} "
                f"{_fmt_value(summary['sum'])}")
            hfam.samples.append(
                f"{hfam.name}_count{_fmt_labels(labels)} "
                f"{_fmt_value(summary['count'])}")
        else:
            base, labels = _split_legacy(raw, labels)
            help_text = f"Distribution of {raw}."
        fam = _family(families, _metric_name(base), "summary", help_text)
        for q, stat in _QUANTILES:
            qlabels = {**labels, "quantile": q}
            fam.samples.append(f"{fam.name}{_fmt_labels(qlabels)} "
                               f"{_fmt_value(summary[stat])}")
        fam.samples.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                           f"{_fmt_value(summary['sum'])}")
        fam.samples.append(f"{fam.name}_count{_fmt_labels(labels)} "
                           f"{_fmt_value(summary['count'])}")
        for stat in ("min", "max"):
            # exact running extremes ride alongside the summary (the
            # reservoir's quantiles are approximate; these are not)
            gfam = _family(families, _metric_name(base, f"_{stat}"),
                           "gauge", f"Exact running {stat} of {raw}.")
            gfam.samples.append(f"{gfam.name}{_fmt_labels(labels)} "
                                f"{_fmt_value(summary[stat])}")


def _format_families(families: Dict[str, "_Family"],
                     openmetrics: bool) -> str:
    lines: List[str] = []
    for fam_name in sorted(families):
        fam = families[fam_name]
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        lines.extend(fam.samples)
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------- fleet federation render

# flat-snapshot keys look like `counter.bus.consumed{service="api"}` /
# `gauge.mesh.devices{axis="data"}` / `hist.span.api.search.ms.p99` —
# the rendered-key format telemetry.Metrics.flat_snapshot emits
_FLAT_KEY = re.compile(
    r"^(counter|gauge|hist)\.([^{]+?)(\{.*\})?(?:\.(count|p50|p99|min|max))?$")
_FLAT_LABEL = re.compile(r'([a-zA-Z0-9_]+)="((?:[^"\\]|\\.)*)"')
# hist flat keys carry the stat OUTSIDE the label braces:
# hist.<name>{labels}.p99 — and without labels: hist.<name>.p99
_HIST_STATS = ("count", "p50", "p99", "min", "max")
_HIST_QUANTILE = {"p50": "0.5", "p99": "0.99"}


def parse_flat_key(key: str):
    """One flat-snapshot key → (kind, raw_name, labels, stat|None); None
    for a key this renderer cannot place (malformed keys are skipped, not
    crashed on — a remote role's snapshot must never fail the scrape)."""
    m = _FLAT_KEY.match(key)
    if not m:
        return None
    kind, name, lbl, stat = m.group(1), m.group(2), m.group(3), m.group(4)
    if kind == "hist" and stat is None:
        # unlabeled hist key: the stat rode into the name capture
        name, dot, tail = name.rpartition(".")
        if dot and tail in _HIST_STATS:
            stat = tail
        else:
            return None
    if kind != "hist" and stat is not None:
        # a counter/gauge whose NAME ends in `.p99` etc: keep it whole
        name = f"{name}.{stat}"
        stat = None
    labels = dict(_FLAT_LABEL.findall(lbl)) if lbl else {}
    return kind, name.strip("."), labels, stat


def _locally_synthesized(kind: str, raw: str) -> bool:
    """Families the AGGREGATOR itself produces per-role in the local
    registry — remote span durations observed as `span.<name>.ms{role=}`
    histograms, and the per-role SLO judgments over them (`slo.p99_ms` /
    `slo.breaches`). The remote snapshot carries its own copy of each;
    merging both would emit DUPLICATE series under one label set, and a
    real Prometheus scraper rejects the whole exposition on the first
    duplicate sample — so the local synthesis (richer: real `le` buckets,
    exemplars, watchdog-fed) is the one source and the snapshot copy is
    skipped."""
    if kind == "hist":
        sp = _span_series(raw)
        if sp is not None and sp[0] == "ms":
            return True
    return raw in ("slo.p99_ms", "slo.breaches")


def _merge_flat_role_into(families: Dict[str, "_Family"], role: str,
                          flat: Dict[str, float],
                          openmetrics: bool) -> None:
    """Merge one remote role's flat metric snapshot (obs/fleet.py payload)
    into the family table, under a `role` label. Counters and gauges keep
    their exact local family names (fleet p99s come from the histogram
    `_bucket` families only when scraped per process; federated summary
    STATS render into the same summary/`_min`/`_max` families the local
    process uses — honest per-role stats, never cross-role math). Span
    durations and SLO series are deliberately NOT merged from snapshots —
    the aggregator synthesizes them per role locally (see
    _locally_synthesized; merging both halves would duplicate series)."""
    for key in sorted(flat):
        parsed = parse_flat_key(key)
        if parsed is None:
            continue
        kind, raw, labels, stat = parsed
        if _locally_synthesized(kind, raw):
            continue
        value = flat[key]
        labels = {"role": role, **labels}
        if kind == "counter":
            sp = _span_series(raw)
            if sp is not None and sp[0] == "errors":
                base, labels = "span_errors", _span_labels(sp[1], labels)
            else:
                base, labels = _split_legacy(raw, labels)
            sample_name = _metric_name(base) + "_total"
            fam = _family(families,
                          _metric_name(base) if openmetrics else sample_name,
                          "counter", f"Counter {raw}.")
            fam.samples.append(f"{sample_name}{_fmt_labels(labels)} "
                               f"{_fmt_value(value)}")
        elif kind == "gauge":
            base, labels = _split_legacy(raw, labels)
            fam = _family(families, _metric_name(base), "gauge",
                          f"Gauge {raw}.")
            fam.samples.append(f"{fam.name}{_fmt_labels(labels)} "
                               f"{_fmt_value(value)}")
        else:  # hist stat
            sp = _span_series(raw)
            if sp is not None and sp[0] == "ms":
                base, labels = "span_duration_ms", _span_labels(sp[1], labels)
                help_text = "Span duration in milliseconds by span name."
            else:
                base, labels = _split_legacy(raw, labels)
                help_text = f"Distribution of {raw}."
            if stat in _HIST_QUANTILE:
                fam = _family(families, _metric_name(base), "summary",
                              help_text)
                qlabels = {**labels, "quantile": _HIST_QUANTILE[stat]}
                fam.samples.append(f"{fam.name}{_fmt_labels(qlabels)} "
                                   f"{_fmt_value(value)}")
            elif stat == "count":
                fam = _family(families, _metric_name(base), "summary",
                              help_text)
                fam.samples.append(f"{fam.name}_count{_fmt_labels(labels)} "
                                   f"{_fmt_value(value)}")
            else:  # min / max → the exact-extreme gauge companions
                gfam = _family(families, _metric_name(base, f"_{stat}"),
                               "gauge", f"Exact running {stat} of {raw}.")
                gfam.samples.append(f"{gfam.name}{_fmt_labels(labels)} "
                                    f"{_fmt_value(value)}")


def render_fleet(local_role: str,
                 role_snapshots: Dict[str, Dict[str, float]],
                 registry: Optional[Metrics] = None,
                 openmetrics: bool = False) -> str:
    """The federated exposition (obs/fleet.py): the LOCAL registry rendered
    with `role=<local_role>` merged under every sample, plus every remote
    role's flat snapshot in the SAME family table — one scrape shows the
    whole deployment, each series labeled with the role that produced it."""
    families: Dict[str, _Family] = {}
    _render_registry_into(families, registry or _global_metrics, openmetrics,
                          extra_labels={"role": local_role})
    for role in sorted(role_snapshots):
        if role == local_role:
            continue  # the local registry is already the fresher view
        _merge_flat_role_into(families, role, role_snapshots[role],
                              openmetrics)
    return _format_families(families, openmetrics)
