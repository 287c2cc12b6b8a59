"""Exporters: Prometheus text exposition for the metrics registry, and
JSONL streams for span traces + flight-recorder dumps.

Two formats, both file-first (this repo serves from a CLI/CI world, not
a long-lived daemon — a scrape endpoint would wrap `prometheus_text`
in a dozen lines):

  * **Prometheus text exposition** (`prometheus_text` /
    `write_prometheus`): every family in the registry as
    `# HELP` / `# TYPE` + samples; histograms expand to cumulative
    `_bucket{le=...}` series plus `_sum`/`_count`, so
    `histogram_quantile()` works server-side exactly as the in-process
    `Histogram.quantile` does.
  * **Trace JSONL** (`write_trace_jsonl` / `iter_trace_records`): one
    JSON object per line — `{"kind": "span", ...}` rows reconstruct
    every finished (and optionally still-open) span tree;
    `{"kind": "dump", ...}` rows carry flight-recorder snapshots.
    `validate_trace_jsonl` is the schema gate CI runs on the artifact:
    it re-parses every line, checks required keys, types, parent-pointer
    resolution and span time ordering, and returns a summary dict
    (raising `TraceSchemaError` on any violation).
"""

from __future__ import annotations

import json
import math

from repro_torch.obs import metrics as MX

TRACE_KINDS = ("span", "dump")
SPAN_REQUIRED = ("kind", "trace", "span_id", "parent_id", "name",
                 "t_start", "t_end", "attrs")
DUMP_REQUIRED = ("kind", "reason", "t", "events")


class TraceSchemaError(ValueError):
    """A trace JSONL line violated the schema (see
    `validate_trace_jsonl`)."""


# -- Prometheus text exposition --------------------------------------------

def _fmt(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not f.is_integer() else str(int(f))


def _labels(names, values, extra=()) -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{v}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry: MX.MetricsRegistry) -> str:
    """The whole registry in Prometheus text exposition format."""
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for lv, child in fam.items():
            if fam.kind == MX.HISTOGRAM:
                acc = 0
                for bound, c in zip([*fam.buckets, float("inf")],
                                    child.counts):
                    acc += c
                    le = _labels(fam.labelnames, lv,
                                 [("le", _fmt(bound))])
                    lines.append(f"{fam.name}_bucket{le} {acc}")
                base = _labels(fam.labelnames, lv)
                lines.append(f"{fam.name}_sum{base} {_fmt(child.sum)}")
                lines.append(f"{fam.name}_count{base} {child.count}")
            else:
                base = _labels(fam.labelnames, lv)
                lines.append(f"{fam.name}{base} {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, registry: MX.MetricsRegistry) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))


# -- trace JSONL ------------------------------------------------------------

def _span_rows(trace):
    for s in trace.span_list():
        yield {"kind": "span", "trace": trace.tid, "span_id": s.span_id,
               "parent_id": s.parent_id, "name": s.name,
               "t_start": s.t_start, "t_end": s.t_end,
               "attrs": {k: _jsonable(v) for k, v in s.attrs.items()}}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return v.item()             # numpy scalars
    except AttributeError:
        return repr(v)


def iter_trace_records(tracer, recorder=None, include_live: bool = True):
    """Every exportable record: spans of finished traces (then live
    ones, open spans with t_end=null), then flight-recorder dumps."""
    if tracer is not None:
        for tr in tracer.finished():
            yield from _span_rows(tr)
        if include_live:
            for tr in tracer.live():
                yield from _span_rows(tr)
    if recorder is not None:
        for d in list(recorder.dumps):
            yield {"kind": "dump", "reason": d["reason"], "t": d["t"],
                   "key": d["key"],
                   "events": [{k: _jsonable(v) for k, v in e.items()}
                              for e in d["events"]]}


def write_trace_jsonl(path: str, tracer, recorder=None,
                      include_live: bool = True) -> int:
    """Write the trace/dump stream as JSONL; returns lines written."""
    n = 0
    with open(path, "w") as f:
        for rec in iter_trace_records(tracer, recorder, include_live):
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    return n


def validate_trace_jsonl(path: str) -> dict:
    """Schema-check one trace JSONL file (the CI artifact gate).

    Raises `TraceSchemaError` naming the first offending line; returns
    {"lines", "spans", "dumps", "traces", "closed_traces"} on success.
    """
    spans_by_trace: dict = {}
    n_dumps = 0
    n_lines = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n_lines += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceSchemaError(
                    f"{path}:{lineno}: not valid JSON: {e}")
            if not isinstance(rec, dict) or \
                    rec.get("kind") not in TRACE_KINDS:
                raise TraceSchemaError(
                    f"{path}:{lineno}: 'kind' must be one of "
                    f"{TRACE_KINDS}, got {rec.get('kind')!r}")
            if rec["kind"] == "span":
                missing = [k for k in SPAN_REQUIRED if k not in rec]
                if missing:
                    raise TraceSchemaError(
                        f"{path}:{lineno}: span missing keys {missing}")
                if not isinstance(rec["attrs"], dict):
                    raise TraceSchemaError(
                        f"{path}:{lineno}: span attrs must be an object")
                t0, t1 = rec["t_start"], rec["t_end"]
                if not isinstance(t0, (int, float)):
                    raise TraceSchemaError(
                        f"{path}:{lineno}: t_start must be a number")
                if t1 is not None and (not isinstance(t1, (int, float))
                                       or t1 < t0):
                    raise TraceSchemaError(
                        f"{path}:{lineno}: t_end {t1!r} precedes "
                        f"t_start {t0!r}")
                spans_by_trace.setdefault(rec["trace"], []).append(rec)
            else:
                missing = [k for k in DUMP_REQUIRED if k not in rec]
                if missing:
                    raise TraceSchemaError(
                        f"{path}:{lineno}: dump missing keys {missing}")
                if not isinstance(rec["events"], list):
                    raise TraceSchemaError(
                        f"{path}:{lineno}: dump events must be a list")
                n_dumps += 1
    closed = 0
    for tid, spans in spans_by_trace.items():
        ids = {s["span_id"] for s in spans}
        roots = [s for s in spans if s["parent_id"] is None]
        if len(roots) != 1:
            raise TraceSchemaError(
                f"{path}: trace {tid!r} has {len(roots)} root spans "
                f"(exactly 1 required)")
        for s in spans:
            if s["parent_id"] is not None and s["parent_id"] not in ids:
                raise TraceSchemaError(
                    f"{path}: trace {tid!r} span {s['span_id']} has "
                    f"dangling parent {s['parent_id']}")
        if roots[0]["t_end"] is not None:
            closed += 1
    return {"lines": n_lines,
            "spans": sum(len(v) for v in spans_by_trace.values()),
            "dumps": n_dumps, "traces": len(spans_by_trace),
            "closed_traces": closed}
