"""Exporters: Chrome-trace/Perfetto JSON and structured JSONL.

Chrome trace format (the JSON Array/Object flavor both
``chrome://tracing`` and https://ui.perfetto.dev open directly):

* one **process per shard** (``pid`` = shard index, named via ``M``
  metadata events), plus a ``pid = shards`` control-plane process for
  elastic steal/resize/reject instants;
* one **thread per job** (``tid`` = job id) holding that job's
  complete-duration spans (``ph: "X"``) — queued / init / running, with
  SLO class, tenant, GPUs and the violation verdict in ``args``;
* **counter tracks** (``ph: "C"``) per shard for queue depth, pressure,
  and running GPUs, sampled from the metrics windows;
* timestamps are microseconds of simulated time (Chrome's native unit).

The JSONL export is line-per-record structured data for offline
analysis: ``{"type": "timeline" | "metric" | "audit", ...}`` — round-
trippable back into :class:`~repro_torch.obs.spans.JobTimeline` /
:class:`~repro_torch.obs.audit.AuditEntry` objects via :func:`read_jsonl`.

:func:`validate_chrome_trace` is the schema check CI runs against
exported artifacts: well-formed JSON, required keys per event, and
monotone non-decreasing ``ts`` per ``(pid, tid)`` lane.

Run as a module to validate a file::

    PYTHONPATH=src python -m repro_torch.obs.export --validate run.trace.json
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.audit import AuditEntry, AuditLog
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import JobTimeline, TimelineRecorder

_US = 1e6                     # sim seconds -> Chrome-trace microseconds

# Stable per-phase colors (Chrome trace color names).
_PHASE_COLOR = {"queued": "thread_state_runnable",
                "init": "thread_state_iowait",
                "running": "thread_state_running",
                "rejected": "terrible"}


def _timelines_list(timelines) -> List[JobTimeline]:
    if isinstance(timelines, TimelineRecorder):
        return [tl for _, tl in sorted(timelines.timelines().items())]
    if isinstance(timelines, dict):
        return [tl for _, tl in sorted(timelines.items())]
    return list(timelines)


def to_chrome_trace(
    timelines,
    metrics: Optional[MetricsRegistry] = None,
    audit: Optional[AuditLog] = None,
    *,
    shards: Optional[int] = None,
) -> Dict:
    """Build the Chrome-trace document (JSON Object Format: a dict with
    ``traceEvents``) from recorded telemetry. Any of the three sources
    may be omitted."""
    tls = _timelines_list(timelines)
    events: List[Dict] = []
    seen_pids = set()

    # Horizon for rendering still-open spans (jobs that never reached
    # JOB_DONE): latest timestamp anywhere in the recording. They are
    # drawn as truncated spans up to the horizon instead of dropped.
    horizon = 0.0
    for tl in tls:
        for s in tl.spans:
            horizon = max(horizon, s.start,
                          s.end if s.end is not None else s.start)
        for h in tl.hops:
            horizon = max(horizon, h.time)

    for tl in tls:
        for s in tl.spans:
            end = s.end if s.end is not None else max(horizon, s.start)
            truncated = s.truncated or s.end is None
            seen_pids.add(s.shard)
            events.append({
                "name": s.phase,
                "cat": "job",
                "ph": "X",
                "ts": s.start * _US,
                "dur": (end - s.start) * _US,
                "pid": s.shard,
                "tid": tl.job_id,
                "cname": ("terrible" if truncated
                          else _PHASE_COLOR.get(s.phase)),
                "args": {
                    "task_id": tl.task_id, "llm": tl.llm,
                    "tenant": tl.tenant, "slo_class": tl.slo_class,
                    "gpus": tl.gpus, "used_bank": tl.used_bank,
                    "deadline_s": tl.deadline, "violated": tl.violated,
                    "truncated": truncated, "retries": tl.retries,
                    "shed_reason": tl.shed_reason,
                },
            })
        for h in tl.hops:
            seen_pids.add(h.dst)
            events.append({
                "name": f"steal job {tl.job_id}",
                "cat": "elastic", "ph": "i", "s": "p",
                "ts": h.time * _US, "pid": h.dst, "tid": tl.job_id,
                "args": {"src": h.src, "dst": h.dst},
            })

    if metrics is not None:
        events.extend(_counter_events(metrics, seen_pids))

    n_shards = (shards if shards is not None
                else (max(seen_pids) + 1 if seen_pids else 0))
    ctl_pid = max(n_shards, max(seen_pids) + 1 if seen_pids else 0)
    if audit is not None:
        for e in audit.entries:
            ev = {
                "name": e.action,
                "cat": "elastic", "ph": "i", "s": "g",
                "ts": e.time * _US, "pid": ctl_pid, "tid": 0,
                "args": {"shard": e.shard, "job_id": e.job_id,
                         "tenant": e.tenant, "detail": e.detail,
                         "inputs": e.inputs},
            }
            # alert windows stand out: red firing, green resolution
            if e.action == "alert_fired":
                ev["cname"] = "bad"
            elif e.action == "alert_resolved":
                ev["cname"] = "good"
            events.append(ev)

    meta: List[Dict] = []
    for pid in sorted(seen_pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "args": {"name": f"shard {pid}"}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
    if audit is not None and audit.entries:
        meta.append({"name": "process_name", "ph": "M", "pid": ctl_pid,
                     "tid": 0, "args": {"name": "elastic control plane"}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": ctl_pid,
                     "tid": 0, "args": {"sort_index": ctl_pid}})
    for tl in tls:
        for pid in {s.shard for s in tl.spans}:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tl.job_id,
                         "args": {"name": f"job {tl.job_id} "
                                          f"({tl.tenant}/{tl.llm})"}})

    # Sort payload events by ts (metadata first): Perfetto tolerates any
    # order, but monotone lanes make the file diffable and validatable.
    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "repro_torch.obs", "clock": "simulated-time"},
    }


def _counter_events(metrics: MetricsRegistry, seen_pids) -> List[Dict]:
    """Per-shard counter tracks sampled at each metrics window end."""
    out: List[Dict] = []
    for w in metrics.windows:
        for sid, state in w.series.items():
            if "{" not in sid or "shard=" not in sid:
                continue
            name = sid[: sid.index("{")]
            if name not in ("queue_depth", "pressure", "running_gpus"):
                continue
            labels = dict(kv.split("=", 1) for kv in
                          sid[sid.index("{") + 1:-1].split(","))
            try:
                pid = int(labels["shard"])
            except (KeyError, ValueError):
                continue
            seen_pids.add(pid)
            out.append({
                "name": name, "cat": "metrics", "ph": "C",
                "ts": w.end * _US, "pid": pid, "tid": 0,
                "args": {name: state.get("value", 0.0)},
            })
    return out


def write_chrome_trace(path: str, timelines,
                       metrics: Optional[MetricsRegistry] = None,
                       audit: Optional[AuditLog] = None,
                       *, shards: Optional[int] = None) -> str:
    doc = to_chrome_trace(timelines, metrics, audit, shards=shards)
    with open(path, "w") as f:
        json.dump(doc, f, default=float)
    return path


# -- JSONL -------------------------------------------------------------------


def jsonl_records(timelines=None,
                  metrics: Optional[MetricsRegistry] = None,
                  audit: Optional[AuditLog] = None) -> Iterable[Dict]:
    if timelines is not None:
        for tl in _timelines_list(timelines):
            yield tl.to_dict()
    if metrics is not None:
        yield from metrics.to_dicts()
    if audit is not None:
        yield from audit.to_dicts()


def write_jsonl(path: str, timelines=None,
                metrics: Optional[MetricsRegistry] = None,
                audit: Optional[AuditLog] = None) -> str:
    with open(path, "w") as f:
        for rec in jsonl_records(timelines, metrics, audit):
            f.write(json.dumps(rec, default=float) + "\n")
    return path


def read_jsonl(path: str) -> Dict[str, List]:
    """Load a JSONL export back into typed objects:
    ``{"timelines": [JobTimeline], "metrics": [dict], "audit":
    [AuditEntry]}``."""
    out: Dict[str, List] = {"timelines": [], "metrics": [], "audit": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "timeline":
                out["timelines"].append(JobTimeline.from_dict(rec))
            elif kind == "metric":
                out["metrics"].append(rec)
            elif kind == "audit":
                out["audit"].append(AuditEntry.from_dict(rec))
    return out


# -- validation --------------------------------------------------------------


def validate_chrome_trace(doc) -> List[str]:
    """Schema-check a Chrome-trace document. Returns a list of problems
    (empty = valid): top-level shape, per-event required keys, and
    non-decreasing ``ts`` within each (pid, tid) lane for duration
    events."""
    problems: List[str] = []
    if isinstance(doc, list):
        events: Sequence[Dict] = doc      # JSON Array Format
    elif isinstance(doc, dict):
        events = doc.get("traceEvents", None)
        if events is None:
            return ["missing top-level 'traceEvents'"]
    else:
        return [f"trace must be a JSON object or array, got {type(doc)}"]

    last_ts: Dict[Tuple[int, int], float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing 'ph'")
            continue
        if ph == "M":
            continue                      # metadata: no ts required
        for key in ("ts", "pid", "tid", "name"):
            if key not in ev:
                problems.append(f"event {i} ({ph}): missing {key!r}")
        if "ts" not in ev:
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event needs dur >= 0, "
                                f"got {dur!r}")
            lane = (ev.get("pid"), ev.get("tid"))
            if ts + 1e-6 < last_ts.get(lane, float("-inf")):
                problems.append(
                    f"event {i}: ts goes backwards in lane pid={lane[0]} "
                    f"tid={lane[1]} ({ts} < {last_ts[lane]})")
            last_ts[lane] = max(last_ts.get(lane, float("-inf")), ts)
    return problems


def validate_chrome_trace_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load {path}: {e}"]
    return validate_chrome_trace(doc)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a Chrome-trace export / run SLO forensics "
                    "on a JSONL export")
    ap.add_argument("--validate", metavar="TRACE_JSON",
                    help="schema-check a Chrome-trace JSON file")
    ap.add_argument("--forensics", metavar="TRACE_JSONL",
                    help="per-violation blame attribution from a JSONL "
                         "export (timelines + audit)")
    ap.add_argument("--forensics-out", metavar="OUT_JSON",
                    help="also write the full forensics report (per-job "
                         "breakdowns included) as JSON")
    args = ap.parse_args(argv)
    if not args.validate and not args.forensics:
        ap.error("nothing to do: pass --validate and/or --forensics")
    rc = 0
    if args.validate:
        problems = validate_chrome_trace_file(args.validate)
        if problems:
            print(f"{args.validate}: INVALID ({len(problems)} problems)")
            for p in problems[:20]:
                print(f"  - {p}")
            rc = 1
        else:
            print(f"{args.validate}: OK (well-formed Chrome trace)")
    if args.forensics:
        from repro_torch.obs.forensics import analyze

        try:
            loaded = read_jsonl(args.forensics)
        except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
            print(f"{args.forensics}: cannot load JSONL export: {e}")
            return 1
        report = analyze(loaded["timelines"], loaded["audit"])
        print(report.render())
        if args.forensics_out:
            with open(args.forensics_out, "w") as f:
                json.dump(report.to_dict(), f, indent=2, default=float)
            print(f"wrote {args.forensics_out}")
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
