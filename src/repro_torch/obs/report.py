"""SLO-attainment / queue-depth time-series report.

Renders a per-sim-time-bucket table from recorded telemetry — the
"when did we start violating, and what was the queue doing" view the
end-of-run summary cannot give::

    == SLO attainment over time (bucket=60s) ==
    t[s]        sub  done  viol  attain%  wait_s    p50    p95    p99  qdepth  steals  resz
    0-60         41    12     0    100.0     1.2    1.0    4.1    8.2     3.1       0     0
    ...

With metric rows, p50/p95/p99 are per-bucket queue-wait quantiles from
the exported ``queue_wait_s`` histogram windows (log-bucket upper
bounds); chaos runs additionally get a ``shed`` column counting
truncated lifecycles (JOB_SHED / cancel_running) at their shed
instant, kept out of the completed/attainment math.

The report is computed purely from exported data — a list of
:class:`~repro_torch.obs.spans.JobTimeline` (or a recorder / dict of them)
plus optional metric rows as produced by
``MetricsRegistry.to_dicts()`` — so a JSONL export reloaded with
:func:`repro_torch.obs.export.read_jsonl` renders the *identical* report
(that round-trip is pinned in ``tests/test_obs.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.spans import QUEUED, JobTimeline


def _timelines_list(timelines) -> List[JobTimeline]:
    from repro_torch.obs.spans import TimelineRecorder

    if isinstance(timelines, TimelineRecorder):
        return [tl for _, tl in sorted(timelines.timelines().items())]
    if isinstance(timelines, dict):
        return [tl for _, tl in sorted(timelines.items())]
    return sorted(timelines, key=lambda tl: tl.job_id)


def _series_name(series: str) -> str:
    return series.split("{", 1)[0]


def _counter_bucket_deltas(rows: List[Dict], name: str, bucket: float,
                           n_buckets: int) -> List[float]:
    """Per-bucket increments of a cumulative counter, summed across all
    label sets, attributed by window midpoint."""
    out = [0.0] * n_buckets
    per_series: Dict[str, List[Dict]] = {}
    for r in rows:
        if _series_name(r["series"]) == name:
            per_series.setdefault(r["series"], []).append(r)
    for series_rows in per_series.values():
        series_rows.sort(key=lambda r: r["window_end"])
        prev = 0.0
        for r in series_rows:
            cur = float(r.get("value", prev))
            mid = (float(r["window_start"]) + float(r["window_end"])) / 2.0
            b = min(int(mid // bucket), n_buckets - 1)
            out[b] += cur - prev
            prev = cur
    return out


def _histogram_bucket_quantiles(rows: List[Dict], name: str, bucket: float,
                                n_buckets: int,
                                qs=(0.5, 0.95, 0.99)) -> List[Dict]:
    """Per-report-bucket quantiles of a histogram series, merged across
    label sets. Exported histogram windows are cumulative, so each
    window's bucket-count deltas against the previous window are
    attributed by window midpoint (like counter deltas); the quantile
    value is the log-bucket upper bound (``base * 2**index``) — an
    upper-bound estimate with a factor-of-2 relative error, same as
    ``Histogram.quantile``. Returns one ``{q: value | None}`` dict per
    report bucket (None where nothing was observed)."""
    per_series: Dict[str, List[Dict]] = {}
    for r in rows:
        if _series_name(r["series"]) == name and "buckets" in r:
            per_series.setdefault(r["series"], []).append(r)
    # (histogram base, log-bucket index) -> observation count, per
    # report bucket; keyed with base so mixed-base series still merge
    acc: List[Dict] = [{} for _ in range(n_buckets)]
    for series_rows in per_series.values():
        series_rows.sort(key=lambda r: r["window_end"])
        prev: Dict[int, int] = {}
        for r in series_rows:
            cur = {int(k): int(v)
                   for k, v in (r.get("buckets") or {}).items()}
            base = float(r.get("base", 0.001))
            mid = (float(r["window_start"]) + float(r["window_end"])) / 2.0
            b = min(int(mid // bucket), n_buckets - 1)
            for idx, c in cur.items():
                d = c - prev.get(idx, 0)
                if d > 0:
                    acc[b][(base, idx)] = acc[b].get((base, idx), 0) + d
            prev = cur
    out: List[Dict] = []
    for counts in acc:
        total = sum(counts.values())
        if not total:
            out.append({q: None for q in qs})
            continue
        items = sorted((base * (2.0 ** idx), c)
                       for (base, idx), c in counts.items())
        row: Dict = {}
        for q in qs:
            rank = q * total
            seen = 0
            val = items[-1][0]
            for ub, c in items:
                seen += c
                if seen >= rank:
                    val = ub
                    break
            row[q] = val
        out.append(row)
    return out


def _gauge_bucket_stats(rows: List[Dict], name: str, bucket: float,
                        n_buckets: int) -> List[Optional[float]]:
    """Mean of a gauge summed across shards, per bucket (None where no
    window falls in the bucket)."""
    # window_end -> {series: value}; sum across series per window, then
    # average the per-window sums that land in each bucket.
    per_window: Dict[float, float] = {}
    for r in rows:
        if _series_name(r["series"]) != name:
            continue
        key = float(r["window_end"])
        per_window[key] = per_window.get(key, 0.0) + float(r.get("value", 0.0))
    sums = [0.0] * n_buckets
    counts = [0] * n_buckets
    for end, v in per_window.items():
        b = min(int(max(end - 1e-9, 0.0) // bucket), n_buckets - 1)
        sums[b] += v
        counts[b] += 1
    return [sums[i] / counts[i] if counts[i] else None
            for i in range(n_buckets)]


def report_rows(timelines, metric_rows: Optional[Iterable[Dict]] = None,
                *, bucket: float = 60.0) -> List[Dict]:
    """The report as data: one dict per time bucket."""
    if bucket <= 0:
        raise ValueError(f"bucket must be > 0 seconds, got {bucket}")
    tls = _timelines_list(timelines)
    rows = list(metric_rows) if metric_rows is not None else []
    horizon = 0.0
    for tl in tls:
        horizon = max(horizon, tl.submit_time)
        fin = tl.finish
        if fin is not None:
            horizon = max(horizon, fin)
    for r in rows:
        horizon = max(horizon, float(r.get("window_end", 0.0)))
    n = max(1, math.ceil((horizon + 1e-9) / bucket))

    out = [{"t0": i * bucket, "t1": (i + 1) * bucket, "submitted": 0,
            "completed": 0, "violated": 0, "rejected": 0, "shed": 0,
            "wait_s_sum": 0.0, "queue_depth": None,
            "wait_p50": None, "wait_p95": None, "wait_p99": None,
            "steals": 0.0, "resizes": 0.0}
           for i in range(n)]

    def bucket_of(t: float) -> int:
        return min(int(t // bucket), n - 1)

    for tl in tls:
        if tl.reject_reason is not None:
            out[bucket_of(tl.submit_time)]["rejected"] += 1
            continue
        out[bucket_of(tl.submit_time)]["submitted"] += 1
        if tl.shed_reason is not None:
            # truncated lifecycle (JOB_SHED / cancel_running): its own
            # terminal column, bucketed at the shed instant, so chaos
            # reports reconcile with the bench's chaos_verdict
            end = tl.submit_time
            for s in tl.spans:
                if s.end is not None:
                    end = max(end, s.end)
            out[bucket_of(end)]["shed"] += 1
            continue
        fin = tl.finish
        if fin is None:
            continue
        b = out[bucket_of(fin)]
        b["completed"] += 1
        if tl.violated:
            b["violated"] += 1
        b["wait_s_sum"] += tl.phase_seconds(QUEUED)

    if rows:
        qdepth = _gauge_bucket_stats(rows, "queue_depth", bucket, n)
        steals = _counter_bucket_deltas(rows, "steals", bucket, n)
        resizes = _counter_bucket_deltas(rows, "resizes", bucket, n)
        waits = _histogram_bucket_quantiles(rows, "queue_wait_s", bucket, n)
        for i, b in enumerate(out):
            b["queue_depth"] = qdepth[i]
            b["steals"] = steals[i]
            b["resizes"] = resizes[i]
            b["wait_p50"] = waits[i][0.5]
            b["wait_p95"] = waits[i][0.95]
            b["wait_p99"] = waits[i][0.99]
    return out


def render_report(timelines, metric_rows: Optional[Iterable[Dict]] = None,
                  *, bucket: float = 60.0,
                  title: str = "SLO attainment over time") -> str:
    """The human-readable per-bucket table plus a totals footer."""
    tls = _timelines_list(timelines)
    rows = report_rows(tls, metric_rows, bucket=bucket)
    have_metrics = any(r["queue_depth"] is not None for r in rows)
    have_shed = any(r["shed"] for r in rows)

    header = (f"{'t[s]':>11s} {'sub':>5s} {'done':>5s} {'viol':>5s} "
              f"{'attain%':>8s} {'wait_s':>7s}")
    if have_shed:
        header += f" {'shed':>5s}"
    if have_metrics:
        header += (f" {'p50':>6s} {'p95':>6s} {'p99':>6s}"
                   f" {'qdepth':>7s} {'steals':>6s} {'resz':>5s}")
    lines = [f"== {title} (bucket={bucket:g}s) ==", header]

    def q(v) -> str:
        return f"{v:>6.1f}" if v is not None else f"{'-':>6s}"

    for r in rows:
        if not (r["submitted"] or r["completed"] or r["rejected"]
                or r["shed"] or (r["queue_depth"] or 0)
                or r["steals"] or r["resizes"]):
            continue
        done = r["completed"]
        attain = 100.0 * (1.0 - r["violated"] / done) if done else float("nan")
        wait = r["wait_s_sum"] / done if done else float("nan")
        line = (f"{r['t0']:5.0f}-{r['t1']:<5.0f} {r['submitted']:>5d} "
                f"{done:>5d} {r['violated']:>5d} "
                f"{attain:>8.1f} {wait:>7.1f}")
        if have_shed:
            line += f" {r['shed']:>5d}"
        if have_metrics:
            qd = r["queue_depth"]
            line += (f" {q(r['wait_p50'])} {q(r['wait_p95'])} "
                     f"{q(r['wait_p99'])}"
                     f" {qd if qd is not None else float('nan'):>7.1f} "
                     f"{r['steals']:>6.0f} {r['resizes']:>5.0f}")
        lines.append(line)

    done = sum(r["completed"] for r in rows)
    viol = sum(r["violated"] for r in rows)
    rej = sum(r["rejected"] for r in rows)
    shed = sum(r["shed"] for r in rows)
    sub = sum(r["submitted"] for r in rows)
    open_jobs = sub - done - shed
    attain = 100.0 * (1.0 - viol / done) if done else 100.0
    foot = (f"total: {sub} submitted, {done} completed, {viol} violated "
            f"(attainment {attain:.1f}%)")
    if rej:
        foot += f", {rej} rejected"
    if shed:
        foot += f", {shed} shed"
    if open_jobs:
        foot += f", {open_jobs} never completed"
    lines.append(foot)
    return "\n".join(lines)
