"""Metrics registry: counters, gauges, and log-bucketed histograms.

Every instrument is keyed by ``(name, labels)`` — the same metric name
with different label sets is a different series, Prometheus-style::

    reg = MetricsRegistry(window=60.0)
    reg.counter("jobs_completed", shard=0, tenant="acme").inc()
    reg.gauge("queue_depth", shard=1).set(7)
    reg.histogram("queue_wait_s", shard=0).observe(3.2)

Time is *simulated* time, driven explicitly through :meth:`advance`:
each time the clock crosses a ``window`` boundary the registry captures
a :class:`WindowSnapshot` of every series (cumulative counter values,
last-set gauge values with window min/max, histogram state), which is
what the report layer and the JSONL export consume. Counters therefore
read both cumulatively (``value``) and per-window (adjacent snapshot
deltas, :meth:`MetricsRegistry.window_deltas`).

Histograms are log-bucketed: observation ``v`` lands in bucket
``ceil(log2(v / base))`` (clamped), so a handful of integer bucket
indices cover queue waits from milliseconds to hours with bounded
relative error — the standard trick for latency distributions.

The registry is plain Python state with no background machinery: when
nothing records into it, nothing happens (zero-overhead-when-off lives
one level up — telemetry only subscribes to the event stream when the
user asks for it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_series(name: str, labels: LabelKey) -> str:
    """Canonical ``name{k=v,...}`` series id (sorted labels; bare name
    when there are none)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (resets only with the registry)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        self.value += amount

    def read(self) -> Dict[str, float]:
        return {"value": self.value}


class Gauge:
    """Last-set value, with min/max tracked since the last window roll
    so a snapshot shows the excursion, not just the final sample."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0
        self._set_ever = False
        self.window_min = math.inf
        self.window_max = -math.inf

    def set(self, value: float) -> None:
        self.value = float(value)
        self._set_ever = True
        self.window_min = min(self.window_min, self.value)
        self.window_max = max(self.window_max, self.value)

    def add(self, delta: float) -> None:
        self.set(self.value + delta)

    def read(self) -> Dict[str, float]:
        lo = self.value if math.isinf(self.window_min) else self.window_min
        hi = self.value if math.isinf(self.window_max) else self.window_max
        return {"value": self.value, "min": lo, "max": hi}

    def roll(self) -> None:
        self.window_min = math.inf
        self.window_max = -math.inf


class Histogram:
    """Log-bucketed distribution: bucket ``i`` holds observations in
    ``(base * 2**(i-1), base * 2**i]`` (bucket 0: ``<= base``). Tracks
    count / sum / min / max exactly; quantiles come from the buckets
    with bounded relative error (a factor of 2 per bucket)."""

    kind = "histogram"

    def __init__(self, base: float = 0.001, max_bucket: int = 64) -> None:
        if base <= 0:
            raise ValueError(f"histogram base must be > 0, got {base}")
        self.base = base
        self.max_bucket = max_bucket
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def bucket_index(self, value: float) -> int:
        if value <= self.base:
            return 0
        i = math.ceil(math.log2(value / self.base))
        return min(i, self.max_bucket)

    def bucket_upper_bound(self, index: int) -> float:
        return self.base * (2.0 ** index)

    def observe(self, value: float) -> None:
        if value < 0:
            raise ValueError(f"histogram observations must be >= 0, "
                             f"got {value}")
        i = self.bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0 when
        empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                return min(self.bucket_upper_bound(i), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def read(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": self.mean,
            # base rides along so exported rows can reconstruct bucket
            # upper bounds (base * 2**index) for offline quantiles
            "base": self.base,
            "buckets": dict(sorted(self.buckets.items())),
        }


@dataclass
class WindowSnapshot:
    """All series' states captured at one window boundary. Counter and
    histogram values are cumulative-as-of-``end``; gauge min/max cover
    just this window."""

    start: float
    end: float
    series: Dict[str, Dict[str, object]] = field(default_factory=dict)


class MetricsRegistry:
    """The `(name, labels)`-keyed instrument store plus the sim-time
    window clock."""

    def __init__(self, window: float = 60.0) -> None:
        if window <= 0:
            raise ValueError(f"window must be > 0 seconds, got {window}")
        self.window = window
        self._instruments: Dict[Tuple[str, LabelKey], object] = {}
        self._kinds: Dict[str, str] = {}       # name -> kind (consistency)
        self.windows: List[WindowSnapshot] = []
        self._window_start = 0.0
        self.now = 0.0

    # -- instrument accessors ------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, object], **kwargs):
        want = cls.kind
        have = self._kinds.setdefault(name, want)
        if have != want:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{have}, requested {want}")
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(**kwargs)
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, base: float = 0.001, **labels) -> Histogram:
        return self._get(Histogram, name, labels, base=base)

    def series(self) -> List[str]:
        """Every registered series id, sorted."""
        return sorted(format_series(n, lk) for n, lk in self._instruments)

    # -- window clock --------------------------------------------------------

    def advance(self, t: float) -> None:
        """Move the sim clock to ``t``, capturing a snapshot for every
        completed window boundary crossed on the way. Safe to call with
        a non-advancing ``t`` (no-op)."""
        while t >= self._window_start + self.window:
            end = self._window_start + self.window
            self._capture(self._window_start, end)
            self._window_start = end
        self.now = max(self.now, t)

    def close(self) -> None:
        """Capture the final partial window (idempotent for an empty
        remainder)."""
        if self.now > self._window_start:
            self._capture(self._window_start, self.now)
            self._window_start = self.now

    def _capture(self, start: float, end: float) -> None:
        snap = WindowSnapshot(start=start, end=end)
        for (name, lk), inst in sorted(self._instruments.items()):
            snap.series[format_series(name, lk)] = inst.read()
        self.windows.append(snap)
        for inst in self._instruments.values():
            if isinstance(inst, Gauge):
                inst.roll()

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Current state of every series (not window-aligned)."""
        return {format_series(n, lk): inst.read()
                for (n, lk), inst in sorted(self._instruments.items())}

    def value(self, name: str, **labels) -> float:
        """Convenience scalar read: counter/gauge value (0 when the
        series does not exist)."""
        inst = self._instruments.get((name, _label_key(labels)))
        if inst is None:
            return 0.0
        return inst.read().get("value", 0.0)   # type: ignore[union-attr]

    def total(self, name: str) -> float:
        """Sum of a counter/gauge ``value`` across all label sets."""
        out = 0.0
        for (n, _lk), inst in self._instruments.items():
            if n == name:
                out += inst.read().get("value", 0.0)  # type: ignore
        return out

    def window_deltas(self, name: str, **labels) -> List[Tuple[float, float,
                                                               float]]:
        """Per-window increments of a cumulative (counter) series:
        ``[(start, end, delta), ...]`` over the captured windows."""
        sid = format_series(name, _label_key(labels))
        out: List[Tuple[float, float, float]] = []
        prev = 0.0
        for w in self.windows:
            cur = float(w.series.get(sid, {}).get("value", prev))
            out.append((w.start, w.end, cur - prev))
            prev = cur
        return out

    # -- export --------------------------------------------------------------

    def to_dicts(self) -> Iterable[Dict[str, object]]:
        """One JSON-able dict per (window, series) — the metrics JSONL
        rows."""
        for w in self.windows:
            for sid, state in w.series.items():
                yield {"type": "metric", "window_start": w.start,
                       "window_end": w.end, "series": sid, **state}
