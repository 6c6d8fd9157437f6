"""Online alert rules: multi-window burn-rate, queue pressure,
quarantine count — evaluated in simulated time, emitted as typed
events.

:class:`AlertRules` subscribes to the fabric event stream (wired by
``Telemetry(alerts=...)``) and evaluates every rule at a fixed
sim-time cadence (``interval`` seconds, boundaries crossed by incoming
event times). A rule transition emits a typed
:data:`~repro_torch.cluster.elastic.ALERT_FIRED` /
:data:`~repro_torch.cluster.elastic.ALERT_RESOLVED` ``EngineEvent`` back
onto the same bus via ``fabric.announce`` — so the
:class:`~repro_torch.cluster.elastic.ElasticController` (which schedules an
immediate control cycle on a firing) and any future SLO autotuner
subscribe with zero extra wiring, and telemetry folds the alert into
its audit log, metrics, and Chrome-trace instants automatically.

Rule kinds:

* ``burn_rate`` — the SRE multi-window burn rate on SLO attainment:
  ``burn(W) = violation_rate(W) / (1 - target_attainment)`` over the
  completions in the trailing window ``W``. Fires when **both** the
  long and short windows burn at ``threshold`` or above (the long
  window proves it matters, the short window proves it is still
  happening); resolves when the short window drops below.
* ``queue_pressure`` — max per-shard ``pressure`` gauge from the
  *captured, full* metrics windows, sustained at ``threshold`` or
  above for ``short_s`` seconds.
* ``quarantine`` — count of controller ``quarantine`` audit decisions
  in the trailing ``window_s`` seconds at ``threshold`` or above.

**Replay identity** (pinned by tests): :meth:`AlertRules.replay` re-
evaluates the same rules from an exported JSONL trace (timelines +
metric rows + audit entries) and fires at the *identical sim-times*
as the live run. Every input a rule reads is derived from data that
round-trips through the export: completion times/verdicts from the
timelines, pressure from the captured metric windows (full windows
only — live evaluation never sees the final partial window either),
quarantine decisions from the audit log.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.elastic import ALERT_FIRED, ALERT_RESOLVED, QUARANTINE
from repro_torch.cluster.engine import JOB_DONE, EngineEvent

BURN_RATE = "burn_rate"
QUEUE_PRESSURE = "queue_pressure"
QUARANTINE_COUNT = "quarantine"
_KINDS = (BURN_RATE, QUEUE_PRESSURE, QUARANTINE_COUNT)

_EPS = 1e-9


@dataclass(frozen=True)
class AlertRule:
    """One alert rule. Which knobs apply depends on ``kind``:
    ``burn_rate`` reads ``long_s``/``short_s``/``target_attainment``;
    ``queue_pressure`` reads ``short_s`` (the sustain requirement);
    ``quarantine`` reads ``window_s``."""

    name: str
    kind: str
    threshold: float
    long_s: float = 300.0
    short_s: float = 60.0
    target_attainment: float = 0.90
    window_s: float = 600.0


DEFAULT_RULES: Tuple[AlertRule, ...] = (
    AlertRule(name="slo-burn", kind=BURN_RATE, threshold=2.0),
    AlertRule(name="queue-pressure", kind=QUEUE_PRESSURE, threshold=2.0),
    AlertRule(name="quarantine-count", kind=QUARANTINE_COUNT,
              threshold=1.0),
)


@dataclass(frozen=True)
class AlertEvent:
    """One fired/resolved transition, as recorded in ``history``."""

    time: float
    kind: str                  # alert_fired | alert_resolved
    rule: str
    value: float
    detail: str                # "<rule>: <why>" (matches the EngineEvent)


class AlertRules:
    """The online evaluator; one instance per fabric.

    Wire through ``Telemetry(alerts=AlertRules())`` — attach binds
    :meth:`bind` and subscribes :meth:`on_event` *after* telemetry's
    own subscription, so metric windows are captured before any rule
    reads them (the same visibility replay reconstructs).
    """

    def __init__(self, rules: Sequence[AlertRule] = DEFAULT_RULES, *,
                 interval: float = 15.0):
        if interval <= 0:
            raise ValueError(f"interval must be > 0 seconds, "
                             f"got {interval}")
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        for r in rules:
            if r.kind not in _KINDS:
                raise ValueError(f"unknown rule kind {r.kind!r}; "
                                 f"expected one of {_KINDS}")
        self.rules = tuple(rules)
        self.interval = interval
        self.history: List[AlertEvent] = []
        self.active: Dict[str, bool] = {r.name: False for r in self.rules}
        self._above_since: Dict[str, Optional[float]] = {
            r.name: None for r in self.rules}
        self._completions: List[Tuple[float, bool]] = []
        self._next_eval = interval
        self._emit: Optional[Callable[[EngineEvent], None]] = None
        self._metrics = None
        self._audit = None
        self._full_width: Optional[float] = None
        self._replay_windows = None
        self._replay_audit = None

    # -- wiring ---------------------------------------------------------------

    def bind(self, *, emit: Optional[Callable[[EngineEvent], None]] = None,
             metrics=None, audit=None) -> "AlertRules":
        """Attach the event emitter (``fabric.announce``) and the
        telemetry stores the rules read. Done by ``Telemetry.attach``."""
        self._emit = emit
        self._metrics = metrics
        self._audit = audit
        if metrics is not None:
            self._full_width = metrics.window
        return self

    # -- live driving ---------------------------------------------------------

    def on_event(self, ev: EngineEvent) -> None:
        if ev.kind in (ALERT_FIRED, ALERT_RESOLVED):
            return                 # our own emissions re-enter the bus
        if ev.kind == JOB_DONE and ev.job is not None:
            self._completions.append(
                (ev.time, ev.time > ev.job.deadline + _EPS))
        while self._next_eval <= ev.time:
            self._evaluate(self._next_eval)
            self._next_eval += self.interval

    # -- rule evaluation (shared by live + replay) ----------------------------

    def _evaluate(self, t: float) -> None:
        for r in self.rules:
            active = self.active[r.name]
            if r.kind == BURN_RATE:
                short_b = self._burn(t, r.short_s, r)
                long_b = self._burn(t, r.long_s, r)
                fire = (short_b >= r.threshold
                        and (active or long_b >= r.threshold))
                value = short_b
                why = (f"burn {short_b:.2f}x/{long_b:.2f}x over "
                       f"{r.short_s:g}s/{r.long_s:g}s windows "
                       f"(attainment target "
                       f"{100.0 * r.target_attainment:g}%)")
            elif r.kind == QUEUE_PRESSURE:
                value = self._max_pressure(t)
                if value >= r.threshold:
                    if self._above_since[r.name] is None:
                        self._above_since[r.name] = t
                else:
                    self._above_since[r.name] = None
                since = self._above_since[r.name]
                sustained = 0.0 if since is None else t - since
                fire = since is not None and sustained >= r.short_s - _EPS
                why = (f"max shard pressure {value:.2f} vs "
                       f"{r.threshold:g} (sustained {sustained:g}s / "
                       f"{r.short_s:g}s)")
            else:                  # QUARANTINE_COUNT
                value = float(self._quarantine_count(t, r.window_s))
                fire = value >= r.threshold
                why = (f"{value:g} quarantine decisions in trailing "
                       f"{r.window_s:g}s")
            if fire and not active:
                self._transition(t, ALERT_FIRED, r, value, why)
            elif active and not fire:
                self._transition(t, ALERT_RESOLVED, r, value, why)

    def _transition(self, t: float, kind: str, r: AlertRule,
                    value: float, why: str) -> None:
        self.active[r.name] = kind == ALERT_FIRED
        detail = f"{r.name}: {why}"
        self.history.append(AlertEvent(time=t, kind=kind, rule=r.name,
                                       value=value, detail=detail))
        if self._emit is not None:
            self._emit(EngineEvent(kind=kind, time=t, shard=-1,
                                   detail=detail))

    # -- rule inputs ----------------------------------------------------------

    def _burn(self, t: float, window: float, r: AlertRule) -> float:
        budget = max(1.0 - r.target_attainment, _EPS)
        comps = viols = 0
        for ct, violated in reversed(self._completions):
            if ct <= t - window:
                break              # completions are time-ordered
            if ct > t:
                continue
            comps += 1
            viols += 1 if violated else 0
        return (viols / comps) / budget if comps else 0.0

    def _windows(self) -> List[Tuple[float, float, Dict]]:
        """Captured metric windows as ``(start, end, {series: state})``,
        in capture order."""
        if self._replay_windows is not None:
            return self._replay_windows
        if self._metrics is None:
            return []
        return [(w.start, w.end, w.series) for w in self._metrics.windows]

    def _max_pressure(self, t: float) -> float:
        vis = [w for w in self._windows() if w[1] <= t + _EPS]
        if not vis:
            return 0.0
        # full windows only: the final close() partial is export-side
        # state live evaluation never saw, so replay must skip it too
        width = self._full_width
        if width is None:
            width = max(e - s for s, e, _ in vis)
        vis = [w for w in vis if w[1] - w[0] >= width - _EPS]
        if not vis:
            return 0.0
        _, _, series = max(vis, key=lambda w: w[1])
        best = 0.0
        for sid, state in series.items():
            if sid == "pressure" or sid.startswith("pressure{"):
                best = max(best, float(state.get("value", 0.0)))
        return best

    def _quarantine_count(self, t: float, window: float) -> int:
        if self._replay_audit is not None:
            entries = self._replay_audit
        elif self._audit is not None:
            entries = self._audit.entries
        else:
            entries = ()
        return sum(1 for e in entries
                   if e.action == QUARANTINE and t - window < e.time <= t)

    # -- offline replay -------------------------------------------------------

    def replay(self, timelines, metric_rows: Sequence[Dict] = (),
               audit: Sequence = (), *,
               horizon: Optional[float] = None,
               window: Optional[float] = None) -> List[AlertEvent]:
        """Re-evaluate these rules from exported data and return the
        alert history — identical (time, kind, rule) transitions to the
        live run that produced the export. ``timelines`` /
        ``metric_rows`` / ``audit`` are the three lists
        :func:`repro_torch.obs.export.read_jsonl` returns; the default
        horizon is the last captured metric window end (== the last
        event time the live run saw). ``window`` is the metrics window
        size of the recording run, used to tell the final partial
        window apart from full ones (default: the widest window in the
        export)."""
        from repro_torch.obs.spans import TimelineRecorder

        if isinstance(timelines, TimelineRecorder):
            tls = list(timelines.timelines().values())
        elif isinstance(timelines, dict):
            tls = list(timelines.values())
        else:
            tls = list(timelines)
        sim = AlertRules(self.rules, interval=self.interval)
        sim._completions = sorted(
            (tl.finish, bool(tl.violated)) for tl in tls
            if tl.reject_reason is None and tl.shed_reason is None
            and tl.violated is not None and tl.finish is not None)
        per_window: Dict[Tuple[float, float], Dict] = {}
        for row in metric_rows:
            key = (float(row["window_start"]), float(row["window_end"]))
            per_window.setdefault(key, {})[row["series"]] = row
        sim._replay_windows = [(s, e, series) for (s, e), series
                               in sorted(per_window.items(),
                                         key=lambda kv: kv[0][1])]
        sim._replay_audit = list(audit)
        if window is not None:
            sim._full_width = window
        elif sim._replay_windows:
            sim._full_width = max(e - s for s, e, _ in sim._replay_windows)
        if horizon is None:
            horizon = 0.0
            for _, e, _series in sim._replay_windows:
                horizon = max(horizon, e)
            if not sim._replay_windows:
                for ct, _v in sim._completions:
                    horizon = max(horizon, ct)
                for e in sim._replay_audit:
                    horizon = max(horizon, e.time)
        t = sim.interval
        while t <= horizon:
            sim._evaluate(t)
            t += sim.interval
        return list(sim.history)
