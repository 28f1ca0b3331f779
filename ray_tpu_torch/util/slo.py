"""SLO & alert plane: declarative rules evaluated over the tsdb.

Alert semantics follow the multi-window multi-burn-rate recipe from the
Google SRE Workbook (ch. 5): a rule's condition must breach in BOTH a
fast window (responsiveness) and a slow window (flap suppression)
before the alert leaves ``ok``; a ``for_s`` hold then gates
pending→firing; and a firing alert only resolves once *both* windows
are clear again — a brief dip in the fast window cannot flap a firing
alert. The evaluation shape follows Monarch (VLDB '20): rules are
pull-evaluated over an in-memory TSDB at scrape cadence — never on any
request or dispatch hot path (see ``tsdb.Sampler.on_scrape``).

Rule kinds and their windowed measurement:

- ``gauge``        — ``avg_over_time(metric, window)``
- ``gauge_max``    — ``max_over_time(metric, window)``
- ``rate``         — ``rate(metric, window)`` (reset-clamped)
- ``increase``     — ``increase(metric, window)`` (reset-clamped)
- ``quantile``     — ``histogram_quantile_over_time(metric, q, window)``
- ``burn_rate``    — ``(increase(metric)/increase(total_metric))/budget``
                     i.e. how many times faster than sustainable the
                     error budget is burning in that window

Transitions are exported three ways: structured ``events.py`` records
(``ALERT_FIRING`` / ``ALERT_RESOLVED``), Prometheus rows
``alerts_firing{rule=}`` / ``alert_transitions_total{rule=,to=}`` via a
registry callback, and the JSON ``snapshot()`` served at the
dashboard's ``/api/alerts`` and by ``ray_tpu alerts``.

The port's copy of `ray_tpu/util/slo.py`, over the port's `events`,
`tsdb` and metrics registry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.util import events
from ray_tpu_torch.util import tsdb as tsdb_mod

OK = "ok"
PENDING = "pending"
FIRING = "firing"

KINDS = ("gauge", "gauge_max", "rate", "increase", "quantile",
         "burn_rate")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative SLO/alert rule over the tsdb."""

    name: str
    metric: str                 # series name, or histogram family for
                                # kind="quantile"
    threshold: float
    kind: str = "gauge"
    op: str = ">"               # ">" or "<" vs threshold
    q: float = 0.99             # quantile kinds only
    labels: Optional[Tuple[Tuple[str, str], ...]] = None
    source: Optional[str] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    for_s: float = 0.0          # pending hold before firing
    total_metric: Optional[str] = None  # burn_rate denominator
    budget: float = 0.01        # burn_rate error-budget fraction
    severity: str = "WARNING"
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown rule kind: {self.kind!r}")
        if self.op not in (">", "<"):
            raise ValueError(f"unknown rule op: {self.op!r}")
        if self.kind == "burn_rate" and not self.total_metric:
            raise ValueError("burn_rate rules need total_metric")

    def label_dict(self) -> Optional[Dict[str, str]]:
        return dict(self.labels) if self.labels else None

    def breaches(self, value: Optional[float]) -> bool:
        if value is None:
            return False  # absent data is not an SLO violation
        return value > self.threshold if self.op == ">" \
            else value < self.threshold


def measure(db: tsdb_mod.TSDB, rule: Rule,
            window_s: float) -> Optional[float]:
    """The rule's measured value over one window (None = no data)."""
    labels = rule.label_dict()
    if rule.kind == "gauge":
        return db.avg_over_time(rule.metric, labels, rule.source,
                                window_s=window_s)
    if rule.kind == "gauge_max":
        return db.max_over_time(rule.metric, labels, rule.source,
                                window_s=window_s)
    if rule.kind == "rate":
        return db.rate(rule.metric, labels, rule.source,
                       window_s=window_s)
    if rule.kind == "increase":
        return db.increase(rule.metric, labels, rule.source,
                           window_s=window_s)
    if rule.kind == "quantile":
        return tsdb_mod.histogram_quantile_over_time(
            db, rule.metric, rule.q, labels, rule.source,
            window_s=window_s)
    # burn_rate
    errs = db.increase(rule.metric, labels, rule.source,
                       window_s=window_s)
    total = db.increase(rule.total_metric, labels, rule.source,
                        window_s=window_s)
    if errs is None or not total:
        return None
    return (errs / total) / max(rule.budget, 1e-9)


@dataclasses.dataclass
class AlertRecord:
    """Mutable per-rule state the evaluator steps each tick."""

    rule: Rule
    state: str = OK
    pending_since: Optional[float] = None
    firing_since: Optional[float] = None
    resolved_ts: Optional[float] = None
    fast_value: Optional[float] = None
    slow_value: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "rule": self.rule.name,
            "state": self.state,
            "severity": self.rule.severity,
            "metric": self.rule.metric,
            "kind": self.rule.kind,
            "op": self.rule.op,
            "threshold": self.rule.threshold,
            "fast_value": self.fast_value,
            "slow_value": self.slow_value,
            "fast_window_s": self.rule.fast_window_s,
            "slow_window_s": self.rule.slow_window_s,
            "for_s": self.rule.for_s,
            "pending_since": self.pending_since,
            "firing_since": self.firing_since,
            "resolved_ts": self.resolved_ts,
            "description": self.rule.description,
        }


class AlertEvaluator:
    """Steps every rule's state machine against a tsdb at scrape
    cadence. Attach to a ``tsdb.Sampler`` via ``attach()`` (or call
    ``evaluate()`` from your own tick). Thread-safe: one evaluation at
    a time; snapshots may race an evaluation and see the prior state.
    """

    def __init__(self, db: tsdb_mod.TSDB,
                 rules: Optional[List[Rule]] = None,
                 clock: Callable[[], float] = time.time,
                 event_source: str = "SLO",
                 register_metrics: bool = True):
        self.db = db
        self.clock = clock
        self.event_source = event_source
        self._lock = threading.Lock()
        self._records: Dict[str, AlertRecord] = {}
        self._transitions: Dict[Tuple[str, str], int] = {}
        self.evaluations = 0
        for rule in (default_serve_rules() if rules is None else rules):
            self._records[rule.name] = AlertRecord(rule)
        if register_metrics:
            from ray_tpu_torch.util.metrics import DEFAULT_REGISTRY

            DEFAULT_REGISTRY.register_callback("slo", self.metrics_text)

    def attach(self, sampler: "tsdb_mod.Sampler") -> "AlertEvaluator":
        sampler.on_scrape = lambda _db: self.evaluate()
        return self

    def add_rule(self, rule: Rule) -> None:
        with self._lock:
            self._records[rule.name] = AlertRecord(rule)

    # -- the state machine ----------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        now = self.clock() if now is None else now
        with self._lock:
            self.evaluations += 1
            records = list(self._records.values())
        for rec in records:
            self._step(rec, now)
        return self.snapshot()["alerts"]

    def _step(self, rec: AlertRecord, now: float) -> None:
        rule = rec.rule
        rec.fast_value = measure(self.db, rule, rule.fast_window_s)
        rec.slow_value = measure(self.db, rule, rule.slow_window_s)
        breach_fast = rule.breaches(rec.fast_value)
        breach_slow = rule.breaches(rec.slow_value)
        # enter on BOTH windows breaching; a firing alert stays up while
        # EITHER window still breaches (slow window = flap suppressor)
        breach = breach_fast and breach_slow
        clear = not breach_fast and not breach_slow

        if rec.state == OK:
            if breach:
                rec.pending_since = now
                self._transition(rec, PENDING, now)
                if rule.for_s <= 0:
                    self._fire(rec, now)
        elif rec.state == PENDING:
            if not breach:
                rec.pending_since = None
                self._transition(rec, OK, now)
            elif now - rec.pending_since >= rule.for_s:
                self._fire(rec, now)
        elif rec.state == FIRING:
            if clear:
                rec.resolved_ts = now
                rec.pending_since = None
                self._transition(rec, "resolved", now)
                events.report(
                    self.event_source, "INFO", "ALERT_RESOLVED",
                    f"alert '{rule.name}' resolved "
                    f"(value={rec.fast_value})",
                    rule=rule.name, value=rec.fast_value,
                    threshold=rule.threshold,
                    firing_since=rec.firing_since)

    def _fire(self, rec: AlertRecord, now: float) -> None:
        rule = rec.rule
        rec.firing_since = now
        rec.resolved_ts = None
        self._transition(rec, FIRING, now)
        events.report(
            self.event_source, rule.severity, "ALERT_FIRING",
            f"alert '{rule.name}': {rule.metric} {rule.op} "
            f"{rule.threshold:g} "
            f"(fast={rec.fast_value}, slow={rec.slow_value})",
            rule=rule.name, value=rec.fast_value,
            slow_value=rec.slow_value, threshold=rule.threshold,
            severity_hint=rule.severity,
            description=rule.description)

    def _transition(self, rec: AlertRecord, to: str, now: float) -> None:
        rec.state = to if to != "resolved" else OK
        key = (rec.rule.name, to)
        with self._lock:
            self._transitions[key] = self._transitions.get(key, 0) + 1

    # -- exposition ------------------------------------------------------

    def firing(self) -> List[str]:
        with self._lock:
            return [r.rule.name for r in self._records.values()
                    if r.state == FIRING]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            alerts = [r.to_json() for r in self._records.values()]
            transitions = {f"{rule}:{to}": n for (rule, to), n
                           in sorted(self._transitions.items())}
        return {"alerts": alerts, "transitions": transitions,
                "evaluations": self.evaluations,
                "firing": [a["rule"] for a in alerts
                           if a["state"] == FIRING]}

    def metrics_text(self) -> str:
        with self._lock:
            states = [(r.rule.name, r.state)
                      for r in self._records.values()]
            transitions = sorted(self._transitions.items())
        lines = ["# TYPE alerts_firing gauge"]
        for name, state in states:
            lines.append(f'alerts_firing{{rule="{name}"}} '
                         f"{1 if state == FIRING else 0}")
        lines.append("# TYPE alert_transitions_total counter")
        for (name, to), n in transitions:
            lines.append(
                f'alert_transitions_total{{rule="{name}",to="{to}"}} '
                f"{n}")
        return "\n".join(lines) + "\n"


# -- default rule pack ---------------------------------------------------

def default_serve_rules(*, ttft_p99_ms: float = 2000.0,
                        tpot_p99_ms: float = 200.0,
                        max_queue_depth: float = 64.0,
                        max_kv_utilization: float = 0.95,
                        quota_rejects_per_s: float = 1.0
                        ) -> List[Rule]:
    """The serve-plane SLO pack (thresholds overridable via kwargs;
    see README "Alerting & health" for the rule grammar). Rules whose
    series are absent from the tsdb simply never breach."""
    return [
        Rule("serve-ttft-p99", "serve_ttft_ms", ttft_p99_ms,
             kind="quantile", q=0.99, fast_window_s=60.0,
             slow_window_s=300.0, for_s=10.0, severity="ERROR",
             description="p99 time-to-first-token above SLO"),
        Rule("serve-tpot-p99", "serve_tpot_ms", tpot_p99_ms,
             kind="quantile", q=0.99, fast_window_s=60.0,
             slow_window_s=300.0, for_s=10.0, severity="ERROR",
             description="p99 time-per-output-token above SLO"),
        Rule("serve-queue-depth", "serve_llm_waiting_seqs",
             max_queue_depth, kind="gauge", fast_window_s=30.0,
             slow_window_s=120.0, for_s=10.0,
             description="engine admission queue persistently deep"),
        Rule("serve-kv-occupancy", "serve_llm_kv_page_utilization",
             max_kv_utilization, kind="gauge_max", fast_window_s=30.0,
             slow_window_s=120.0, for_s=10.0,
             description="KV arena near capacity — preemption soon"),
        Rule("store-quota-rejects", "object_store_job_quota_rejects",
             quota_rejects_per_s, kind="rate", fast_window_s=30.0,
             slow_window_s=120.0, for_s=5.0,
             description="object-store per-job quota rejecting puts"),
        Rule("reconstruction-failures",
             "ray_tpu_reconstruction_failures_total", 0.0,
             kind="increase", fast_window_s=60.0, slow_window_s=300.0,
             severity="ERROR",
             description="lineage reconstruction giving up on objects"),
        deadman_rule(),
    ]


def deadman_rule(*, fast_window_s: float = 15.0,
                 slow_window_s: float = 15.0) -> Rule:
    """The watchdog feedback rule: any `health_loop_stalled{loop=}`
    gauge at 1 fires immediately (both windows identical — a stall
    detection is already debounced by the watchdog's own stall_s)."""
    return Rule("loop-stalled", "health_loop_stalled", 0.0,
                kind="gauge_max", fast_window_s=fast_window_s,
                slow_window_s=slow_window_s, for_s=0.0,
                severity="ERROR",
                description="a watched hot loop is frozen with backlog")
