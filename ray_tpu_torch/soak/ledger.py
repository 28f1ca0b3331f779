"""Recovery ledger: per-fault-class MTTR accounting from the StepStats
stream, plus failure-attribution and resume-accounting audits.

The ledger is deliberately decoupled from the soak driver: it consumes
plain event streams (faults, observed failures, commits, restores) and
the flight recorder's merged StepStats records (`step_profiler.collect`
— shard files survive worker death, which is exactly why the recorder
is the MTTR source instead of in-process rings).

MTTR definition (matches the soak acceptance criterion): for each
injected fault, the time from the fault's fire timestamp to the
completion of the first post-fault step at which the trailing
`rate_window`-record step rate is back to >= `rate_threshold` (default
0.9) of the pre-fault rate. Rates are measured over gang-step
completion events (per-rank records collapsed per dispatch — see
`_gang_events`) with the SAME window length before and after the fault.
Because some faults disrupt with a lag (a `ckpt_fail` raises at the
next persist, a killed rank's gang steps on until the controller
notices), recovery only counts after the fault's OUTAGE: the first
inter-event gap of at least `min_outage_s` opening within
`degradation_horizon_s` of the fault. A fault that never opens a gap
recovers immediately with `degraded=False`.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclass
class FaultEvent:
    """One injected fault: class name + wall-clock fire timestamp."""
    fault_class: str
    ts: float
    source: str = "driver"
    meta: Dict[str, Any] = field(default_factory=dict)


def _percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100])."""
    if not values:
        return None
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


def _completion_ts(rec: Dict[str, Any]) -> float:
    # StepStats.ts is the step START; recovery is judged on completions
    return rec.get("ts", 0.0) + rec.get("total_ms", 0.0) / 1e3


class RecoveryLedger:
    def __init__(self, *, rate_threshold: float = 0.9,
                 rate_window: int = 8,
                 attribution_window_s: float = 60.0,
                 degradation_horizon_s: float = 20.0,
                 min_outage_s: float = 0.5):
        if not 0.0 < rate_threshold <= 1.0:
            raise ValueError("rate_threshold must be in (0, 1]")
        if rate_window < 1:
            raise ValueError("rate_window must be >= 1")
        if min_outage_s <= 0.0:
            raise ValueError("min_outage_s must be > 0")
        self.rate_threshold = rate_threshold
        self.rate_window = rate_window
        self.attribution_window_s = attribution_window_s
        self.degradation_horizon_s = degradation_horizon_s
        self.min_outage_s = min_outage_s
        self.faults: List[FaultEvent] = []
        self.failures: List[Dict[str, Any]] = []
        self.commits: List[Dict[str, Any]] = []
        self.restores: List[Dict[str, Any]] = []

    # -- event feeds ----------------------------------------------------

    def add_fault(self, fault_class: str, ts: float,
                  source: str = "driver", **meta: Any) -> FaultEvent:
        ev = FaultEvent(fault_class, ts, source, dict(meta))
        self.faults.append(ev)
        return ev

    def add_failure(self, ts: float, error: str) -> None:
        """An attempt-level failure the controller observed
        (TrainingFailedError text)."""
        self.failures.append({"ts": ts, "error": str(error)})

    def add_commit(self, step: int, ts: float,
                   path: Optional[str] = None) -> None:
        """A gang-committed checkpoint at `step` (controller-side,
        recorded after commit_gang_checkpoint returned)."""
        self.commits.append({"step": step, "ts": ts, "path": path})

    def add_restore(self, resumed_from: int, ts: float,
                    path: Optional[str] = None) -> None:
        """A restarted attempt reported it resumed from checkpoint step
        `resumed_from` (read back from the restored payload — bit-exact,
        not inferred)."""
        self.restores.append(
            {"resumed_from": resumed_from, "ts": ts, "path": path})

    def load_chaos_artifacts(self, log_dir: str) -> int:
        """Wire the post-mortem path into the ledger: read every
        `chaos-*.json` artifact a faulted process exported under
        RAY_TPU_CHAOS_LOG and register its timed faults at their ACTUAL
        fire timestamps (a kill artifact is written synchronously before
        `os._exit`, so even abrupt deaths report)."""
        added = 0
        for path in sorted(glob.glob(os.path.join(log_dir,
                                                  "chaos-*.json"))):
            try:
                with open(path) as f:
                    art = json.load(f)
            except (OSError, ValueError):
                logger.warning("unreadable chaos artifact: %s", path)
                continue
            role = art.get("role", "?")
            for fired in art.get("timed_fired", []):
                # class naming matches the soak schedule: "<fault>@<role>"
                self.add_fault(f"{fired['fault']}@{role}", fired["ts"],
                               source=path, offset=fired.get("offset"))
                added += 1
        return added

    # -- analysis -------------------------------------------------------

    @staticmethod
    def _gang_events(records: List[Dict[str, Any]]) -> List[float]:
        """Collapse the merged per-rank records into gang-step
        completion events: ranks run in lockstep, so records for the
        same dispatch share a `step` value and sit adjacent in time
        order — one event per run, at the LAST rank's completion (the
        gang is done when its slowest member is). Replayed steps after a
        walk-back form their own later runs and stay separate. Without
        this collapse, near-simultaneous rank records make single-window
        rates noisy enough to fake degradation onsets."""
        seq = sorted(records, key=_completion_ts)
        events: List[float] = []
        last_step: Optional[int] = object()  # sentinel != any step
        for r in seq:
            t, s = _completion_ts(r), r.get("step")
            if events and s == last_step:
                events[-1] = t
            else:
                events.append(t)
                last_step = s
        return events

    def compute_mttr(self, records: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
        """Per-fault recovery measurement over the gang-step completion
        events derived from the merged StepStats records. Returns one
        dict per injected fault: {fault_class, fault_ts, recovered,
        degraded, mttr_s, pre_rate, post_rate}."""
        times = self._gang_events(records)
        out = []
        for ev in sorted(self.faults, key=lambda e: e.ts):
            out.append(self._measure_one(ev, times))
        return out

    def _measure_one(self, ev: FaultEvent, times: List[float]
                     ) -> Dict[str, Any]:
        res: Dict[str, Any] = {
            "fault_class": ev.fault_class, "fault_ts": ev.ts,
            "recovered": False, "degraded": False, "mttr_s": None,
            "pre_rate": None, "post_rate": None,
        }
        pre = [t for t in times if t <= ev.ts]
        post = [t for t in times if t > ev.ts]
        # window length: capped by available pre-fault history, and the
        # SAME length is used post-fault so the ratio compares like with
        # like
        w = min(self.rate_window, len(pre) - 1)
        if w < 1 or not post:
            return res
        span = pre[-1] - pre[-1 - w]
        if span <= 0:
            return res
        pre_rate = w / span
        res["pre_rate"] = pre_rate
        # Two phases. Some faults disrupt with a LAG (a ckpt_fail armed
        # at t raises at the NEXT persist; a killed rank's gang keeps
        # stepping until the controller notices), so steps recorded
        # right after the fire time would trivially satisfy the
        # threshold. Phase 1 looks for the OUTAGE the fault opened: the
        # first inter-event gap of at least `min_outage_s` starting
        # within `degradation_horizon_s` of the fault (a gap, not a
        # window-rate dip — at kHz gang rates a 10 ms scheduler hiccup
        # dents a rate window, but only a real stall or restart opens a
        # half-second hole in the completion stream). Recovery (phase 2)
        # is the first window at/after the outage end whose rate is back
        # over threshold. A fault that never opens a gap (e.g. a
        # brownout the retry plane absorbed, or a stall landing in an
        # already-idle process) recovers at its first measurable window
        # with degraded=False.
        rates: List[Tuple[float, float]] = []   # (window end ts, rate)
        for i in range(w, len(post)):
            span = post[i] - post[i - w]
            if span > 0:
                rates.append((post[i], w / span))
        if not rates:
            return res
        thr = self.rate_threshold * pre_rate
        horizon = ev.ts + self.degradation_horizon_s
        # gap boundaries: the fault itself may open the first gap
        # (nothing completes between the fire time and post[0])
        bounds = [(ev.ts, post[0])]
        bounds += [(post[k - 1], post[k]) for k in range(1, len(post))]
        onset_end = None
        for start, end in bounds:
            if start > horizon:
                break
            if end - start >= self.min_outage_s:
                onset_end = end
                break
        if onset_end is None:
            t, r = rates[0]
            res.update(recovered=True, mttr_s=t - ev.ts, post_rate=r)
            return res
        res["degraded"] = True
        for t, r in rates:
            if t >= onset_end and r >= thr:
                res.update(recovered=True, mttr_s=t - ev.ts,
                           post_rate=r)
                break
        return res

    def classify_failures(self) -> Tuple[List[Dict[str, Any]],
                                         List[Dict[str, Any]]]:
        """(injected, non_injected) split of the observed failures. A
        failure is attributed to chaos when its error text names the
        chaos plane or when an injected fault fired within
        `attribution_window_s` before it; anything else is a REAL bug
        the soak surfaced."""
        injected, non_injected = [], []
        for f in self.failures:
            text = f["error"].lower()
            by_text = "chaos" in text
            by_time = any(
                0.0 <= f["ts"] - ev.ts <= self.attribution_window_s
                for ev in self.faults)
            (injected if by_text or by_time else non_injected).append(f)
        return injected, non_injected

    def resume_mismatches(self) -> List[Dict[str, Any]]:
        """Bit-exact `resumed_from` audit: every restore must resume
        from the step of the newest checkpoint gang-committed BEFORE it.
        Returns the violations (empty list == clean)."""
        mismatches = []
        for r in self.restores:
            prior = [c for c in self.commits if c["ts"] <= r["ts"]]
            expected = prior[-1]["step"] if prior else None
            if r["resumed_from"] != expected:
                mismatches.append(
                    {"restore": r, "expected_step": expected})
        return mismatches

    def downtime_breakdown(self, records: List[Dict[str, Any]],
                           mttr: List[Dict[str, Any]]
                           ) -> Dict[str, float]:
        """Recorder-attributed downtime: over every recovery window
        (fault fire -> recovered step), split wall time into recorded
        step phases vs dead time no record covers (restart, PG
        re-placement, torch re-init). Seconds, summed across windows."""
        phases = ("host_dispatch_ms", "device_execute_ms",
                  "data_wait_ms", "collective_ms", "checkpoint_ms")
        out = {p: 0.0 for p in phases}
        out["dead_s"] = 0.0
        out["total_s"] = 0.0
        for m in mttr:
            if not m["recovered"]:
                continue
            lo, hi = m["fault_ts"], m["fault_ts"] + m["mttr_s"]
            busy = 0.0
            for r in records:
                if lo < _completion_ts(r) <= hi:
                    busy += r.get("total_ms", 0.0) / 1e3
                    for p in phases:
                        out[p] += r.get(p, 0.0) / 1e3
            out["dead_s"] += max(0.0, (hi - lo) - busy)
            out["total_s"] += hi - lo
        return {k: round(v, 3) for k, v in out.items()}

    def report(self, records: List[Dict[str, Any]]) -> Dict[str, Any]:
        """The full ledger: per-fault recoveries, per-class MTTR
        p50/p95, failure attribution, resume audit, downtime split."""
        mttr = self.compute_mttr(records)
        by_class: Dict[str, Dict[str, Any]] = {}
        for m in mttr:
            c = by_class.setdefault(m["fault_class"], {
                "count": 0, "recovered": 0, "mttrs": []})
            c["count"] += 1
            if m["recovered"]:
                c["recovered"] += 1
                c["mttrs"].append(m["mttr_s"])
        mttr_by_class = {
            cls: {
                "count": c["count"],
                "recovered": c["recovered"],
                "mttr_p50_s": _percentile(c["mttrs"], 50),
                "mttr_p95_s": _percentile(c["mttrs"], 95),
            }
            for cls, c in sorted(by_class.items())
        }
        injected, non_injected = self.classify_failures()
        return {
            "faults_injected": len(self.faults),
            "recoveries": mttr,
            "recovered_count": sum(1 for m in mttr if m["recovered"]),
            "mttr_by_class": mttr_by_class,
            "failures_observed": len(self.failures),
            "injected_failures": len(injected),
            "non_injected_failures": non_injected,
            "commits": len(self.commits),
            "restores": len(self.restores),
            "resume_mismatches": self.resume_mismatches(),
            "downtime_breakdown_s":
                self.downtime_breakdown(records, mttr),
        }

    def assert_clean(self, report: Optional[Dict[str, Any]] = None,
                     records: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
        """Raise AssertionError on any non-injected failure or
        resume-accounting mismatch; returns the report."""
        if report is None:
            report = self.report(records or [])
        if report["non_injected_failures"]:
            raise AssertionError(
                "non-injected failures during soak: "
                f"{report['non_injected_failures']}")
        if report["resume_mismatches"]:
            raise AssertionError(
                "resume accounting mismatches: "
                f"{report['resume_mismatches']}")
        return report
