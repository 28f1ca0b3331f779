"""Metrics time-series plane: a bounded in-memory ring of scrapes.

Prometheus exposition (``util/metrics.py``) answers *what is the value
now*; nothing in the system remembered *what it was a minute ago*. This
module closes that gap without adding a database or a port: a ``TSDB``
holds the last N points of each selected series, and a ``Sampler``
thread snapshots every reachable daemon's scrape on a cadence — the
local process through ``DEFAULT_REGISTRY.prometheus_text()`` and the
cluster daemons through the ``metrics_text`` RPC of the GCS and of
every raylet (no metrics ports needed; the scrape rides the
existing control-plane connection).

Memory is bounded twice: at most ``RAY_TPU_TSDB_SERIES`` distinct
series are tracked (new series beyond the cap are dropped, counted in
``dropped_series``) and each series keeps at most
``RAY_TPU_TSDB_POINTS`` points (oldest evicted). The default budget —
256 series x 360 points x ~16 bytes — is ~1.5 MB.

Consumers:

- dashboard ``/api/timeseries`` → sparkline panels;
- ``ray_tpu top`` → refreshing live table (req/s, TTFT/TPOT p50/p99,
  KV occupancy, per-job shares) derived from counter deltas and
  histogram buckets between consecutive points;
- tests/bench → ``rate()`` / ``histogram_quantile()`` without PromQL.

The port's copy of `ray_tpu/util/tsdb.py`: it scrapes the port's
registry (`ray_tpu_torch.util.metrics`) and the port's daemons. The
dashboard and the CLI verbs above come with their ports.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# families worth remembering by default: the serving plane, the training
# flight recorder, the contention counters the daemons expose, and the
# SLO/health plane (alert + watchdog rows feed back into their own rules).
DEFAULT_PREFIXES = (
    "serve_", "train_step_", "scheduler_", "raylet_", "gcs_table_",
    "rpc_", "object_store_", "compile_cache_", "channel_",
    "compiled_dispatch_", "alert", "health_",
    # the ownership plane's rows are built from a name/kind/value table
    # in core_worker._metrics_text, invisible to raylint's
    # exposition-literal scan
    "ray_tpu_reconstruction",  # raylint: disable=surface-drift
)


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, default)))
    except ValueError:
        return default


def parse_prometheus_text(text: str
                          ) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse exposition text into (name, labels, value) samples.
    Comment/blank lines are skipped; malformed lines are dropped (a
    scraper must survive a torn body, not crash on it)."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, val_part = line.rpartition(" ")
        if not name_part:
            continue
        try:
            value = float(val_part)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        name = name_part
        if "{" in name_part and name_part.endswith("}"):
            name, _, raw = name_part.partition("{")
            body = raw[:-1]
            # label values are escaped per the text format; split on
            # '",' boundaries so embedded commas survive
            for pair in body.split('",'):
                if not pair:
                    continue
                if not pair.endswith('"'):
                    pair = pair + '"'
                k, _, v = pair.partition("=")
                v = v.strip('"').replace('\\"', '"') \
                    .replace("\\n", "\n").replace("\\\\", "\\")
                if k:
                    labels[k.strip()] = v
        out.append((name, labels, value))
    return out


class TSDB:
    """Bounded ring of (ts, value) points per series. A series is
    (metric name, sorted label items, source)."""

    def __init__(self, max_series: Optional[int] = None,
                 max_points: Optional[int] = None,
                 prefixes: Sequence[str] = DEFAULT_PREFIXES):
        self.max_series = max_series or _env_int(
            "RAY_TPU_TSDB_SERIES", 256)
        self.max_points = max_points or _env_int(
            "RAY_TPU_TSDB_POINTS", 360)
        self.prefixes = tuple(prefixes)
        self._series: Dict[tuple, collections.deque] = {}
        self._lock = threading.Lock()
        self.dropped_series = 0
        self.scrapes = 0
        # source -> detail of the newest `# scrape_error` comment seen in
        # that source's body (cleared when a clean body arrives). The
        # parser drops comments, so degraded-source detection has to
        # happen here at ingest — `ray_tpu top` renders these as a
        # DEGRADED banner instead of silently showing stale numbers.
        self.scrape_errors: Dict[str, str] = {}

    def _key(self, name: str, labels: Dict[str, str],
             source: str) -> tuple:
        return (name, tuple(sorted(labels.items())), source)

    def ingest(self, text: str, source: str = "local",
               ts: Optional[float] = None) -> int:
        """Fold one exposition body into the store; returns the number
        of samples kept."""
        ts = time.time() if ts is None else ts
        kept = 0
        samples = parse_prometheus_text(text)
        errors = [line.strip() for line in text.splitlines()
                  if line.strip().startswith("# scrape_error")]
        with self._lock:
            self.scrapes += 1
            if errors:
                self.scrape_errors[source] = errors[-1][1:].strip()
            else:
                self.scrape_errors.pop(source, None)
            for name, labels, value in samples:
                if self.prefixes and not name.startswith(self.prefixes):
                    continue
                key = self._key(name, labels, source)
                ring = self._series.get(key)
                if ring is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    ring = self._series[key] = collections.deque(
                        maxlen=self.max_points)
                ring.append((ts, value))
                kept += 1
        return kept

    # -- queries ---------------------------------------------------------

    def series(self) -> List[tuple]:
        with self._lock:
            return list(self._series.keys())

    def points(self, name: str, labels: Optional[Dict[str, str]] = None,
               source: Optional[str] = None
               ) -> List[Tuple[float, float]]:
        """Concatenated points of every series matching the name, the
        label subset, and (optionally) the source."""
        out: List[Tuple[float, float]] = []
        with self._lock:
            for (n, litems, src), ring in self._series.items():
                if n != name:
                    continue
                if source is not None and src != source:
                    continue
                if labels and any(dict(litems).get(k) != v
                                  for k, v in labels.items()):
                    continue
                out.extend(ring)
        out.sort()
        return out

    def latest(self, name: str,
               labels: Optional[Dict[str, str]] = None,
               source: Optional[str] = None) -> Optional[float]:
        pts = self.points(name, labels, source)
        return pts[-1][1] if pts else None

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             source: Optional[str] = None,
             window_s: float = 30.0) -> Optional[float]:
        """Per-second rate of a counter over the trailing window
        (clamped at 0: a counter reset — daemon restart — reads as a
        quiet period, not a negative rate)."""
        pts = self.points(name, labels, source)
        if len(pts) < 2:
            return None
        cutoff = pts[-1][0] - window_s
        window = [p for p in pts if p[0] >= cutoff]
        if len(window) < 2:
            window = pts[-2:]
        (t0, v0), (t1, v1) = window[0], window[-1]
        if t1 <= t0:
            return None
        return max(0.0, (v1 - v0) / (t1 - t0))

    def increase(self, name: str,
                 labels: Optional[Dict[str, str]] = None,
                 source: Optional[str] = None,
                 window_s: float = 60.0) -> Optional[float]:
        """Total counter growth over the trailing window, summing
        per-segment deltas with the same monotonic-reset clamping as
        `rate()`: a negative step (daemon restart) contributes 0 — the
        reset reads as a quiet period, not as negative growth."""
        pts = self.points(name, labels, source)
        if len(pts) < 2:
            return None
        cutoff = pts[-1][0] - window_s
        window = [p for p in pts if p[0] >= cutoff]
        if len(window) < 2:
            window = pts[-2:]
        return sum(max(0.0, v1 - v0)
                   for (_, v0), (_, v1) in zip(window, window[1:]))

    def _window_values(self, name, labels, source,
                       window_s) -> List[float]:
        pts = self.points(name, labels, source)
        if not pts:
            return []
        cutoff = pts[-1][0] - window_s
        return [v for t, v in pts if t >= cutoff]

    def avg_over_time(self, name: str,
                      labels: Optional[Dict[str, str]] = None,
                      source: Optional[str] = None,
                      window_s: float = 60.0) -> Optional[float]:
        """Mean of a gauge's points inside the trailing window (at
        least the latest point always qualifies)."""
        vals = self._window_values(name, labels, source, window_s)
        return sum(vals) / len(vals) if vals else None

    def max_over_time(self, name: str,
                      labels: Optional[Dict[str, str]] = None,
                      source: Optional[str] = None,
                      window_s: float = 60.0) -> Optional[float]:
        """Max of a gauge's points inside the trailing window."""
        vals = self._window_values(name, labels, source, window_s)
        return max(vals) if vals else None

    def snapshot(self, max_points: int = 120) -> Dict[str, Any]:
        """JSON-able view for /api/timeseries: every series with its
        trailing points."""
        out = []
        with self._lock:
            for (name, litems, source), ring in sorted(
                    self._series.items()):
                pts = list(ring)[-max_points:]
                out.append({
                    "name": name, "labels": dict(litems),
                    "source": source,
                    "points": [[round(t, 3), v] for t, v in pts],
                })
            return {"series": out, "scrapes": self.scrapes,
                    "dropped_series": self.dropped_series,
                    "scrape_errors": dict(self.scrape_errors),
                    "max_series": self.max_series,
                    "max_points": self.max_points}


def histogram_quantile(db: TSDB, family: str, q: float,
                       labels: Optional[Dict[str, str]] = None,
                       source: Optional[str] = None) -> Optional[float]:
    """Estimate a quantile from the LATEST cumulative bucket row of a
    `<family>_bucket{le=...}` histogram (linear interpolation inside
    the winning bucket, like PromQL's histogram_quantile)."""
    buckets: List[Tuple[float, float]] = []
    with db._lock:
        for (name, litems, src), ring in db._series.items():
            if name != f"{family}_bucket" or not ring:
                continue
            if source is not None and src != source:
                continue
            ld = dict(litems)
            le = ld.pop("le", None)
            if le is None:
                continue
            if labels and any(ld.get(k) != v
                              for k, v in labels.items()):
                continue
            bound = float("inf") if le in ("+Inf", "inf") else float(le)
            buckets.append((bound, ring[-1][1]))
    if not buckets:
        return None
    # sum rows across matching series (e.g. every job label) per bound
    agg: Dict[float, float] = {}
    for bound, cum in buckets:
        agg[bound] = agg.get(bound, 0.0) + cum
    ordered = sorted(agg.items())
    total = ordered[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in ordered:
        if cum >= target:
            if bound == float("inf"):
                return prev_bound
            span = cum - prev_cum
            frac = ((target - prev_cum) / span) if span > 0 else 1.0
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = (bound, cum)
    return ordered[-1][0]


def histogram_quantile_over_time(db: TSDB, family: str, q: float,
                                 labels: Optional[Dict[str, str]] = None,
                                 source: Optional[str] = None,
                                 window_s: float = 60.0
                                 ) -> Optional[float]:
    """Quantile of the observations that LANDED inside the trailing
    window: per-`le` bucket `increase()` over the window, then the same
    interpolation as `histogram_quantile`. This is what a windowed SLO
    rule wants — the all-time cumulative quantile can never recover
    after one bad burst, a windowed one does. Falls back to the
    cumulative estimate when the window holds fewer than two scrapes
    (a fresh tsdb)."""
    per_bound: Dict[float, float] = {}
    saw_window = False
    with db._lock:
        keys = [k for k in db._series
                if k[0] == f"{family}_bucket"]
    for (name, litems, src) in keys:
        if source is not None and src != source:
            continue
        ld = dict(litems)
        le = ld.pop("le", None)
        if le is None:
            continue
        if labels and any(ld.get(k) != v for k, v in labels.items()):
            continue
        inc = db.increase(name, dict(litems), src, window_s=window_s)
        if inc is None:
            continue
        saw_window = True
        bound = float("inf") if le in ("+Inf", "inf") else float(le)
        per_bound[bound] = per_bound.get(bound, 0.0) + inc
    if not saw_window:
        return histogram_quantile(db, family, q, labels, source)
    ordered = sorted(per_bound.items())
    total = ordered[-1][1] if ordered else 0.0
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in ordered:
        if cum >= target:
            if bound == float("inf"):
                return prev_bound
            span = cum - prev_cum
            frac = ((target - prev_cum) / span) if span > 0 else 1.0
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = (bound, cum)
    return ordered[-1][0]


# -- cluster scraping ----------------------------------------------------

def scrape_local(db: TSDB, ts: Optional[float] = None) -> int:
    """Snapshot this process's registry (covers every scrape-time
    callback: request recorder, serve_llm engine, compile cache...)."""
    from ray_tpu_torch.util import metrics as _metrics

    return db.ingest(_metrics.DEFAULT_REGISTRY.prometheus_text(),
                     source="local", ts=ts)


def scrape_cluster(db: TSDB, ts: Optional[float] = None) -> Dict[str, int]:
    """Snapshot every reachable daemon over the `metrics_text` RPC (the
    attached GCS + this node's raylet — the same wire path bench.py's
    attribution scrape uses). Returns {source: samples_kept}; daemons
    that aren't reachable simply don't contribute this tick."""
    kept: Dict[str, int] = {}
    try:
        from ray_tpu_torch._private import worker_api

        state = worker_api._global_state
        cw = state.core_worker if state is not None else None
    except Exception:  # noqa: BLE001 — not connected
        cw = None
    if cw is None:
        return kept

    async def scrape():
        out = {}
        try:
            r = await cw.gcs.call("metrics_text", {}, timeout=5.0)
            out["gcs"] = r.get("text", "")
        except Exception:  # noqa: BLE001 — daemon restarting
            pass
        try:
            raylet = await cw._clients.get(cw.raylet_addr)
            r = await raylet.call("metrics_text", {}, timeout=5.0)
            out["raylet"] = r.get("text", "")
        except Exception:  # noqa: BLE001
            pass
        return out

    try:
        texts = cw._run_sync(scrape())
    except Exception:  # noqa: BLE001 — shutdown race
        return kept
    for source, text in texts.items():
        kept[source] = db.ingest(text, source=source, ts=ts)
    return kept


def scrape_once(db: TSDB) -> Dict[str, int]:
    """One sampling tick: local registry + cluster daemons, all stamped
    with one timestamp so cross-source panels line up."""
    ts = time.time()
    kept = {"local": scrape_local(db, ts=ts)}
    kept.update(scrape_cluster(db, ts=ts))
    return kept


class Sampler:
    """Background scrape cadence (daemon thread). One per consumer —
    the dashboard owns one, `ray_tpu top` drives ticks inline."""

    def __init__(self, db: Optional[TSDB] = None,
                 interval_s: Optional[float] = None):
        self.db = db or TSDB()
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    "RAY_TPU_TSDB_INTERVAL", "2.0"))
            except ValueError:
                interval_s = 2.0
        self.interval_s = max(0.1, interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Called after every scrape tick with the db — the SLO alert
        # evaluator rides this so rule evaluation happens exactly at
        # scrape cadence, never on any request/dispatch hot path.
        self.on_scrape = None

    def start(self) -> "Sampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tsdb-sampler", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                scrape_once(self.db)
                if self.on_scrape is not None:
                    self.on_scrape(self.db)
            except Exception:  # noqa: BLE001 — sampling must not die
                pass
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
