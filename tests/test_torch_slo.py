"""The port's metrics time series and SLO alerts (`ray_tpu_torch.util.
tsdb`, `.slo`) held to the JAX package's: the same series go through
both packages' `TSDB` and `AlertEvaluator` and must give the same
windowed increases, rates, quantiles, alert states, transitions, events
and `metrics_text` rows. The scenarios are those of `tests/test_slo.py`
(the tsdb's windowed measurements and the alert state machine) and the
tsdb cases of `tests/test_request_recorder.py` (exposition parsing,
bounds, rates, quantiles); each checks the JAX package's values as its
oracle file does, then requires the port's to be equal. The CLI's stack
and alerts verbs against a live cluster are in `tests/test_torch_cli.py`.
"""

import importlib
import json

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mods(pkg):
    return (importlib.import_module(pkg + ".util.tsdb"),
            importlib.import_module(pkg + ".util.slo"),
            importlib.import_module(pkg + ".util.events").list_events)


def _feed(db, rows, ts, source="test"):
    if isinstance(rows, str):
        rows = [rows]
    db.ingest("\n".join(rows) + "\n", source=source, ts=ts)


# -- tsdb windowed measurements ----------------------------------------------


def increase_and_rate(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    for i, v in enumerate((0, 40, 5, 25)):
        _feed(db, f"requests_total {v}", ts=100.0 + 10 * i)
    db2 = tsdb.TSDB(prefixes=())
    _feed(db2, "requests_total 7", ts=100.0)
    db3 = tsdb.TSDB(prefixes=())
    for i, v in enumerate((0, 100, 110, 120)):
        _feed(db3, f"c_total {v}", ts=100.0 + 30 * i)
    return {"increase": db.increase("requests_total", window_s=60.0),
            "rate": db.rate("requests_total", window_s=12.0),
            "single": db2.increase("requests_total"),
            "cutoff": db3.increase("c_total", window_s=60.0)}


def avg_and_max(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    for i, v in enumerate((1.0, 3.0, 5.0, 11.0)):
        _feed(db, f"queue_depth {v}", ts=100.0 + 10 * i)
    return {"avg20": db.avg_over_time("queue_depth", window_s=20.0),
            "max20": db.max_over_time("queue_depth", window_s=20.0),
            "avg_all": db.avg_over_time("queue_depth", window_s=1000.0),
            "missing": [db.avg_over_time("missing_series"),
                        db.max_over_time("missing_series")]}


def windowed_quantiles(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())

    def rows(le_counts):
        return [f'lat_ms_bucket{{le="{le}"}} {c}' for le, c in le_counts]

    _feed(db, rows([("10", 0), ("100", 0), ("+Inf", 100)]), ts=100.0)
    _feed(db, rows([("10", 50), ("100", 50), ("+Inf", 150)]), ts=160.0)
    _feed(db, rows([("10", 100), ("100", 100), ("+Inf", 200)]), ts=220.0)
    one = tsdb.TSDB(prefixes=())
    _feed(one, ['lat_ms_bucket{le="10"} 3', 'lat_ms_bucket{le="+Inf"} 4'],
          ts=100.0)
    return {
        "cumulative": tsdb.histogram_quantile(db, "lat_ms", 0.9),
        "windowed": tsdb.histogram_quantile_over_time(
            db, "lat_ms", 0.9, window_s=70.0),
        "fallback": [tsdb.histogram_quantile_over_time(one, "lat_ms", 0.5),
                     tsdb.histogram_quantile(one, "lat_ms", 0.5)],
        "absent": tsdb.histogram_quantile_over_time(one, "nope", 0.9)}


def scrape_errors(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    db.ingest('ok_metric 1\n# scrape_error source="engine" '
              'error="TypeError"\n', source="local")
    degraded = json.loads(json.dumps(db.snapshot()["scrape_errors"]))
    db.ingest("ok_metric 2\n", source="local")
    metrics = importlib.import_module(tsdb.__name__.rsplit(".", 1)[0]
                                      + ".metrics")
    reg = metrics._Registry()
    reg.register_callback("boom", lambda: 1 / 0)
    text = reg.prometheus_text()
    db2 = tsdb.TSDB()
    db2.ingest(text, source="local")
    return {"degraded": sorted(degraded), "engine": "engine" in degraded.get(
        "local", {}), "cleared": db.scrape_errors,
        "boom_row": '# scrape_error source="boom"' in text,
        "boom_tracked": "boom" in db2.scrape_errors.get("local", {})}


# -- the tsdb cases of test_request_recorder.py ------------------------------


def parse_exposition(tsdb, slo, list_events, env):
    text = ("# HELP x about\n# TYPE x counter\nserve_x_total 3\n"
            'serve_y{job="a,b",name="quo\\"te"} 1.5\n'
            "malformed line without value x\n")
    return {"samples": [list(s) for s in tsdb.parse_prometheus_text(text)]}


def bounded_series_and_points(tsdb, slo, list_events, env):
    db = tsdb.TSDB(max_series=2, max_points=3, prefixes=("serve_",))
    for i in range(5):
        db.ingest(f"serve_a 1\nserve_b 2\nserve_c 3\nother {i}\n",
                  source="t", ts=float(i))
    return {"series": len(db.series()), "dropped": db.dropped_series,
            "points": [t for t, _ in db.points("serve_a", source="t")],
            "latest": db.latest("serve_b")}


def rate_clamps_resets(tsdb, slo, list_events, env):
    db = tsdb.TSDB(max_series=4, max_points=16, prefixes=("serve_",))
    for i, v in enumerate((0, 10, 20, 30)):
        db.ingest(f"serve_reqs_total {v}\n", source="t", ts=float(i))
    before = db.rate("serve_reqs_total", window_s=10.0)
    db.ingest("serve_reqs_total 0\n", source="t", ts=4.0)
    return {"rate": before,
            "after_reset": db.rate("serve_reqs_total", window_s=10.0)}


def quantile_interpolates(tsdb, slo, list_events, env):
    db = tsdb.TSDB(max_series=8, max_points=4, prefixes=())
    db.ingest('lat_bucket{le="1.0"} 0\nlat_bucket{le="2.0"} 5\n'
              'lat_bucket{le="+Inf"} 10\n', source="t", ts=1.0)
    return {q: tsdb.histogram_quantile(db, "lat", q)
            for q in (0.25, 0.5, 0.75, 0.99)}


# -- the alert state machine --------------------------------------------------


def _gauge_rule(slo, **kw):
    kw.setdefault("fast_window_s", 10.0)
    kw.setdefault("slow_window_s", 40.0)
    return slo.Rule(kw.pop("name", "test-queue"),
                    kw.pop("metric", "queue_depth"),
                    kw.pop("threshold", 5.0), **kw)


def _evaluator(slo, db, rules, env, source):
    env.setenv("RAY_TPU_EVENT_DIR", env.event_dir(source))
    return slo.AlertEvaluator(db, rules=rules, register_metrics=False,
                              event_source=source)


def _alert(snap):
    [a] = snap["alerts"]
    return {k: a[k] for k in ("state", "firing_since", "resolved_ts")}


def pending_firing_resolved(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    ev = _evaluator(slo, db, [_gauge_rule(slo, for_s=10.0)], env,
                    "SLO_TEST")
    out = {}
    for i in range(9):
        _feed(db, "queue_depth 1", ts=100.0 + 5 * i)
        ev.evaluate(now=100.0 + 5 * i)
    out["clean"] = [_alert(ev.snapshot()), ev.snapshot()["transitions"]]
    for i in range(9, 18):
        _feed(db, "queue_depth 50", ts=100.0 + 5 * i)
    ev.evaluate(now=145.0)
    out["pending"] = _alert(ev.snapshot())
    ev.evaluate(now=156.0)
    out["firing"] = _alert(ev.snapshot())
    fired = list_events(source="SLO_TEST", label="ALERT_FIRING")
    out["fired"] = [len(fired), fired[0]["rule"]]
    for i in range(18, 30):
        _feed(db, "queue_depth 0", ts=100.0 + 5 * i)
    ev.evaluate(now=250.0)
    out["resolved"] = _alert(ev.snapshot())
    out["resolved_events"] = len(list_events(source="SLO_TEST",
                                             label="ALERT_RESOLVED"))
    out["transitions"] = ev.snapshot()["transitions"]
    return out


def pending_retracts(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    ev = _evaluator(slo, db, [_gauge_rule(slo, for_s=30.0)], env,
                    "SLO_BLIP")
    for i in range(12):
        _feed(db, "queue_depth 50", ts=100.0 + 5 * i)
    ev.evaluate(now=155.0)
    first = ev.snapshot()["alerts"][0]["state"]
    for i in range(12, 24):
        _feed(db, "queue_depth 0", ts=100.0 + 5 * i)
    ev.evaluate(now=215.0)
    return {"states": [first, ev.snapshot()["alerts"][0]["state"]],
            "fired": list_events(source="SLO_BLIP", label="ALERT_FIRING")}


def flap_suppression(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    ev = _evaluator(slo, db, [_gauge_rule(slo, for_s=0.0)], env,
                    "SLO_FLAP")
    for i in range(10):
        _feed(db, "queue_depth 50", ts=100.0 + 5 * i)
    ev.evaluate(now=145.0)
    out = {"firing": ev.firing()}
    for ts in (150.0, 155.0, 160.0):
        _feed(db, "queue_depth 0", ts=ts)
    [a] = ev.evaluate(now=160.0)
    out["dip"] = [a["state"], a["fast_value"], a["slow_value"]]
    for i in range(13, 22):
        _feed(db, "queue_depth 0", ts=100.0 + 5 * i)
    [a] = ev.evaluate(now=205.0)
    out["after"] = [a["state"], a["resolved_ts"]]
    out["transitions"] = ev.snapshot()["transitions"]
    return out


def clean_series_default_rules(tsdb, slo, list_events, env):
    db = tsdb.TSDB()
    ev = _evaluator(slo, db, None, env, "SLO_CLEAN")
    for i in range(40):
        ts = 100.0 + 2 * i
        _feed(db, [
            f'serve_ttft_ms_bucket{{le="50"}} {10 * i}',
            f'serve_ttft_ms_bucket{{le="+Inf"}} {10 * i}',
            f'serve_tpot_ms_bucket{{le="10"}} {40 * i}',
            f'serve_tpot_ms_bucket{{le="+Inf"}} {40 * i}',
            "serve_llm_waiting_seqs 2",
            "serve_llm_kv_page_utilization 0.41",
            'object_store_job_quota_rejects{job="j"} 0',
            "ray_tpu_reconstruction_failures_total 0",
            'health_loop_stalled{loop="pump"} 0',
        ], ts=ts, source="local")
        ev.evaluate(now=ts)
    snap = ev.snapshot()
    return {"evaluations": snap["evaluations"], "firing": snap["firing"],
            "rules": sorted(a["rule"] for a in snap["alerts"]),
            "states": sorted({a["state"] for a in snap["alerts"]}),
            "transitions": snap["transitions"],
            "events": list_events(source="SLO_CLEAN")}


def burn_rate(tsdb, slo, list_events, env):
    rule = slo.Rule("err-budget", "errors_total", 10.0, kind="burn_rate",
                    total_metric="requests_total", budget=0.01,
                    fast_window_s=30.0, slow_window_s=30.0)
    out = {}
    for tag, errs, total in (("hot", 14, 100), ("cool", 1, 200)):
        db = tsdb.TSDB(prefixes=())
        ev = _evaluator(slo, db, [rule], env, f"SLO_BURN_{tag}")
        _feed(db, ["errors_total 0", "requests_total 0"], ts=100.0)
        _feed(db, [f"errors_total {errs}", f"requests_total {total}"],
              ts=110.0)
        [a] = ev.evaluate(now=110.0)
        out[tag] = [a["fast_value"], a["state"]]
    return out


def metrics_text_rows(tsdb, slo, list_events, env):
    db = tsdb.TSDB(prefixes=())
    ev = _evaluator(slo, db, [_gauge_rule(slo, for_s=0.0)], env,
                    "SLO_ROWS")
    for i in range(10):
        _feed(db, "queue_depth 50", ts=100.0 + 5 * i)
    ev.evaluate(now=145.0)
    text = ev.metrics_text()
    db2 = tsdb.TSDB()
    db2.ingest(text, source="local")
    return {"rows": sorted(line for line in text.splitlines()
                           if line and not line.startswith("#")),
            "roundtrip": db2.latest("alerts_firing", {"rule": "test-queue"})}


def rule_validation(tsdb, slo, list_events, env):
    out = []
    for kw in (dict(kind="percentile"), dict(op=">="),
               dict(kind="burn_rate")):
        try:
            slo.Rule("r", "m", 1.0, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return {"errors": out}


SCENARIOS = {f.__name__: f for f in (
    increase_and_rate, avg_and_max, windowed_quantiles, scrape_errors,
    parse_exposition, bounded_series_and_points, rate_clamps_resets,
    quantile_interpolates, pending_firing_resolved, pending_retracts,
    flap_suppression, clean_series_default_rules, burn_rate,
    metrics_text_rows, rule_validation)}

# the oracle files' assertions on the JAX package's values
ORACLE = {
    "increase_and_rate": lambda r: r == {
        "increase": pytest.approx(60.0), "rate": pytest.approx(2.0),
        "single": None, "cutoff": pytest.approx(20.0)},
    "avg_and_max": lambda r: r == {
        "avg20": pytest.approx(19 / 3), "max20": pytest.approx(11.0),
        "avg_all": pytest.approx(5.0), "missing": [None, None]},
    "windowed_quantiles": lambda r: (
        r["cumulative"] == pytest.approx(100.0) and r["windowed"] <= 10.0
        and r["fallback"][0] == r["fallback"][1] and r["absent"] is None),
    "scrape_errors": lambda r: (
        r["degraded"] == ["local"] and r["engine"] and r["cleared"] == {}
        and r["boom_row"] and r["boom_tracked"]),
    "parse_exposition": lambda r: r["samples"] == [
        ["serve_x_total", {}, 3.0],
        ["serve_y", {"job": "a,b", "name": 'quo"te'}, 1.5]],
    "bounded_series_and_points": lambda r: r == {
        "series": 2, "dropped": 5, "points": [2.0, 3.0, 4.0],
        "latest": 2.0},
    "rate_clamps_resets": lambda r: r == {
        "rate": pytest.approx(10.0), "after_reset": 0.0},
    "quantile_interpolates": lambda r: r[0.5] == pytest.approx(2.0),
    "pending_firing_resolved": lambda r: (
        r["clean"][0]["state"] == "ok" and r["clean"][1] == {}
        and r["pending"]["state"] == "pending"
        and r["firing"] == {"state": "firing", "firing_since": 156.0,
                            "resolved_ts": None}
        and r["fired"] == [1, "test-queue"]
        and r["resolved"]["state"] == "ok"
        and r["resolved"]["resolved_ts"] == 250.0
        and r["resolved_events"] >= 1
        and r["transitions"] == {"test-queue:pending": 1,
                                 "test-queue:firing": 1,
                                 "test-queue:resolved": 1}),
    "pending_retracts": lambda r: r == {"states": ["pending", "ok"],
                                        "fired": []},
    "flap_suppression": lambda r: (
        r["firing"] == ["test-queue"] and r["dip"][0] == "firing"
        and r["dip"][1] < 5.0 < r["dip"][2]
        and r["after"] == ["ok", 205.0]
        and r["transitions"]["test-queue:firing"] == 1
        and r["transitions"]["test-queue:resolved"] == 1),
    "clean_series_default_rules": lambda r: (
        r["evaluations"] == 40 and r["firing"] == [] and
        r["states"] == ["ok"] and r["transitions"] == {} and
        r["events"] == [] and r["rules"]),
    "burn_rate": lambda r: (
        r["hot"] == [pytest.approx(14.0), "firing"]
        and r["cool"] == [pytest.approx(0.5), "ok"]),
    "metrics_text_rows": lambda r: (
        'alerts_firing{rule="test-queue"} 1' in r["rows"]
        and 'alert_transitions_total{rule="test-queue",to="firing"} 1'
        in r["rows"] and r["roundtrip"] == 1.0),
    "rule_validation": lambda r: all(r["errors"]),
}


class _Env:
    """A scenario's environment: monkeypatched variables and a fresh
    events directory per event source and package."""

    def __init__(self, monkeypatch, root, pkg):
        self._mp, self._root, self._pkg = monkeypatch, root, pkg

    def setenv(self, name, value):
        self._mp.setenv(name, value)

    def event_dir(self, source):
        return str(self._root / self._pkg / source)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_the_jax_package(scenario, tmp_path, monkeypatch):
    results = {}
    for pkg in PACKAGES:
        env = _Env(monkeypatch, tmp_path, pkg)
        results[pkg] = SCENARIOS[scenario](*_mods(pkg), env)
    assert ORACLE[scenario](results["ray_tpu"]), results["ray_tpu"]
    assert results["ray_tpu_torch"] == results["ray_tpu"]
