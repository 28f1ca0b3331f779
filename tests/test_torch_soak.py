"""The port's soak (`ray_tpu_torch.soak`): the scenarios of
`tests/test_soak.py`, then the port held to the JAX package: the same
fault schedules for seeds 0-9, the same ledger reports on the same
records, and the cluster mode deferred until the autoscaler is ported.

Elastic pretraining soak: recovery ledger + budgeted soak driver.

The ledger unit tests drive `RecoveryLedger` with synthetic StepStats
rings whose fault/outage/recovery timestamps are known exactly, so MTTR
assertions are arithmetic, not tolerance games. The smoke runs a real
`SoakDriver` campaign (local mode, two fault classes, ~half-minute
budget) and asserts the whole chain end to end: timed faults fire and
export artifacts, the controller walks training back to the last
gang-committed checkpoint, ingest resumes with no duplicated or skipped
batch (watermark audit), and the ledger attributes every failure to an
injected fault.
"""

import json
import os
import time

import numpy as np
import pytest

from ray_tpu.soak import RecoveryLedger as JaxLedger
from ray_tpu.soak import SoakConfig as JaxConfig
from ray_tpu.soak import SoakDriver as JaxDriver
from ray_tpu_torch.soak import RecoveryLedger, SoakConfig, SoakDriver

pytestmark = pytest.mark.soak


# ---------------------------------------------------------------------------
# synthetic StepStats rings
# ---------------------------------------------------------------------------


def _ring(times, start_step=0, total_ms=0.0):
    """One record per gang step, completing exactly at each timestamp."""
    return [{"step": start_step + i, "ts": t - total_ms / 1e3,
             "total_ms": total_ms}
            for i, t in enumerate(times)]


def _steady(t0, t1, dt):
    n = int(round((t1 - t0) / dt))
    return [t0 + i * dt for i in range(n + 1)]


def _ledger(**kw):
    kw.setdefault("rate_threshold", 0.9)
    kw.setdefault("rate_window", 4)
    return RecoveryLedger(**kw)


# ---------------------------------------------------------------------------
# MTTR arithmetic
# ---------------------------------------------------------------------------


def test_mttr_outage_exact():
    """10 Hz stepping, fault at 5.05, dead until 8.0, 10 Hz again:
    recovery is the first 4-step window after the outage — completion
    8.4 — so MTTR is exactly 3.35 s."""
    led = _ledger()
    led.add_fault("kill@train", 5.05)
    records = _ring(_steady(0.0, 5.0, 0.1)) + \
        _ring(_steady(8.0, 10.0, 0.1), start_step=100)
    [m] = led.compute_mttr(records)
    assert m["recovered"] and m["degraded"]
    assert m["pre_rate"] == pytest.approx(10.0)
    assert m["mttr_s"] == pytest.approx(8.4 - 5.05)


def test_mttr_no_outage_recovers_immediately():
    """A fault that never opens a gap (the plane absorbed it) recovers
    at the first measurable window with degraded=False."""
    led = _ledger()
    led.add_fault("hb_brownout@gcs", 5.05)
    [m] = led.compute_mttr(_ring(_steady(0.0, 10.0, 0.1)))
    assert m["recovered"] and not m["degraded"]
    # first post-fault window ends at 5.5 (4 steps past 5.1)
    assert m["mttr_s"] == pytest.approx(5.5 - 5.05)


def test_mttr_lagged_disruption():
    """A ckpt_fail-style fault: stepping continues ~1 s past the fire
    time before the attempt dies. The healthy post-fire steps must NOT
    count as recovery — the outage starts at the gap, and MTTR spans
    fault -> first healthy window after the restart."""
    led = _ledger()
    led.add_fault("ckpt_fail@train", 5.05)
    records = _ring(_steady(0.0, 6.0, 0.1)) + \
        _ring(_steady(12.0, 13.0, 0.1), start_step=200)
    [m] = led.compute_mttr(records)
    assert m["recovered"] and m["degraded"]
    assert m["mttr_s"] == pytest.approx(12.4 - 5.05)


def test_mttr_threshold_edge():
    """Post-outage stepping at 8.33 Hz sits BELOW 0.9 x 10 Hz and must
    not count as recovered; recovery lands on the first window whose
    rate crosses the threshold."""
    led = _ledger()
    led.add_fault("kill@train", 5.05)
    slow = [8.0 + 0.12 * i for i in range(5)]        # 8.33 Hz
    fast = [slow[-1] + 0.1 * i for i in range(1, 6)]  # 10 Hz
    records = _ring(_steady(0.0, 5.0, 0.1)) + \
        _ring(slow + fast, start_step=100)
    [m] = led.compute_mttr(records)
    assert m["recovered"] and m["degraded"]
    # windows: 8.48 (8.33 Hz, below), 8.58 (8.70, below),
    # 8.68 (4/0.44 = 9.09, first over threshold)
    assert m["mttr_s"] == pytest.approx(8.68 - 5.05)
    assert m["post_rate"] == pytest.approx(4 / 0.44)


def test_mttr_never_recovered():
    """Stepping never returns to threshold after the outage."""
    led = _ledger()
    led.add_fault("kill@train", 5.05)
    records = _ring(_steady(0.0, 5.0, 0.1)) + \
        _ring(_steady(8.0, 20.0, 1.0), start_step=100)   # 1 Hz limp
    [m] = led.compute_mttr(records)
    assert m["degraded"] and not m["recovered"]
    assert m["mttr_s"] is None


def test_mttr_insufficient_history():
    """No pre-fault window or no post-fault records -> unmeasurable,
    reported as not recovered rather than a crash."""
    led = _ledger()
    led.add_fault("kill@train", 5.0)
    assert led.compute_mttr([])[0]["recovered"] is False
    only_pre = _ring(_steady(0.0, 4.0, 0.1))
    assert led.compute_mttr(only_pre)[0]["recovered"] is False


def test_gang_event_collapse():
    """Two ranks record every gang step ~simultaneously; the collapse
    must yield ONE event per dispatch (at the slower rank's completion)
    so window rates measure the gang, not the record interleave —
    replayed steps after a walk-back stay separate events."""
    recs = []
    for i, t in enumerate(_steady(0.0, 5.0, 0.1)):
        recs.append({"step": i, "ts": t, "total_ms": 0.0})
        recs.append({"step": i, "ts": t + 0.004, "total_ms": 0.0})
    events = RecoveryLedger._gang_events(recs)
    assert len(events) == 51
    assert events[0] == pytest.approx(0.004)
    # walk-back replay: steps 3,4 again later -> their own events
    replay = [{"step": s, "ts": 9.0 + 0.1 * j, "total_ms": 0.0}
              for j, s in enumerate((3, 4))]
    assert len(RecoveryLedger._gang_events(recs + replay)) == 53


def test_mttr_is_rank_interleave_invariant():
    """Doubling every record (a second lockstep rank) must not change
    the measured MTTR."""
    led = _ledger()
    led.add_fault("kill@train", 5.05)
    one = _ring(_steady(0.0, 5.0, 0.1)) + \
        _ring(_steady(8.0, 10.0, 0.1), start_step=100)
    two = []
    for r in one:
        two.append(dict(r))
        two.append({**r, "ts": r["ts"] + 0.002})
    m1 = led.compute_mttr(one)[0]
    m2 = led.compute_mttr(two)[0]
    assert m2["mttr_s"] == pytest.approx(m1["mttr_s"], abs=0.01)


# ---------------------------------------------------------------------------
# attribution / resume audits
# ---------------------------------------------------------------------------


def test_failure_attribution():
    led = _ledger()
    led.add_fault("kill@train", 100.0)
    led.add_failure(130.0, "worker died")            # within 60 s window
    led.add_failure(300.0, "IndexError: oops")        # a REAL bug
    led.add_failure(400.0, "ChaosError: chaos: injected persist failure")
    injected, non_injected = led.classify_failures()
    assert len(injected) == 2
    assert [f["ts"] for f in non_injected] == [300.0]
    with pytest.raises(AssertionError, match="non-injected"):
        led.assert_clean(records=[])


def test_resume_accounting():
    led = _ledger()
    led.add_commit(step=128, ts=10.0)
    led.add_commit(step=256, ts=20.0)
    led.add_restore(resumed_from=256, ts=25.0)
    assert led.resume_mismatches() == []
    led.add_restore(resumed_from=128, ts=26.0)   # stale checkpoint!
    bad = led.resume_mismatches()
    assert len(bad) == 1 and bad[0]["expected_step"] == 256
    with pytest.raises(AssertionError, match="resume accounting"):
        led.assert_clean(records=[])


def test_report_mttr_by_class():
    led = _ledger()
    for ts in (5.05, 25.05):
        led.add_fault("kill@train", ts)
    led.add_fault("data_stall@train", 45.05)
    records = []
    for seg in ((0.0, 5.0), (8.0, 25.0), (28.0, 45.0), (47.0, 60.0)):
        records += _ring(_steady(*seg, 0.1),
                         start_step=len(records), total_ms=50.0)
    rep = led.report(records)
    assert rep["faults_injected"] == 3
    assert rep["recovered_count"] == 3
    kill = rep["mttr_by_class"]["kill@train"]
    assert kill["count"] == 2 and kill["recovered"] == 2
    # both kill outages are ~3 s dead + window tail
    assert kill["mttr_p50_s"] == pytest.approx(8.4 - 5.05)
    assert kill["mttr_p95_s"] == pytest.approx(28.4 - 25.05)
    down = rep["downtime_breakdown_s"]
    assert down["total_s"] > down["dead_s"] > 0


def test_ledger_validation():
    with pytest.raises(ValueError, match="rate_threshold"):
        RecoveryLedger(rate_threshold=1.5)
    with pytest.raises(ValueError, match="rate_window"):
        RecoveryLedger(rate_window=0)
    with pytest.raises(ValueError, match="min_outage"):
        RecoveryLedger(min_outage_s=0.0)


def test_load_chaos_artifacts(tmp_path):
    art = {"role": "train", "pid": 4242, "spec": "seed=1;at=5:kill@train",
           "timed_fired": [
               {"fault": "kill", "offset": 5.0, "arg": 0.0, "ts": 105.0}]}
    (tmp_path / "chaos-train-4242.json").write_text(json.dumps(art))
    (tmp_path / "chaos-gcs-1.json").write_text("{not json")   # skipped
    led = _ledger()
    assert led.load_chaos_artifacts(str(tmp_path)) == 1
    assert led.faults[0].fault_class == "kill@train"
    assert led.faults[0].ts == 105.0


# ---------------------------------------------------------------------------
# schedule generation
# ---------------------------------------------------------------------------


def test_schedule_spec_deterministic_and_slotted():
    cfg = SoakConfig(budget_s=120.0, seed=3, faults_per_class=2,
                     fault_classes=("ckpt_fail@train", "data_stall@train",
                                    "kill@train", "hb_brownout@gcs"))
    spec1 = SoakDriver(cfg).schedule_spec()
    spec2 = SoakDriver(cfg).schedule_spec()
    assert spec1 == spec2                       # pure function of config
    assert spec1 != SoakDriver(
        SoakConfig(budget_s=120.0, seed=4, faults_per_class=2,
                   fault_classes=cfg.fault_classes)).schedule_spec()
    body = spec1.split("at=", 1)[1]
    offsets = [float(e.split(":", 1)[0]) for e in body.split("|")]
    assert len(offsets) == 8
    # disjoint slots: strictly increasing, inside [warmup, 2/3 budget]
    assert offsets == sorted(offsets)
    assert offsets[0] >= cfg.fault_warmup_s
    assert offsets[-1] <= 120.0 * 2 / 3


def test_schedule_spec_unknown_class():
    with pytest.raises(ValueError, match="unknown fault class"):
        SoakDriver(SoakConfig(
            fault_classes=("meteor_strike@dc",))).schedule_spec()


def test_timed_epoch_anchor_expiry(monkeypatch):
    """The port's copy of `test_chaos.py::test_timed_epoch_anchor_expiry`:
    with a timestamp epoch, an entry already past its slot at arm
    expires and a still-future one fires at its wall-clock slot."""
    from ray_tpu_torch._private import fault_injection as fi

    monkeypatch.delenv(fi.LOG_ENV, raising=False)
    monkeypatch.setenv(fi.EPOCH_ENV, repr(time.time() - 10.0))
    p = fi.FaultPlan("seed=3;at=5:data_stall:1|10.3:ckpt_fail")
    p.arm_timed("train")
    time.sleep(0.7)
    assert [f["fault"] for f in p.timed_fired] == ["ckpt_fail"]
    assert any(site == "timed.data_stall" and "expired" in decision
               for site, _, decision in p.schedule)
    p._timed_stop.set()


def test_timed_epoch_file_waits_for_the_file(tmp_path, monkeypatch):
    """`RAY_TPU_CHAOS_EPOCH=@<path>` (the soak's form): armed entries
    fire nothing until the file holds the epoch, then count their
    offsets from its timestamp; a plan armed once those slots passed
    records them as expired."""
    from ray_tpu_torch._private import fault_injection as fi

    epoch = tmp_path / "epoch"
    monkeypatch.delenv(fi.LOG_ENV, raising=False)
    monkeypatch.setenv(fi.EPOCH_ENV, "@" + str(epoch))
    p = fi.FaultPlan("seed=3;at=0.2:data_stall:1|0.4:ckpt_fail")
    p.arm_timed("train")
    time.sleep(0.8)
    assert p.timed_fired == []
    t0 = time.time()
    epoch.write_text(repr(t0))
    time.sleep(1.0)
    fired = p.timed_fired
    assert [f["fault"] for f in fired] == ["data_stall", "ckpt_fail"]
    for f in fired:
        assert 0 <= f["ts"] - (t0 + f["offset"]) < 0.5, (f, t0)
    p._timed_stop.set()

    epoch.write_text(repr(time.time() - 10.0))
    q = fi.FaultPlan("seed=3;at=0.2:data_stall:1|12:ckpt_fail")
    q.arm_timed("train")
    time.sleep(0.3)
    assert q.timed_fired == []
    assert [d for site, _, d in q.schedule
            if site == "timed.data_stall"] == ["expired:t+0.2"]
    q._timed_stop.set()


def test_budget_leaves_out_a_restarts_outage(tmp_path, monkeypatch):
    """The controller loop against a scripted executor on a fake clock:
    the budget starts at the gang's first report (written to the epoch
    file) and a restart's outage moves its end, so the attempt after a
    late failure still runs long enough for the ledger to measure it."""
    from types import SimpleNamespace

    from ray_tpu_torch.soak import driver as drv
    from ray_tpu_torch.train._internal import backend_executor as be

    clock = [1000.0]
    stop_file, epoch_file = tmp_path / "stop", tmp_path / "epoch"
    reports = []

    class Executor:
        attempts = 0

        def __init__(self, *args, **kwargs):
            Executor.attempts += 1
            self.attempt = Executor.attempts

        def start(self):
            pass

        def start_training(self, *args, **kwargs):
            if self.attempt == 2:
                clock[0] += 12.0              # the new workers' start

        def get_next_results(self, timeout):
            if stop_file.exists():
                return None
            clock[0] += 5.0
            if self.attempt == 1 and clock[0] >= 1020.0:
                raise be.TrainingFailedError("chaos: ckpt_fail")
            reports.append((self.attempt, clock[0]))
            return [{"world_rank": 0, "metrics": {
                "rank": 0, "step": len(reports), "epoch": 0,
                "batch_in_epoch": 0, "last_first_id": -1,
                "resumed_from": None}}]

        def commit_gang_checkpoint(self):
            pass

        def shutdown(self):
            pass

    monkeypatch.setattr(be, "BackendExecutor", Executor)
    monkeypatch.setattr(drv, "time", SimpleNamespace(time=lambda: clock[0]))
    res = SoakDriver(SoakConfig(budget_s=30.0))._drive_training(
        None, [], RecoveryLedger(), str(tmp_path), str(stop_file),
        str(epoch_file))
    assert float(epoch_file.read_text()) == 1005.0
    assert res["attempts"] == 1 and res["first_report_s"] == 5.0
    # 30 s from 1005 plus the outage from the failure (1020) to the next
    # attempt's first report (1037): the end moves from 1035 to 1052
    assert reports == [(1, 1005.0), (1, 1010.0), (1, 1015.0),
                       (2, 1037.0), (2, 1042.0), (2, 1047.0),
                       (2, 1052.0)]


def test_soak_config_validation():
    with pytest.raises(ValueError, match="unknown soak mode"):
        SoakDriver(SoakConfig(mode="galactic"))


# ---------------------------------------------------------------------------
# the tier-1 smoke: a real (compressed) soak campaign
# ---------------------------------------------------------------------------


def test_soak_smoke_local(tmp_path):
    """~Half-minute local soak with two fault classes. Asserts the full
    chain: both timed faults fire and export artifacts, the injected
    persist failure walks training back to the last gang-committed
    checkpoint, ingest resumes with no duplicated/skipped batch, and the
    ledger reports clean attribution + bit-exact resume accounting."""
    # seed 3 schedules the (harmless) stall first and the walk-back
    #-inducing persist failure second, so neither fault lands inside
    # the other's recovery window on a slow box
    cfg = SoakConfig(
        budget_s=30.0, mode="local", seed=3,
        fault_classes=("ckpt_fail@train", "data_stall@train"),
        workdir=str(tmp_path / "soak"), keep_workdir=True)
    res = SoakDriver(cfg).run()
    led = res["ledger"]

    assert led["faults_injected"] == 2
    assert set(led["mttr_by_class"]) == {"ckpt_fail@train",
                                         "data_stall@train"}
    assert led["recovered_count"] == 2
    for m in led["recoveries"]:
        assert m["mttr_s"] is not None and m["mttr_s"] > 0
    # zero NON-injected failures; the persist failure is attributed
    assert led["non_injected_failures"] == []
    assert led["failures_observed"] == led["injected_failures"] >= 1
    # walk-back happened and resumed bit-exactly from a gang commit
    assert led["commits"] > 0
    assert led["restores"] >= 1
    assert led["resume_mismatches"] == []
    assert res["post_restore_checks"] >= 1
    # ingest offsets: no duplicated or skipped batch across the restart
    assert res["watermark_checks"] > 0
    assert res["watermark_errors"] == []
    # throughput + progress
    assert res["final_step"] > 0 and res["steps_per_s"] > 0
    # the soak's clock started at the gang's first report
    assert 0 < res["first_report_s"] < res["elapsed_s"]
    assert res["ingest_tokens_per_s"] > 0
    # every faulted process exported a replayable post-mortem artifact
    assert res["chaos_artifacts"]
    for name in res["chaos_artifacts"]:
        art = json.loads(
            (tmp_path / "soak" / "chaos" / name).read_text())
        assert art["spec"] == res["spec"]
    # downtime breakdown covers the recovery windows
    down = led["downtime_breakdown_s"]
    assert down["total_s"] >= down["dead_s"] >= 0
    # the run restored the env it scoped
    for var in ("RAY_TPU_CHAOS", "RAY_TPU_CHAOS_LOG",
                "RAY_TPU_CHAOS_EPOCH", "RAY_TPU_TRACE"):
        assert os.environ.get(var) is None


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_schedule_spec_matches_jax(seed):
    for kw in ({}, dict(budget_s=120.0, faults_per_class=2,
                        fault_classes=("ckpt_fail@train",
                                       "data_stall@train", "kill@train",
                                       "hb_brownout@gcs",
                                       "drop_objects@raylet"))):
        got = SoakDriver(SoakConfig(seed=seed, **kw)).schedule_spec()
        assert got == JaxDriver(JaxConfig(seed=seed, **kw)).schedule_spec()


def _ledger_scenario(cls, tmp_path):
    """One ledger of `cls` fed the same faults, failures, commits,
    restores and chaos artifacts; returns its report on one ring."""
    led = cls(rate_threshold=0.9, rate_window=4)
    for ts in (5.05, 25.05):
        led.add_fault("kill@train", ts)
    led.add_fault("data_stall@train", 45.05)
    led.add_fault("ckpt_fail@train", 52.0)
    led.add_failure(5.5, "ChaosError: injected kill")
    led.add_failure(25.4, "worker died")
    led.add_failure(53.0, "ChaosError: checkpoint persist failed")
    led.add_failure(2.0, "OSError: disk on fire")  # before any fault
    for step, ts in ((64, 4.0), (128, 20.0), (256, 40.0)):
        led.add_commit(step, ts, f"/ckpt/{step}")
    led.add_restore(64, 8.5)
    led.add_restore(128, 28.5)
    led.add_restore(200, 55.0)
    led.load_chaos_artifacts(str(tmp_path))
    records = []
    for seg in ((0.0, 5.0), (8.0, 25.0), (28.0, 45.0), (47.0, 52.0),
                (55.5, 70.0)):
        records += _ring(_steady(*seg, 0.1),
                         start_step=len(records), total_ms=50.0)
    # two ranks' records of each gang step, interleaved
    records = [dict(r, rank=k) for r in records for k in (0, 1)]
    return led.report(records)


def test_ledger_report_matches_jax(tmp_path):
    art = {"role": "train", "pid": 4242,
           "spec": "seed=1;at=60:kill@train",
           "timed_fired": [
               {"fault": "kill", "offset": 60.0, "arg": 0.0, "ts": 60.2}]}
    (tmp_path / "chaos-train-4242.json").write_text(json.dumps(art))
    got = _ledger_scenario(RecoveryLedger, tmp_path)
    want = _ledger_scenario(JaxLedger, tmp_path)
    assert want["faults_injected"] == 5
    assert want["non_injected_failures"]
    assert want["resume_mismatches"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_cluster_mode_is_deferred():
    """The JAX package's cluster mode needs the autoscaler, which the
    port has not yet: it raises, naming the slice that brings it."""
    with pytest.raises(NotImplementedError, match="autoscaler.*S4f"):
        SoakDriver(SoakConfig(mode="cluster"))
    # the JAX package accepts the same config
    JaxDriver(JaxConfig(mode="cluster"))
