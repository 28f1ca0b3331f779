"""Wall-clock-budgeted soak driver: every plane composed end to end.

One `SoakDriver.run()` is a miniature continuous-pretraining campaign:

  * Data plane — a deterministic token dataset, split into per-rank
    static shards consumed through `DataIterator.iter_batches` with
    bounded prefetch (backpressure) and `start_batch_index` resume.
  * Train plane — `TrainStepRunner` fold-steps inside a gang of train
    workers, reporting gang-durable checkpoints on a cadence; the
    checkpoint payload carries each rank's ingest offset so elastic
    restore continues the shard exactly where the committed step left
    off.
  * Chaos plane — a seeded, timed `FaultPlan` schedule (`at=` grammar)
    scoped per role, exported per process under RAY_TPU_CHAOS_LOG.
  * Control plane — in `cluster` mode a real multi-raylet cluster with
    the autoscaler running; a timed raylet kill is replaced by a fresh
    provider node while the controller walks training back to the last
    gang-committed checkpoint.
  * Observability — RAY_TPU_TRACE=1 for the whole run; the recovery
    ledger measures MTTR per fault class from the merged StepStats
    shards (which survive worker death) and audits failure attribution,
    resume accounting and batch-index watermarks.

The port's copy of `ray_tpu/soak/driver.py`. Its train loop is torch on
the CPU (`TrainStepRunner(..., device="cpu")` under
`TorchConfig(distributed="off", platform="cpu")`), as the JAX soak pins
its workers to the CPU: the soak checks that the runtime, Data, the
train plane, chaos and the ledger work together, not the card. One
difference from the JAX driver: the soak's clock (the chaos epoch the
fault offsets count from, and the budget) starts at the gang's first
report, not at the run's start, and the budget leaves out each restart's
outage. A fresh torch worker takes seconds to reach its first step: a
fault that fires before it leaves the ledger no pre-fault rate window,
and a restart that ends near the budget's end leaves it no post-fault
one. `first_report_s` in the result says how long the start took. In
`cluster` mode the head's raylet, which the driver attaches to, arms no
raylet-scoped fault, and the autoscaler starts at the gang's first
report: a `kill@raylet` always takes a worker node that holds ranks, and
the node that replaces it is the autoscaler's. The tests run
`mode="local"` with two fault classes in under a minute, and a short
`mode="cluster"` soak whose raylet kill an autoscaled node replaces.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import fault_injection as _fi

logger = logging.getLogger(__name__)

# fault class -> spec-entry template; {t} = offset seconds, {arg} from
# SoakConfig knobs. Classes are named as the ledger reports them:
# "<fault>@<role>".
_FAULT_TEMPLATES = {
    "ckpt_fail@train": "{t}:ckpt_fail",
    "data_stall@train": "{t}:data_stall:{stall_s}",
    "kill@train": "{t}:kill",
    "kill@raylet": "{t}:kill",
    "hb_brownout@gcs": "{t}:hb_brownout:{brownout_s}",
    "crash_loop@raylet": "{t}:crash_loop:2",
    "drop_objects@raylet": "{t}:drop_objects:{drop_frac}",
}


@dataclasses.dataclass
class SoakConfig:
    budget_s: float = 30.0
    mode: str = "local"                  # "local" | "cluster"
    seed: int = 0
    num_workers: int = 2
    fault_classes: Tuple[str, ...] = ("ckpt_fail@train",
                                      "data_stall@train")
    faults_per_class: int = 1
    # first fault no earlier than this after the gang's first report
    # (the ledger needs a pre-fault rate window) and none in the final
    # drain third of the budget
    fault_warmup_s: float = 6.0
    stall_s: float = 2.0
    brownout_s: float = 3.0
    drop_frac: float = 0.5               # drop_objects sweep fraction
    # data plane (epoch = rows / num_workers / batch_size = 512 batches
    # at the defaults, so commits land mid-epoch and resume offsets are
    # exercised at non-zero values)
    rows: int = 65536
    num_blocks: int = 64
    batch_size: int = 64
    dim: int = 64
    prefetch_batches: int = 2
    # train plane: one report ~ report_every * steps_per_call steps;
    # the defaults keep the checkpoint cadence coarse enough that a
    # restart outage dwarfs it
    steps_per_call: int = 16             # fold_steps K
    report_every: int = 8                # dispatches per report
    ckpt_every: int = 4                  # reports per gang checkpoint
    max_failures: int = 16
    result_timeout_s: float = 120.0
    # ledger
    rate_threshold: float = 0.9
    rate_window: int = 6
    # environment
    num_cpus: int = 8                    # local mode logical CPUs
    cluster_nodes: int = 2               # cluster mode worker nodes
    cpus_per_node: float = 4.0
    autoscaler_interval_s: float = 1.0
    workdir: Optional[str] = None        # default: mkdtemp
    keep_workdir: bool = False


class StaticShards:
    """Deterministic per-rank shards with exact resume semantics.

    `BackendExecutor._assign_dataset_shards` calls `streaming_split(n)`;
    here that returns one plain `DataIterator` per rank over a STATIC
    round-robin block split (`Dataset.split`) — unlike a true streaming
    split there is no dynamic rebalancing, so rank r's batch k has the
    same content in every attempt and `start_batch_index` resume is
    content-exact, which is what the watermark audit asserts."""

    def __init__(self, dataset, num_workers: int):
        self._shards = dataset.split(num_workers)
        self._refs = [s._materialized for s in self._shards]

    def streaming_split(self, n: int):
        from ray_tpu_torch.data.iterator import DataIterator

        if n != len(self._refs):
            raise ValueError(
                f"shard count mismatch: split for {len(self._refs)} "
                f"workers, asked for {n}")
        return [DataIterator(list(refs)) for refs in self._refs]

    def shard_ids(self, rank: int) -> np.ndarray:
        """The rank's full id sequence (driver-side, for the expected
        watermark map)."""
        import ray_tpu_torch

        blocks = [ray_tpu_torch.get(r, timeout=60) for r in self._refs[rank]]
        return np.concatenate([np.asarray(b["id"]) for b in blocks])


def _soak_train_loop(config: Dict[str, Any]) -> None:
    """Per-rank soak loop: ingest -> fold-steps -> cadenced gang
    checkpoints, with ingest offsets carried in the checkpoint payload.
    All ranks run in lockstep (same dispatch/report cadence), so the
    canonical rank-0 payload's offsets apply to every rank."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.air.checkpoint import Checkpoint

    B = int(config["batch_size"])
    K = int(config["steps_per_call"])
    dim = int(config["dim"])
    report_every = int(config["report_every"])
    ckpt_every = int(config["ckpt_every"])
    stop_file = config["stop_file"]

    ctx = train.get_context()
    rank = ctx.get_world_rank()
    shard = train.get_dataset_shard("train")

    step = 0
    epoch = 0
    batch_in_epoch = 0
    resumed_from: Optional[int] = None
    w = np.zeros((dim,), np.float32)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        payload = ckpt.to_dict()
        w = np.asarray(payload["w"], np.float32)
        step = int(payload["step"])
        epoch = int(payload["epoch"])
        batch_in_epoch = int(payload["batch_in_epoch"])
        resumed_from = int(payload["step"])

    def step_fn(carry, batch):
        # toy LM step: EMA of the mean token embedding; cheap enough for
        # a small host, real enough to make resume bit-exactness matter
        g = torch.mean(batch, dim=0)
        new = carry * 0.999 + 0.001 * g
        return new, torch.sum(new)

    runner = train.TrainStepRunner(
        step_fn, steps_per_call=K, donate_carry=False,
        tokens_per_step=B * dim, flops_per_step=float(2 * B * dim),
        device="cpu")

    last_first_id = -1

    def batch_stream():
        nonlocal epoch, batch_in_epoch, last_first_id
        while True:
            it = shard.iter_batches(
                batch_size=B, drop_last=True,
                prefetch_batches=int(config["prefetch_batches"]),
                start_batch_index=batch_in_epoch)
            got = False
            for b in it:
                got = True
                ids = np.asarray(b["id"])
                last_first_id = int(ids[0])
                batch_in_epoch += 1
                # tokens derived from ids: content is a pure function of
                # the batch index, so watermarks pin the data too
                yield torch.from_numpy(
                    ids[:, None].astype(np.float32)
                    * np.ones((1, dim), np.float32))
            if not got and batch_in_epoch == 0:
                raise RuntimeError("soak shard is empty")
            epoch += 1
            batch_in_epoch = 0

    stream = batch_stream()
    carry = torch.from_numpy(w)
    reports = 0
    while True:
        for _ in range(report_every):
            carry, _aux = runner.run(carry, stream)
            step += K
        reports += 1
        stop = os.path.exists(stop_file)
        metrics = {
            "step": step,
            "rank": rank,
            "epoch": epoch,
            "batch_in_epoch": batch_in_epoch,
            "last_first_id": last_first_id,
            "resumed_from": resumed_from,
        }
        if reports % ckpt_every == 0 or stop:
            payload = {
                "w": carry.numpy().copy(),
                "step": step,
                "epoch": epoch,
                "batch_in_epoch": batch_in_epoch,
            }
            train.report(metrics, checkpoint=Checkpoint.from_dict(payload))
        else:
            train.report(metrics)
        if stop:
            return


class SoakDriver:
    def __init__(self, config: Optional[SoakConfig] = None):
        self.cfg = config or SoakConfig()
        if self.cfg.mode not in ("local", "cluster"):
            raise ValueError(f"unknown soak mode {self.cfg.mode!r}")

    # -- seeded timed schedule ------------------------------------------

    def schedule_spec(self) -> str:
        """Seeded wall-clock fault schedule: `faults_per_class` firings
        per class, spread over the middle of the budget (after the
        warmup the pre-fault rate window needs, clear of the drain
        tail). The [warmup, 2/3*budget] span is partitioned into one
        disjoint slot per firing and each offset is drawn uniformly
        WITHIN its slot — seeded jitter without fault pile-ups, so each
        recovery window gets measured clear of the next fault (two
        faults landing inside one outage would fold into a single
        recovery and starve the later class of its MTTR sample). Pure
        function of (seed, config)."""
        cfg = self.cfg
        rng = random.Random(f"soak:{cfg.seed}")
        lo = cfg.fault_warmup_s
        hi = max(lo + 1.0, cfg.budget_s * (2.0 / 3.0))
        planned = []
        for cls in cfg.fault_classes:
            template = _FAULT_TEMPLATES.get(cls)
            if template is None:
                raise ValueError(f"unknown fault class {cls!r} "
                                 f"(known: {sorted(_FAULT_TEMPLATES)})")
            for _ in range(cfg.faults_per_class):
                planned.append((cls, template))
        slot = (hi - lo) / len(planned)
        # interleave classes across the span (shuffled order, seeded) so
        # repeated firings of one class don't all cluster at one end
        rng.shuffle(planned)
        entries = []
        for i, (cls, template) in enumerate(planned):
            role = cls.split("@", 1)[1]
            t = round(lo + slot * (i + rng.uniform(0.1, 0.9)), 1)
            entry = template.format(t=t, stall_s=cfg.stall_s,
                                    brownout_s=cfg.brownout_s,
                                    drop_frac=cfg.drop_frac)
            entries.append(f"{entry}@{role}")
        return f"seed={cfg.seed};at=" + "|".join(entries)

    # -- the run --------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        import tempfile

        cfg = self.cfg
        workdir = cfg.workdir or tempfile.mkdtemp(prefix="ray_tpu_soak_")
        os.makedirs(workdir, exist_ok=True)
        chaos_dir = os.path.join(workdir, "chaos")
        trace_dir = os.path.join(workdir, "trace")
        storage = os.path.join(workdir, "results")
        stop_file = os.path.join(workdir, "stop")
        epoch_file = os.path.join(workdir, "epoch")
        for d in (chaos_dir, trace_dir, storage):
            os.makedirs(d, exist_ok=True)

        spec = self.schedule_spec()
        logger.info("soak schedule: %s", spec)
        env = {
            _fi.ENV_VAR: spec,
            _fi.LOG_ENV: chaos_dir,
            # anchor timed offsets to the gang's first report (written to
            # epoch_file then): restarted attempts re-arm the plan but
            # keep the original wall-clock schedule
            _fi.EPOCH_ENV: "@" + epoch_file,
            "RAY_TPU_TRACE": "1",
            "RAY_TPU_TRACE_DIR": trace_dir,
        }
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return self._run_inner(chaos_dir, trace_dir, storage,
                                   stop_file, epoch_file, spec)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            if not cfg.keep_workdir and cfg.workdir is None:
                shutil.rmtree(workdir, ignore_errors=True)

    def _run_inner(self, chaos_dir: str, trace_dir: str, storage: str,
                   stop_file: str, epoch_file: str, spec: str
                   ) -> Dict[str, Any]:
        import ray_tpu_torch
        from ray_tpu_torch import data as rt_data
        from ray_tpu_torch.soak.ledger import RecoveryLedger

        cfg = self.cfg
        cluster = None
        autoscaler = None
        provider = None
        try:
            if cfg.mode == "cluster":
                from ray_tpu_torch._private.node import Cluster
                from ray_tpu_torch.autoscaler import (Autoscaler,
                                                      FakeMultiNodeProvider,
                                                      NodeType)

                # head too small for the gang: ranks land on the worker
                # nodes, so a timed raylet kill hits a gang member. The
                # GCS arms its faults; the head's raylet arms none
                cluster = Cluster(object_store_memory=256 * 1024 * 1024)
                chaos = os.environ.pop(_fi.ENV_VAR)
                try:
                    cluster.add_node({"CPU": 1.0})
                finally:
                    os.environ[_fi.ENV_VAR] = chaos
                for _ in range(cfg.cluster_nodes):
                    cluster.add_node({"CPU": cfg.cpus_per_node})
                ray_tpu_torch.init(address=cluster.gcs_addr)
                provider = FakeMultiNodeProvider(cluster)
                autoscaler = Autoscaler(
                    cluster.gcs_addr, provider,
                    [NodeType("soak", {"CPU": cfg.cpus_per_node})],
                    max_workers=cfg.cluster_nodes + 4,
                    idle_timeout_s=10 * cfg.budget_s,
                    update_interval_s=cfg.autoscaler_interval_s)
            else:
                ray_tpu_torch.init(num_cpus=cfg.num_cpus,
                                   object_store_memory=256 * 1024 * 1024)

            ds = rt_data.range(cfg.rows, parallelism=cfg.num_blocks)
            shards = StaticShards(ds, cfg.num_workers)
            expected_ids = [shards.shard_ids(r)
                            for r in range(cfg.num_workers)]

            ledger = RecoveryLedger(rate_threshold=cfg.rate_threshold,
                                    rate_window=cfg.rate_window)
            # the autoscaler starts with the soak's clock, once the gang
            # is placed: the demand of the blocks' tasks, or of the gang's
            # group before its node reports free CPUs, would launch a
            # node that a raylet kill could take instead of the ranks'
            result = self._drive_training(
                shards, expected_ids, ledger, storage, stop_file,
                epoch_file,
                on_first_report=autoscaler and autoscaler.start)
            if provider is not None:
                # nodes the autoscaler launched (it retires none within
                # the run: its idle timeout is ten budgets)
                result["autoscaled_nodes"] = len(
                    provider.non_terminated_nodes())
        finally:
            if autoscaler is not None:
                autoscaler.stop()
            try:
                ray_tpu_torch.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            if cluster is not None:
                cluster.shutdown()

        # MTTR source: the flight recorder's merged shards — written by
        # every (possibly dead) worker process under RAY_TPU_TRACE
        from ray_tpu_torch.util import step_profiler

        records = step_profiler.collect(trace_dir)
        ledger.load_chaos_artifacts(chaos_dir)
        report = ledger.report(records)
        result.update(self._throughput(records, result))
        result["spec"] = spec
        result["chaos_artifacts"] = sorted(
            os.path.basename(p)
            for p in os.listdir(chaos_dir) if p.startswith("chaos-"))
        result["ledger"] = report
        return result

    def _drive_training(self, shards: "StaticShards",
                        expected_ids: List[np.ndarray],
                        ledger, storage: str, stop_file: str,
                        epoch_file: str,
                        on_first_report: Optional[Callable[[], Any]] = None
                        ) -> Dict[str, Any]:
        """The controller loop: mirrors DataParallelTrainer's retry
        loop, instrumented with ledger hooks (failure/commit/restore
        timestamps) and the per-report watermark audit. The gang's first
        report starts the soak's clock: its time goes to `epoch_file`
        (the chaos epoch) and the budget runs from it, less the outages
        from a failure to the next attempt's first report."""
        from ray_tpu_torch.air.checkpoint import Checkpoint
        from ray_tpu_torch.air.config import ScalingConfig
        from ray_tpu_torch.train._internal.backend_executor import (
            BackendExecutor, TrainingFailedError)
        from ray_tpu_torch.train._internal.checkpoint_manager import (
            CheckpointManager, IncompleteCheckpointError)
        from ray_tpu_torch.train.backend import TorchConfig
        from ray_tpu_torch.train.trainer import DataParallelTrainer

        cfg = self.cfg
        loop_config = {
            "batch_size": cfg.batch_size,
            "steps_per_call": cfg.steps_per_call,
            "dim": cfg.dim,
            "report_every": cfg.report_every,
            "ckpt_every": cfg.ckpt_every,
            "prefetch_batches": cfg.prefetch_batches,
            "stop_file": stop_file,
        }
        from ray_tpu_torch._private import health as health_mod

        # deadman over the controller loop: one beat per result round.
        # Backlog is constant 1 while training is live — a report is
        # always owed — so a stall anywhere under get_next_results
        # (e.g. an injected data_stall freezing the gang) shows up as a
        # frozen counter and gets the driver stack captured.
        drive_probe = health_mod.watch_loop("soak_driver",
                                            backlog_fn=lambda: 1)
        health_mod.ensure_watchdog(source="SOAK")

        ckpt_manager = CheckpointManager()
        t_start = time.time()
        t_epoch: Optional[float] = None
        t_end = float("inf")
        attempts = 0
        restore: Optional[Checkpoint] = None
        watermark_errors: List[Dict[str, Any]] = []
        watermark_checks = 0
        post_restore_checks = 0
        reports_seen = 0
        last_step = 0
        pending_restore = False
        down_since = 0.0

        def audit(results: List[Dict[str, Any]]) -> None:
            nonlocal watermark_checks
            for r in results:
                m = r["metrics"]
                rank, k = m["rank"], m["batch_in_epoch"]
                if k <= 0:
                    continue
                ids = expected_ids[rank]
                exp = int(ids[(k - 1) * cfg.batch_size])
                watermark_checks += 1
                if m["last_first_id"] != exp:
                    watermark_errors.append(
                        {"rank": rank, "epoch": m["epoch"],
                         "batch_in_epoch": k,
                         "got": m["last_first_id"], "expected": exp})

        while True:
            executor = BackendExecutor(
                TorchConfig(distributed="off", platform="cpu"),
                ScalingConfig(num_workers=cfg.num_workers),
                experiment_name="soak",
                storage_path=storage,
                trial_id=f"attempt{attempts}",
            )
            try:
                executor.start()
                executor.start_training(
                    _soak_train_loop, config=loop_config,
                    datasets={"train": shards}, checkpoint=restore)
                while True:
                    drive_probe.beat()
                    results = executor.get_next_results(
                        timeout=cfg.result_timeout_s)
                    if results is None:
                        break
                    now = time.time()
                    if pending_restore:
                        # the budget counts the gang's running time: a
                        # restart's outage moves the end, so a recovery
                        # near it still gets measured
                        t_end += now - down_since
                    if t_epoch is None:
                        t_epoch, t_end = now, now + cfg.budget_s
                        tmp = epoch_file + ".tmp"
                        with open(tmp, "w") as f:
                            f.write(repr(now))
                        os.replace(tmp, epoch_file)
                        if on_first_report is not None:
                            on_first_report()
                    reports_seen += 1
                    audit(results)
                    lead = min(results, key=lambda r: r["world_rank"])
                    last_step = max(last_step, lead["metrics"]["step"])
                    if pending_restore:
                        ledger.add_restore(
                            lead["metrics"]["resumed_from"], now)
                        if lead["metrics"]["resumed_from"] is not None:
                            post_restore_checks += 1
                        pending_restore = False
                    committed = None
                    if lead.get("checkpoint_path") and \
                            lead["world_rank"] == 0:
                        committed = Checkpoint(lead["checkpoint_path"])
                        committed._persisted = True
                        try:
                            ckpt_manager.register_checkpoint(
                                committed, lead["metrics"],
                                require_usable=True)
                        except IncompleteCheckpointError as e:
                            raise TrainingFailedError(str(e)) from e
                    executor.commit_gang_checkpoint()
                    if committed is not None:
                        ledger.add_commit(lead["metrics"]["step"],
                                          time.time(),
                                          lead["checkpoint_path"])
                    if now >= t_end and not os.path.exists(stop_file):
                        with open(stop_file, "w") as f:
                            f.write("budget exhausted\n")
                executor.shutdown()
                break
            except TrainingFailedError as e:
                executor.shutdown()
                down_since = time.time()
                ledger.add_failure(down_since, str(e))
                attempts += 1
                if attempts > cfg.max_failures:
                    raise
                restore = DataParallelTrainer._latest_usable_checkpoint(
                    ckpt_manager) or restore
                pending_restore = True
                if time.time() >= t_end:
                    # budget gone mid-failure: run one short drain
                    # attempt so the final state is a clean stop
                    with open(stop_file, "w") as f:
                        f.write("budget exhausted\n")
            except BaseException:
                executor.shutdown()
                raise

        health_mod.unwatch_loop("soak_driver")
        return {
            "mode": cfg.mode,
            "seed": cfg.seed,
            "budget_s": cfg.budget_s,
            "elapsed_s": round(time.time() - t_start, 3),
            "first_report_s": (None if t_epoch is None
                               else round(t_epoch - t_start, 3)),
            "attempts": attempts,
            "reports": reports_seen,
            "final_step": last_step,
            "watermark_checks": watermark_checks,
            "watermark_errors": watermark_errors,
            "post_restore_checks": post_restore_checks,
        }

    @staticmethod
    def _throughput(records: List[Dict[str, Any]],
                    result: Dict[str, Any]) -> Dict[str, Any]:
        if not records:
            return {"steps_per_s": 0.0, "ingest_tokens_per_s": 0.0,
                    "step_records": 0}
        t0 = min(r["ts"] for r in records)
        t1 = max(r["ts"] + r.get("total_ms", 0.0) / 1e3 for r in records)
        elapsed = max(1e-6, t1 - t0)
        # every rank records every gang step; final_step is the gang
        # step count, so the gang rate divides out world size
        gang_steps = result.get("final_step", 0)
        return {
            "steps_per_s": round(gang_steps / elapsed, 3),
            "ingest_tokens_per_s": round(
                sum(r.get("tokens", 0) for r in records) / elapsed, 1),
            "step_records": len(records),
        }


def run_soak(config: Optional[SoakConfig] = None) -> Dict[str, Any]:
    """Run one soak campaign; returns the result dict (throughput +
    recovery ledger report)."""
    return SoakDriver(config).run()
