"""Trainers: BaseTrainer + DataParallelTrainer (TorchTrainer), and the
step runner a training loop drives its steps with.

Port of `ray_tpu/train/trainer.py`, with `TorchTrainer` / `TorchConfig`
in place of `JaxTrainer` / `JaxConfig`. Torch is imported inside
`TrainStepRunner`'s methods, never by this module: the train controller
(Tune's trial actor, which unpickles the trainer) runs without it.

Reference: `python/ray/train/base_trainer.py:567` (`BaseTrainer.fit` wraps
the trainer as a Tune Trainable and runs a one-trial Tuner — Train runs ON
TOP of Tune) and `python/ray/train/data_parallel_trainer.py:25,428`
(`DataParallelTrainer.training_loop` drives the BackendExecutor).

This implementation keeps the same layering: `fit()` constructs a
single-trial `ray_tpu_torch.tune.Tuner` when Tune is importable, falling
back to driving the controller loop inline. The controller loop itself
(`_run_training_loop`) is what the reference runs inside the Trainable
actor.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor,
    TrainingFailedError,
)
from ray_tpu_torch.train._internal.checkpoint_manager import (
    CheckpointManager,
    IncompleteCheckpointError,
)
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.util import tracing as _tracing


class TrainStepRunner:
    """Dispatch-amortized runner of a training loop's steps.

    Wraps ``step_fn(carry, batch) -> (carry, aux)`` with the compiled-step
    cache (`ray_tpu_torch.parallel.compiled_step`) with the carry donated:
    on the card the step is captured ONCE per abstract signature as a CUDA
    graph over the carry's storages, and a steady-state step is one graph
    replay (shape drift trips the retrace guard instead of capturing
    again). The first call runs the step eagerly and is the step: it
    advances the carry once. On the CPU (``device="cpu"``) the step runs
    eagerly through the same cache.

    The carry is a tree of tensors: the parameters and the optimizer
    state, updated in place (``torch.optim.AdamW(..., capturable=True)``,
    with its state created before the first call, so that the first
    call's signature is that of every later one) or returned as new
    tensors, which the graph copies back into the carry's storages. Feed
    the returned carry into the next call.

    With ``steps_per_call=K`` (opt-in), K steps fold into ONE call:
    ``run(carry, batch_iter)`` pulls K batches, stacks them on a leading
    axis and runs the K-step loop as one graph
    (`ray_tpu_torch.parallel.fold_steps`). The aux comes back stacked
    ([K, ...]) so loss trajectories are those of K single steps.

    On the card the returned aux is the graph's static output, which the
    next ``run`` overwrites: a caller that keeps the losses across two
    runs clones them (``losses.clone()``, or reads them to the host).

    Example::

        runner = TrainStepRunner(step, steps_per_call=8)
        for _ in range(num_reports):
            carry, losses = runner.run(carry, batch_iter)
            report({"loss": float(losses[-1])})
    """

    def __init__(self, step_fn: Callable, *, steps_per_call: int = 1,
                 donate_carry: bool = True, mesh=None,
                 on_retrace: str = "warn",
                 tokens_per_step: int = 0,
                 flops_per_step: float = 0.0,
                 peak_flops: Optional[float] = None,
                 device=None):
        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.parallel.compile_cache import (compiled_step,
                                                          fold_steps)

        if steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        self.device = resolve_device(device)
        self.step_fn = step_fn
        self.steps_per_call = steps_per_call
        # flight recorder: optional model accounting for the per-step
        # MFU column (tokens/flops consumed PER SINGLE STEP; peak_flops
        # overrides device detection — required for MFU on the CPU)
        self._tokens_per_step = tokens_per_step
        self._flops_per_step = flops_per_step
        self._peak_flops = peak_flops
        self._step = 0
        if steps_per_call == 1:
            self._compiled = compiled_step(
                step_fn, donate_argnums=(0,) if donate_carry else (),
                mesh=mesh, on_retrace=on_retrace, device=self.device)
        else:
            self._compiled = fold_steps(
                step_fn, steps_per_call, donate_carry=donate_carry,
                mesh=mesh, on_retrace=on_retrace, device=self.device)

    def _prep_batches(self, batches):
        from ray_tpu_torch.parallel.compile_cache import stack_batches

        if self.steps_per_call == 1:
            if hasattr(batches, "__next__"):
                batches = next(batches)
            return batches
        if hasattr(batches, "__next__") or (
                isinstance(batches, (list, tuple))):
            it = iter(batches)
            batches = stack_batches(
                next(it) for _ in range(self.steps_per_call))
        return batches

    def run(self, carry, batches):
        """Advance ``steps_per_call`` steps in one call.

        ``batches``: an iterator/iterable of per-step batches (the next
        K are pulled and stacked), or an already-stacked [K, ...] tree
        when ``steps_per_call > 1``. Returns ``(carry, aux)`` with aux
        stacked over the K steps (a bare aux for K == 1).

        Every call lands one ``StepStats`` record in the flight recorder
        (``ray_tpu_torch.util.step_profiler``): data-wait (batch pull +
        stack), host-dispatch (time in the compiled call) and, on the
        card, device-execute: the elapsed time between two timing CUDA
        events recorded around the compiled call. The host does not
        synchronize for it. A call's events are read after the next
        call has launched (the host waits there for the previous step,
        with this one queued behind it, so it runs at most one step
        ahead of the card), and the last call's when the recorder's
        records are read. So a call's ``total_ms`` is, in steady state,
        one device step. Disable the recorder wholesale with
        ``RAY_TPU_STEP_PROFILER=0``: ``run`` is then the bare call.

        Spans (``util.tracing``): ``train.step`` around the call, with
        ``train.prep`` (the batch pull), the compiled call's
        ``compiled_step.lookup`` and ``compiled_step.replay``, and
        ``train.record`` (reading the previous call's events and
        recording this one) inside it."""
        from ray_tpu_torch.util import step_profiler

        with _tracing.span("train.step"):
            if not step_profiler.enabled():
                with _tracing.span("train.prep"):
                    batches = self._prep_batches(batches)
                return self._compiled(carry, batches)
            t0 = time.perf_counter()
            with _tracing.span("train.prep"):
                batches = self._prep_batches(batches)
            t1 = time.perf_counter()
            events = self._timing_events()
            if events is not None:
                events[0].record(events[2])
            out = self._compiled(carry, batches)
            if events is not None:
                events[1].record(events[2])
            t2 = time.perf_counter()
            with _tracing.span("train.record"):
                step_profiler.resolve_device_times()
                self._step += self.steps_per_call
                k = self.steps_per_call
                step_profiler.record_step(
                    self._step, (time.perf_counter() - t0) * 1e3,
                    host_dispatch_ms=(t2 - t1) * 1e3,
                    data_wait_ms=(t1 - t0) * 1e3,
                    tokens=self._tokens_per_step * k,
                    flops=self._flops_per_step * k,
                    steps_per_call=k,
                    peak=self._peak_flops,
                    device_events=None if events is None else events[:2],
                )
            return out

    def _timing_events(self):
        """(start, end, stream): two timing CUDA events for the call's
        device work on the stream it runs on; None on the CPU, where the
        call is the work."""
        if self.device.type != "cuda":
            return None
        import torch

        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True),
                torch.cuda.current_stream(self.device))

    def cache_stats(self):
        return self._compiled.cache.stats.as_dict()

    def step_stats(self, n: Optional[int] = None):
        """The flight recorder's recent StepStats rows (dicts)."""
        from ray_tpu_torch.util import step_profiler

        return step_profiler.recent(n)


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}

    def training_loop(self) -> None:
        raise NotImplementedError

    def fit(self) -> Result:
        """Run via Tune when available (reference layering), else inline.

        Failures surface as exceptions, not silently as ``Result.error``
        (reference `BaseTrainer.fit` raises TrainingFailedError,
        `base_trainer.py:567`).
        """
        try:
            from ray_tpu_torch.tune.tuner import Tuner
        except ImportError:
            return self._fit_inline()
        tuner = Tuner(
            self.as_trainable(),
            run_config=self.run_config,
        )
        grid = tuner.fit()
        result = grid[0]
        if result.error is not None:
            if isinstance(result.error, TrainingFailedError):
                raise result.error
            raise TrainingFailedError(str(result.error)) from result.error
        return result

    def as_trainable(self):
        """Wrap as a Tune trainable function (reference
        `BaseTrainer.as_trainable`, `base_trainer.py:760`)."""
        from ray_tpu_torch.tune import trainable as trainable_mod
        trainer = self

        def train_func(config):
            from ray_tpu_torch.tune import trainable as t_mod
            # On a Tune-side trial restart the session carries the restore
            # checkpoint; it supersedes the original resume_from_checkpoint.
            sess = t_mod.session_mod.get_session()
            if sess is not None and sess.get_checkpoint() is not None:
                trainer.resume_from_checkpoint = sess.get_checkpoint()
            trainer._run_training_loop(report_fn=t_mod.session_report)

        train_func.__name__ = type(self).__name__
        tr = trainable_mod.wrap_function(train_func)
        # Trial actors must reserve the whole worker fleet's resources via
        # their own PG; trial resources = trainer bundle only (workers make
        # their own PG) — matches reference PlacementGroupFactory shape.
        tr._trainer_resources = self.scaling_config.trainer_resources or \
            {"CPU": 1.0}
        return tr

    def _fit_inline(self) -> Result:
        out: Dict[str, Any] = {}

        def collect(metrics, checkpoint=None):
            out["metrics"] = metrics
            if checkpoint is not None:
                out["checkpoint"] = checkpoint

        self._run_training_loop(report_fn=collect)
        return Result(metrics=out.get("metrics"),
                      checkpoint=out.get("checkpoint"),
                      path=self._trial_dir)

    # subclasses implement
    def _run_training_loop(self, report_fn: Optional[Callable]) -> None:
        raise NotImplementedError


class DataParallelTrainer(BaseTrainer):
    """SPMD trainer: N identical workers, one torch process each.

    Reference: `python/ray/train/data_parallel_trainer.py:25`. The "data
    parallel" here is about the *worker fleet*; within and across workers
    the model may still be sharded DP/FSDP/TP/SP via the mesh the train
    loop builds — the trainer provides the gang +
    rendezvous + report plumbing.
    """

    _backend_config_cls = BackendConfig

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint,
                         metadata=metadata)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._backend_config_cls()
        self.datasets = datasets or {}
        self._trial_dir: Optional[str] = None

    def _run_training_loop(self, report_fn: Optional[Callable]) -> None:
        """The controller loop (runs in the Trainable actor under Tune,
        or inline in the driver)."""
        name = self.run_config.name or f"{type(self).__name__}_" \
            f"{uuid.uuid4().hex[:8]}"
        trial_id = uuid.uuid4().hex[:8]
        executor = BackendExecutor(
            self.backend_config, self.scaling_config,
            experiment_name=name,
            storage_path=self.run_config.storage_path,
            trial_id=trial_id,
        )
        self._trial_dir = os.path.join(self.run_config.storage_path, name,
                                       trial_id)
        ckpt_manager = CheckpointManager(self.run_config.checkpoint_config)
        max_failures = self.run_config.failure_config.max_failures
        attempts = 0
        restore_checkpoint = self.resume_from_checkpoint
        while True:
            try:
                executor.start()
                executor.start_training(
                    self.train_loop_per_worker,
                    config=self.train_loop_config,
                    datasets=self.datasets,
                    checkpoint=restore_checkpoint,
                )
                last_metrics: Optional[Dict[str, Any]] = None
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    # Lowest live world rank speaks for the step; its
                    # checkpoint is the canonical (rank-0) one only while
                    # rank 0 is still reporting.
                    lead = min(results, key=lambda r: r["world_rank"])
                    last_metrics = lead["metrics"]
                    checkpoint = None
                    if lead.get("checkpoint_path") and \
                            lead["world_rank"] == 0:
                        checkpoint = Checkpoint(lead["checkpoint_path"])
                        # Already in trial storage: the Tune session must
                        # reference it, not re-copy it (a second persisted
                        # copy would double disk use and escape the
                        # CheckpointManager's num_to_keep eviction).
                        checkpoint._persisted = True
                        try:
                            ckpt_manager.register_checkpoint(
                                checkpoint, last_metrics,
                                require_usable=True)
                        except IncompleteCheckpointError as e:
                            raise TrainingFailedError(str(e)) from e
                    # Gang-durable commit: the checkpoint is registered;
                    # release every rank blocked in report()'s barrier.
                    # Unconditional — when rank 0 has already finished,
                    # later ranks' checkpoint reports still hold the
                    # barrier and must be released even though nothing
                    # was registered for them.
                    executor.commit_gang_checkpoint()
                    if report_fn is not None:
                        report_fn(last_metrics, checkpoint=checkpoint)
                executor.shutdown()
                return
            except TrainingFailedError:
                executor.shutdown()
                attempts += 1
                if max_failures >= 0 and attempts > max_failures:
                    raise
                restore_checkpoint = self._latest_usable_checkpoint(
                    ckpt_manager) or restore_checkpoint
            except BaseException:
                executor.shutdown()
                raise


    @staticmethod
    def _latest_usable_checkpoint(ckpt_manager: CheckpointManager):
        """Newest checkpoint whose shard set is complete. A gang killed
        mid-persist can leave a sharded checkpoint missing some ranks'
        files; restoring from it would fail again, so the restart walks
        back to the newest complete one (dict checkpoints are atomic and
        always usable)."""
        from ray_tpu_torch.train import array_checkpoint

        for ckpt, _metrics in reversed(ckpt_manager.best_checkpoints()):
            if array_checkpoint.is_usable(ckpt):
                return ckpt
        return None


class TorchTrainer(DataParallelTrainer):
    """The flagship trainer: N workers joined in a `torch.distributed`
    process group (NCCL on the card, gloo on the CPU), the counterpart of
    the JAX package's `JaxTrainer` (reference: `python/ray/train/torch/
    torch_trainer.py`). See `ray_tpu_torch/train/backend.py`."""

    _backend_config_cls = TorchConfig
