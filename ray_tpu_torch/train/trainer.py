"""The single-process train plane: `TrainStepRunner`.

Port of `ray_tpu/train/trainer.py:40-164` (the runner only; the trainers
around it, `BaseTrainer` and `DataParallelTrainer`, need the runtime and
Tune and come with ROADMAP S4d).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel.compile_cache import (compiled_step, fold_steps,
                                                  stack_batches)
from ray_tpu_torch.util import step_profiler


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
        stack), host-dispatch (time in the compiled call) and — when
        ``RAY_TPU_PROFILE_SYNC`` is on, the default — device-execute as
        the time to ``torch.cuda.synchronize`` the device afterwards.
        Disable the recorder wholesale with ``RAY_TPU_STEP_PROFILER=0``:
        ``run`` is then the bare call."""
        if not step_profiler.enabled():
            return self._compiled(carry, self._prep_batches(batches))
        t0 = time.perf_counter()
        batches = self._prep_batches(batches)
        t1 = time.perf_counter()
        out = self._compiled(carry, batches)
        t2 = time.perf_counter()
        device_ms = 0.0
        if step_profiler.sync_mode():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            device_ms = (time.perf_counter() - t2) * 1e3
        self._step += self.steps_per_call
        k = self.steps_per_call
        step_profiler.record_step(
            self._step, (time.perf_counter() - t0) * 1e3,
            host_dispatch_ms=(t2 - t1) * 1e3,
            device_execute_ms=device_ms,
            data_wait_ms=(t1 - t0) * 1e3,
            tokens=self._tokens_per_step * k,
            flops=self._flops_per_step * k,
            steps_per_call=k,
            peak=self._peak_flops,
        )
        return out

    def cache_stats(self):
        return self._compiled.cache.stats.as_dict()

    def step_stats(self, n: Optional[int] = None):
        """The flight recorder's recent StepStats rows (dicts)."""
        return step_profiler.recent(n)
