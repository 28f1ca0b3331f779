"""Pipeline parallelism over a `pp` mesh axis (GPipe microbatches).

Port of `ray_tpu/parallel/pipeline.py`. Each rank of the `pp` axis holds
its own stage's parameters (the block of the [num_stages, ...] stacked
tree that the JAX package shards over `pp`). Microbatches stream through
the stages in M + S - 1 schedule steps: stage s computes microbatch m at
step s + m, and activations hop s -> s + 1 with `collectives.ring_permute`
(the JAX `lax.ppermute`). As in the JAX program every stage computes at
every step and the bubble's results are masked out (`torch.where`); the
last hop, which would only bring the last stage's output round to stage
0, is left out.

JAX differentiates the whole schedule with `jax.grad`. Here the permute
is differentiable (its backward sends the activation gradient upstream,
to s - 1), so autograd runs the backward schedule: microbatches in
reverse, each stage's gradient hops issued in the same order on every
rank. The masks keep every step of every rank in its autograd graph (a
masked-out value gets a zero gradient), so every rank takes part in
every hop of the backward. `remat=True` checkpoints each stage invocation
(`torch.utils.checkpoint`), as `jax.checkpoint` does.

Gradient accumulation is intrinsic: the fused loss averages over the M
microbatches, so the backward accumulates per-stage parameter gradients
across microbatches. The bubble is (S-1)/(M+S-1).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.compile_cache import _tree_map
from ray_tpu_torch.parallel.sharding import PartitionSpec as P
from ray_tpu_torch.parallel.sharding import as_global, as_local


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Structural pipeline bubble: idle fraction of the schedule,
    (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _batch_spec(mesh, batch_axes) -> object:
    batch = tuple(a for a in batch_axes if a in mesh.axis_names)
    return batch if len(batch) > 1 else (batch[0] if batch else None)


def _schedule(stage_fn: Callable, n_stages: int, num_microbatches: int,
              axis_name: str, remat: bool, loss_fn: Optional[Callable],
              mesh):
    """The per-rank GPipe schedule body: local(params, xb[, yb]) over this
    stage's params and this rank's batch block. With loss_fn, the last
    stage folds each retiring microbatch into a loss sum and every stage
    returns the mean over microbatches (one scalar all-reduce over
    `axis_name`); without, every stage returns [batch_local, ...]: the
    outputs on the last stage, zeros on the others."""
    n_steps = num_microbatches + n_stages - 1

    def stage(params, h):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, params, h, use_reentrant=False)
        return stage_fn(params, h)

    def local(params, xb, yb=None):
        my_stage = collectives.axis_index(axis_name, mesh=mesh)
        first = torch.tensor(my_stage == 0, device=xb.device)
        last = my_stage == n_stages - 1
        mb = xb.reshape(num_microbatches, xb.shape[0] // num_microbatches,
                        *xb.shape[1:])
        if yb is not None:
            yv = yb.reshape(num_microbatches,
                            yb.shape[0] // num_microbatches, *yb.shape[1:])
        state = torch.zeros_like(mb[0])
        outs, loss = [], torch.zeros((), dtype=torch.float32,
                                     device=xb.device)
        for t in range(n_steps):
            # the first stage ingests microbatch t (when in range)
            state = torch.where(first, mb[min(t, num_microbatches - 1)],
                                state)
            out = stage(params, state)
            # the last stage retires microbatch t - (S - 1)
            idx = t - (n_stages - 1)
            retire = torch.tensor(last and idx >= 0, device=xb.device)
            if loss_fn is None:
                if idx >= 0:
                    outs.append(torch.where(retire, out,
                                            torch.zeros_like(out)))
            else:
                l_mb = loss_fn(out, yv[min(max(idx, 0),
                                           num_microbatches - 1)])
                loss = loss + torch.where(retire, l_mb, 0.0)
            if t < n_steps - 1:
                state = collectives.ring_permute(out, axis_name, mesh=mesh)
        if loss_fn is None:
            # [batch_local, ...]: real outputs on the last stage only
            return torch.cat(outs)
        # everyone learns the last stage's loss sum: a scalar all-reduce is
        # the whole cross-stage cost of the fused path
        return collectives.allreduce(loss, axis_name,
                                     mesh=mesh) / num_microbatches

    return local


def _stage_params(stage_params, mesh, axis_name):
    """This stage's block of the stacked [num_stages, ...] tree."""
    def take(p):
        return as_local(p, mesh, P(axis_name, *([None] * (p.ndim - 1))))[0]

    return _tree_map(take, stage_params)


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x,
    mesh,
    *,
    num_microbatches: int,
    axis_name: str = "pp",
    batch_axes=("dp", "fsdp"),
    remat: bool = False,
):
    """Run `stage_fn(params_i, activations)` through all pipeline stages
    (inference / feature-extraction path).

    stage_params: a tree with a leading [num_stages, ...] axis (global
        values, or DTensors split over `axis_name`); each rank uses its
        stage's block.
    x: [batch, ...] global input; this rank's block of the data axes is
        split into microbatches.
    Returns the final stage's output for every microbatch as a DTensor
    [batch, ...] split over the data axes: the last stage's output,
    broadcast over `axis_name` (one transfer from that stage).
    """
    n_stages = mesh.shape[axis_name]
    xspec = P(_batch_spec(mesh, batch_axes), *([None] * (x.ndim - 1)))
    local = _schedule(stage_fn, n_stages, num_microbatches, axis_name,
                      remat, None, mesh)
    out = local(_stage_params(stage_params, mesh, axis_name),
                as_local(x, mesh, xspec))
    out = collectives.broadcast(out, axis_name, root=n_stages - 1,
                                mesh=mesh)
    return as_global(out, mesh, xspec, shape=(x.shape[0], *out.shape[1:]))


def pipeline_loss(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    y,
    mesh,
    *,
    num_microbatches: int,
    axis_name: str = "pp",
    batch_axes=("dp", "fsdp"),
    remat: bool = True,
):
    """Fused pipeline forward + loss: `loss_fn(out_mb, y_mb) -> scalar`
    is applied to each retiring microbatch on the last stage; returns the
    mean over microbatches, the same on every rank of `axis_name`.
    Cross-stage traffic at the end of the schedule is one scalar
    all-reduce."""
    n_stages = mesh.shape[axis_name]
    bspec = _batch_spec(mesh, batch_axes)
    xspec = P(bspec, *([None] * (x.ndim - 1)))
    yspec = P(bspec, *([None] * (y.ndim - 1)))
    local = _schedule(stage_fn, n_stages, num_microbatches, axis_name,
                      remat, loss_fn, mesh)
    return local(_stage_params(stage_params, mesh, axis_name),
                 as_local(x, mesh, xspec), as_local(y, mesh, yspec))


def pipeline_train_step(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    y,
    mesh,
    *,
    num_microbatches: int,
    axis_name: str = "pp",
    batch_axes=("dp", "fsdp"),
    remat: bool = True,
):
    """(loss, grads) through the fused-loss pipeline. Grads keep the
    [num_stages, ...] leading axis split over `axis_name` (DTensors whose
    local shard is this stage's gradient), ready for a per-stage optimizer
    update with no cross-stage gather. Gradient accumulation over the
    `num_microbatches` microbatches is built into the backward."""
    spec = {}

    def leaf(p):
        s = P(axis_name, *([None] * (p.ndim - 1)))
        local = as_local(p, mesh, s).detach().requires_grad_(True)
        spec[id(local)] = (s, p.shape)
        return local

    local_params = _tree_map(leaf, stage_params)
    placed = _tree_map(lambda p: as_global(p, mesh, *spec[id(p)]),
                       local_params)
    loss = pipeline_loss(
        stage_fn, loss_fn, placed, x, y, mesh,
        num_microbatches=num_microbatches, axis_name=axis_name,
        batch_axes=batch_axes, remat=remat)
    loss.backward()

    def grad(local):
        s, shape = spec[id(local)]
        return as_global(local.grad, mesh, s, shape=shape)

    return loss.detach(), _tree_map(grad, local_params)


def stack_stage_params(param_list):
    """Stack per-stage parameter trees into one [num_stages, ...] tree."""
    from ray_tpu_torch.parallel.compile_cache import _stack

    return _stack(list(param_list))
