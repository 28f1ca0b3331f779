"""Collective operations over mesh axes.

Port of `ray_tpu/parallel/collectives.py`: the same vocabulary
(allreduce / allgather / reducescatter / all_to_all / ring permute /
broadcast / axis index) over a mesh axis, plus the host-level (CPU)
collectives over the object store (`HostGroup`).

In the JAX package these are XLA ops inside `shard_map`, named by mesh
axis. Here each runs `torch.distributed` over the mesh's process group of
that axis (`Mesh.group`): NCCL on the card, gloo on the CPU. A
collective over axes of size 1 is the identity and launches nothing, as
XLA emits nothing for one. The JAX ops are differentiated through (ring
attention, the pipeline), so each op here is a `torch.autograd.Function`
whose backward is the transpose:

- `allgather` <-> `reducescatter` (sum), as `all_gather`'s transpose is
  `psum_scatter` in JAX;
- `all_to_all` back with the split and concat dims swapped;
- `ring_permute` by the opposite shift;
- `allreduce`'s backward is the identity: its result is the same on every
  rank, and each rank back-propagates its own copy of a replicated value
  once (the loss of a step, the output of a row-parallel layer);
- `replicated_input` (the port's own; GSPMD inserts it in the JAX
  package) is the identity forward and an all-reduce of the gradient: the
  input, the same on every rank of `axis`, of a layer whose weight is
  split over `axis`.

Pass the mesh (`mesh=`): a torch process group is not implied by a
`with mesh:` block.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor forms (`all_gather_single`,
# `reduce_scatter_single`); the card's torch 2.11 has only the old names,
# which 2.13 keeps with a FutureWarning on every call
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")


# -- raw ops on a process group (None: a group of one rank) ------------------

def _all_gather(x, group, dim: int):
    n = group.size()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if dim == 0:
        return out
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)


def _reduce_scatter(x, group, dim: int):
    n = group.size()
    if x.shape[dim] % n:
        raise ValueError(f"reducescatter: dimension {dim} of size "
                         f"{x.shape[dim]} does not split over {n} ranks")
    inp = torch.cat(x.chunk(n, dim=dim)) if dim else x
    out = torch.empty((inp.shape[0] // n, *inp.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, inp.contiguous(), group=group)
    if dim == 0:
        return out
    return out.view(*x.shape[:dim], x.shape[dim] // n, *x.shape[dim + 1:])


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_to_all(x, group, split_dim: int, concat_dim: int, tiled: bool):
    """Tiled: `split_dim` cut in n chunks, chunk j to rank j, the received
    chunks concatenated on `concat_dim` in rank order. Untiled: the size-n
    `split_dim` is removed and the n received pieces stacked at
    `concat_dim` (`lax.all_to_all(tiled=False)`)."""
    n = group.size()
    inp = torch.stack(x.chunk(n, dim=split_dim)) if tiled else \
        x.movedim(split_dim, 0)
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    if tiled:
        return torch.cat(out.unbind(0), dim=concat_dim)
    return out.movedim(0, concat_dim)


def _peer(group, shift: int) -> int:
    me = dist.get_rank(group)
    return dist.get_global_rank(group, (me + shift) % group.size())


def _permute(x, group, shift: int):
    """Rank i's x to rank i + shift (mod n) of the group."""
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, _peer(group, shift), group),
        dist.P2POp(dist.irecv, out, _peer(group, -shift), group)])
    for r in reqs:
        r.wait()
    return out


# -- differentiable forms -----------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return _all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim, tiled):
        ctx.args = (group, split_dim, concat_dim, tiled)
        return _all_to_all(x, group, split_dim, concat_dim, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim, tiled = ctx.args
        return (_all_to_all(g, group, concat_dim, split_dim, tiled),
                None, None, None, None)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


# -- in-program collectives over mesh axes ------------------------------------

def allreduce(x, axis: str | Sequence[str], *, mesh):
    """Sum over `axis` (`lax.psum`)."""
    group = mesh.group(axis)
    return x if group is None else _AllReduce.apply(x, group,
                                                    dist.ReduceOp.SUM)


def allreduce_mean(x, axis: str | Sequence[str], *, mesh):
    """Mean over `axis` (`lax.pmean`)."""
    return allreduce(x, axis, mesh=mesh) / mesh.axis_size(axis)


def allgather(x, axis: str, *, gather_dim: int = 0, tiled: bool = True,
              mesh):
    """Concatenate the shards of `axis` on `gather_dim` (untiled: stack
    them on a new `gather_dim`), `lax.all_gather`."""
    if not tiled:
        x = x.unsqueeze(gather_dim)
    group = mesh.group(axis)
    return x if group is None else _AllGather.apply(x, group, gather_dim)


def reducescatter(x, axis: str, *, scatter_dim: int = 0, mesh):
    """Sum over `axis`, each rank keeping its 1/n of `scatter_dim`
    (`lax.psum_scatter(tiled=True)`)."""
    group = mesh.group(axis)
    return x if group is None else _ReduceScatter.apply(x, group,
                                                        scatter_dim)


def all_to_all(x, axis: str, *, split_dim: int, concat_dim: int,
               tiled: bool = True, mesh):
    """`lax.all_to_all` (tiled by default, as the JAX wrapper calls it)."""
    group = mesh.group(axis)
    if group is None:
        return x if tiled else x.movedim(split_dim, concat_dim)
    return _AllToAll.apply(x, group, split_dim, concat_dim, tiled)


def ring_permute(x, axis: str, *, shift: int = 1, mesh):
    """Rotate shards around the ring of `axis`: rank i's x goes to rank
    i + shift (`lax.ppermute` with that permutation)."""
    group = mesh.group(axis)
    return x if group is None else _Permute.apply(x, group, shift)


def broadcast(x, axis: str, *, root: int = 0, mesh):
    """Every member gets the root's value (the root's x summed with the
    others' zeros, as the JAX function computes it)."""
    masked = torch.where(torch.tensor(axis_index(axis, mesh=mesh) == root),
                         x, torch.zeros_like(x))
    return allreduce(masked, axis, mesh=mesh)


def axis_index(axis: str, *, mesh) -> int:
    """This rank's index along `axis` (`lax.axis_index`)."""
    return mesh.axis_index(axis)


def replicated_input(x, axis: str | Sequence[str], *, mesh):
    """Identity forward, all-reduce of the gradient over `axis` backward
    (module docstring)."""
    group = mesh.group(axis)
    return x if group is None else _ReplicatedInput.apply(x, group)


# -- whole-tree helpers ---------------------------------------------------------

def device_allreduce(mesh, xs, axis: str = "dp"):
    """One-shot allreduce of a tree across a mesh axis: each leaf is this
    rank's shard (a DTensor's local shard, or a local tensor) and comes
    back summed over `axis`, the same on every member."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.compile_cache import _tree_map

    def reduce(x):
        if isinstance(x, DTensor):
            x = x.to_local()
        return allreduce(x, axis, mesh=mesh)

    return _tree_map(reduce, xs)


# --- host-level collectives (CPU control plane) -------------------------
# Named actors of the port's runtime provide the rendezvous.

class HostGroup:
    """Barrier/broadcast/allreduce among N ray_tpu_torch actors or drivers,
    coordinated through a named rendezvous actor."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 timeout_s: float = 300.0):
        import collections

        import ray_tpu_torch

        self.world_size = world_size
        self.rank = rank
        # every collective's completion deadline: a dead/absent rank
        # surfaces as GetTimeoutError here instead of a silent hang
        self.timeout_s = timeout_s
        # Per-tag round counters: every rank calls collectives in the same
        # order (SPMD), so suffixing the round number lets tags be reused.
        self._rounds = collections.defaultdict(int)
        # self-send FIFOs, one per tag (send/recv to own rank never
        # touches the rendezvous actor)
        self._loopback = collections.defaultdict(collections.deque)
        if rank == 0:
            # Barrier semantics need all members' calls in flight at once.
            self._actor = _Rendezvous.options(
                name=f"collective:{group_name}", lifetime="detached",
                max_concurrency=max(16, world_size * 4),
            ).remote(world_size)
        else:
            import time

            deadline = time.time() + 60
            while True:
                try:
                    self._actor = ray_tpu_torch.get_actor(
                        f"collective:{group_name}")
                    break
                except ValueError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.1)

    def _round_tag(self, tag: str) -> str:
        n = self._rounds[tag]
        self._rounds[tag] += 1
        return f"{tag}#{n}"

    def _timed_get(self, ref):
        """Collective completion wait, charged to the flight recorder's
        collective_ms phase (folds into this thread's next StepStats)."""
        import time

        import ray_tpu_torch
        from ray_tpu_torch.util import step_profiler

        t0 = time.perf_counter()
        try:
            return ray_tpu_torch.get(ref, timeout=self.timeout_s)
        finally:
            step_profiler.add_phase_ms(
                "collective_ms", (time.perf_counter() - t0) * 1e3)

    def barrier(self, tag: str = "barrier"):
        self._timed_get(
            self._actor.barrier.remote(self._round_tag(tag), self.rank))

    def broadcast(self, value=None, root: int = 0, tag: str = "bcast"):
        tag = self._round_tag(tag)
        if self.rank == root:
            self._timed_get(self._actor.put.remote(tag, value))
            return value
        return self._timed_get(self._actor.take.remote(tag))

    def allreduce_sum(self, value, tag: str = "sum"):
        return self._timed_get(
            self._actor.reduce.remote(self._round_tag(tag), self.rank,
                                      value))

    def allgather(self, value, tag: str = "gather"):
        """Every rank receives [value_0, ..., value_{world-1}] in rank
        order."""
        return self._timed_get(
            self._actor.gather.remote(self._round_tag(tag), self.rank,
                                      value))

    def reducescatter_sum(self, value, tag: str = "rs"):
        """Sum across ranks, then each rank keeps its 1/world_size shard
        along axis 0. `value` must be an array with leading dim divisible
        by world_size."""
        import numpy as np

        value = np.asarray(value)
        if value.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter: leading dim {value.shape[0]} not "
                f"divisible by world_size {self.world_size}")
        total = self.allreduce_sum(value, tag=tag)
        return np.array_split(total, self.world_size, axis=0)[self.rank]

    # -- point-to-point -----------------------------------------------------

    def _p2p_tag(self, src: int, dst: int, tag: str) -> str:
        key = (src, dst, tag)
        n = self._rounds[key]
        self._rounds[key] += 1
        return f"p2p:{src}->{dst}:{tag}#{n}"

    def send(self, value, dst: int, tag: str = "p2p"):
        """Deliver `value` to rank `dst` (non-blocking handoff through
        the rendezvous actor; pairs with exactly one recv). A self-send
        (dst == rank) short-circuits through a local FIFO — both sides
        of the pair live in this process, so the round counters would
        otherwise never match."""
        if dst == self.rank:
            self._loopback[tag].append(value)
            return
        import ray_tpu_torch

        ray_tpu_torch.get(
            self._actor.put.remote(self._p2p_tag(self.rank, dst, tag),
                                   value),
            timeout=self.timeout_s)

    def recv(self, src: int, tag: str = "p2p"):
        """Block until the matching send from rank `src` arrives."""
        if src == self.rank:
            # both ends live on this thread: a recv with no prior send
            # could only deadlock, so fail loudly instead
            if not self._loopback[tag]:
                raise ValueError(
                    f"recv(src=rank) with no prior send(dst=rank) for "
                    f"tag {tag!r} — a self-recv cannot block")
            return self._loopback[tag].popleft()
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._actor.take_pop.remote(self._p2p_tag(src, self.rank, tag)),
            timeout=self.timeout_s)


def _tree_add(a, b):
    """Leafwise a + b over dicts, lists and tuples (`jax.tree_util.
    tree_map(lambda a, b: a + b, ...)`)."""
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


class _RendezvousImpl:
    def __init__(self, world_size: int):
        import asyncio

        self.world = world_size
        self.values = {}
        self.events = {}
        self.counts = {}
        self.reduced = {}
        self.consumed = {}
        self._asyncio = asyncio

    def _event(self, tag):
        if tag not in self.events:
            self.events[tag] = self._asyncio.Event()
        return self.events[tag]

    def _release(self, key, readers: int):
        """Free a round's state once every expected reader has taken its
        result — long-lived groups must not accumulate one entry per
        collective round."""
        self.consumed[key] = self.consumed.get(key, 0) + 1
        if self.consumed[key] >= readers:
            self.consumed.pop(key, None)
            self.counts.pop(key, None)
            self.events.pop(key, None)
            self.values.pop(key, None)
            self.reduced.pop(key, None)

    async def barrier(self, tag, rank):
        key = ("b", tag)
        self.counts[key] = self.counts.get(key, 0) + 1
        if self.counts[key] >= self.world:
            self._event(key).set()
        await self._event(key).wait()
        self._release(key, self.world)
        return True

    async def put(self, tag, value):
        if self.world == 1:
            return True  # no takers would ever free the slot
        self.values[tag] = value
        self._event(("v", tag)).set()
        return True

    async def take(self, tag):
        """Multi-consumer take (broadcast: world-1 non-root readers)."""
        await self._event(("v", tag)).wait()
        value = self.values[tag]
        self.consumed[tag] = self.consumed.get(tag, 0) + 1
        if self.consumed[tag] >= self.world - 1:
            self.consumed.pop(tag, None)
            self.events.pop(("v", tag), None)
            self.values.pop(tag, None)
        return value

    async def take_pop(self, tag):
        """Single-consumer take: frees the slot (p2p recv)."""
        await self._event(("v", tag)).wait()
        self.events.pop(("v", tag), None)
        return self.values.pop(tag)

    async def gather(self, tag, rank, value):
        key = ("g", tag)
        self.values.setdefault(key, {})[rank] = value
        if len(self.values[key]) >= self.world:
            self._event(key).set()
        await self._event(key).wait()
        vals = self.values[key]
        out = [vals[r] for r in range(self.world)]
        self._release(key, self.world)
        return out

    async def reduce(self, tag, rank, value):
        key = ("r", tag)
        if key not in self.reduced:
            self.reduced[key] = value
        else:
            self.reduced[key] = _tree_add(self.reduced[key], value)
        self.counts[key] = self.counts.get(key, 0) + 1
        if self.counts[key] >= self.world:
            self._event(key).set()
        await self._event(key).wait()
        out = self.reduced[key]
        self._release(key, self.world)
        return out


def _make_rendezvous():
    import ray_tpu_torch

    return ray_tpu_torch.remote(_RendezvousImpl)


_Rendezvous = _make_rendezvous()
