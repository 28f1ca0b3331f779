"""Sharding strategies over named mesh axes.

Port of `ray_tpu/parallel/sharding.py`. Every strategy is a set of
logical-axis rules mapped onto the mesh, with the JAX package's rules:

- DP:   batch -> dp
- FSDP: batch -> fsdp, params' `embed` axis -> fsdp
- TP:   heads/mlp/qkv/vocab -> tp (Megatron-style column/row splits)
- SP:   sequence -> sp
- EP:   experts -> ep

A JAX `PartitionSpec` (one entry per array dimension: None, a mesh axis
or a tuple of them) is the port's `PartitionSpec`, a tuple, and becomes
DTensor placements, one per mesh axis (`Shard(dim)` where the spec puts
that axis on `dim`, else `Replicate()`): `placements`. A sharded global
array is a `DTensor` over the mesh's `DeviceMesh` (`shard_batch`,
`shard_params`), whose local shard is the block a JAX `shard_map` body
sees. Torch modules carry no flax metadata, so a model's parameters'
logical axes come as a table (`models.gpt.param_logical_axes`), which
`param_shardings` maps through the rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: per array dimension, None, a mesh
    axis name or a tuple of them."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingStrategy:
    """Declarative parallelism config. `dcn_dp` is the multislice knob:
    groups of ranks ganged as an extra OUTER data-parallel axis; the
    per-slice axes (dp/fsdp/tp/sp/pp/ep) describe one slice's mesh and the
    full mesh is dcn x per-slice (`mesh.build_hybrid_mesh`)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    dcn_dp: int = 1

    def mesh_axes(self, n_devices: int) -> Dict[str, int]:
        """Per-slice axes for `n_devices` ranks in ONE slice."""
        from ray_tpu_torch.parallel.mesh import mesh_shape_for

        return mesh_shape_for(n_devices, dp=self.dp, fsdp=self.fsdp,
                              tp=self.tp, sp=self.sp, pp=self.pp, ep=self.ep)

    def build_mesh(self, devices=None, *, device=None):
        """The strategy's mesh over `devices` (global ranks; default the
        whole group). `device` as in `mesh.build_mesh`."""
        from ray_tpu_torch.parallel.mesh import (MeshConfig, _world_ranks,
                                                 build_hybrid_mesh,
                                                 build_mesh)

        devices = _world_ranks(devices)
        if self.dcn_dp > 1:
            if len(devices) % self.dcn_dp != 0:
                raise ValueError(
                    f"{len(devices)} devices not divisible into "
                    f"{self.dcn_dp} slices")
            per_slice = len(devices) // self.dcn_dp
            return build_hybrid_mesh(
                self.mesh_axes(per_slice), {"dcn": self.dcn_dp}, devices,
                device=device)
        return build_mesh(MeshConfig(self.mesh_axes(len(devices))), devices,
                          device=device)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Mesh axes the global batch is split over (dcn outermost)."""
        axes = tuple(a for a, n in (("dcn", self.dcn_dp), ("dp", self.dp),
                                    ("fsdp", self.fsdp)) if n > 1)
        return axes or ("dp",)


def logical_axis_rules(strategy: ShardingStrategy
                       ) -> List[Tuple[str, Optional[tuple]]]:
    """Logical-axis -> mesh-axis rules (the JAX package's list)."""
    batch_axes = tuple(a for a, n in (("dcn", strategy.dcn_dp),
                                      ("dp", strategy.dp),
                                      ("fsdp", strategy.fsdp)) if n > 1)
    rules: List[Tuple[str, Optional[tuple]]] = [
        ("batch", batch_axes or None),
        ("seq", ("sp",) if strategy.sp > 1 else None),
        # Parameter axes.
        ("embed", ("fsdp",) if strategy.fsdp > 1 else None),
        ("mlp", ("tp",) if strategy.tp > 1 else None),
        ("heads", ("tp",) if strategy.tp > 1 else None),
        ("kv", None),
        ("qkv", ("tp",) if strategy.tp > 1 else None),
        ("vocab", ("tp",) if strategy.tp > 1 else None),
        ("expert", ("ep",) if strategy.ep > 1 else None),
        ("stage", ("pp",) if strategy.pp > 1 else None),
        ("norm", None),
    ]
    return [(name, axes[0] if axes and len(axes) == 1 else axes)
            for name, axes in rules]


def batch_spec(strategy: ShardingStrategy, extra_dims: int = 1
               ) -> PartitionSpec:
    """PartitionSpec for a [batch, ...] array: batch split over data axes,
    sequence over sp if enabled."""
    axes: list = [strategy.data_axes if len(strategy.data_axes) > 1
                  else strategy.data_axes[0]]
    if strategy.sp > 1 and extra_dims >= 1:
        axes.append("sp")
        extra_dims -= 1
    axes.extend([None] * extra_dims)
    return PartitionSpec(*axes)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh axis) of `spec`: `Shard(dim)` on
    the axes a dimension is split over, `Replicate()` elsewhere. Axes the
    mesh lacks are dropped (a size-1 axis of the strategy)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for name in _entry_axes(entry):
            if name in mesh.shape:
                out[mesh.axis_names.index(name)] = Shard(dim)
    return tuple(out)


def spec_of(mesh, placements_, ndim: int) -> PartitionSpec:
    """Inverse of `placements`: the mesh axes each dimension is split
    over, outermost first."""
    entries: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.axis_names, placements_):
        if p.is_shard():
            entries[p.dim].append(name)
    return PartitionSpec(*[None if not e else e[0] if len(e) == 1
                           else tuple(e) for e in entries])


def local_block(x, mesh, spec):
    """This rank's block of the global array `x` under `spec` (a view:
    differentiable, no communication): what a shard_map body sees."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {x.shape[dim]} does not split "
                f"over {axes} ({n} ranks)")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x


def as_local(x, mesh, spec):
    """The local block of `x` under `spec`: a DTensor is redistributed to
    `spec` and its local shard taken; a plain tensor is the global value
    (the same on every rank) and is sliced."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh,
                              placements(mesh, spec)).to_local()
    return local_block(x, mesh, spec)


def as_global(local, mesh, spec, shape=None):
    """The DTensor whose local shard is `local` under `spec`
    (`DTensor.from_local`, differentiable)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh.device_mesh,
                              placements(mesh, spec), run_check=False,
                              shape=shape, stride=None if shape is None
                              else _contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _place(x, mesh, spec):
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    device = mesh.device_type
    local = local_block(x, mesh, spec).to(device).contiguous()
    return as_global(local, mesh, spec, shape=x.shape)


def shard_batch(batch, mesh, strategy: ShardingStrategy):
    """Place a host-global batch tree (the same on every rank) onto the
    mesh: each leaf a DTensor split over the data (and sequence) axes,
    whose local shard is this rank's block, on the mesh's device."""
    from ray_tpu_torch.parallel.compile_cache import _tree_map

    def place(x):
        spec = batch_spec(strategy, extra_dims=max(0, x.ndim - 1))
        return _place(x, mesh, spec)

    return _tree_map(place, batch)


def sharding_constraint(x, mesh, spec):
    """`lax.with_sharding_constraint`: a DTensor is redistributed to
    `spec`; anything else (a local shard inside a sharded step, whose
    layout the step fixes) is returned as it is, as the JAX function is a
    no-op outside jit/mesh."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh, placements(mesh, spec))
    return x


def logical_to_mesh(logical: tuple, rules) -> PartitionSpec:
    """The mesh spec of a parameter's logical axes under `rules` (flax's
    `logical_to_mesh`: the first rule of each name; a mesh axis already
    taken by an earlier dimension leaves the later one replicated)."""
    table: Dict[str, object] = {}
    for name, axes in rules:
        table.setdefault(name, axes)
    used: set = set()
    out = []
    for name in logical:
        axes = _entry_axes(table.get(name)) if name is not None else ()
        if used.intersection(axes):
            axes = ()
        used.update(axes)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return PartitionSpec(*out)


def param_shardings(mesh, abstract_params, rules) -> Dict[str, tuple]:
    """DTensor placements for each parameter: `abstract_params` maps each
    name to its logical axes (the model's table, in the torch tensor's
    dimension order; the flax metadata's counterpart), `rules` is
    `logical_axis_rules(strategy)`. Unannotated names (None) replicate."""
    return {name: placements(mesh, logical_to_mesh(tuple(axes or ()), rules))
            for name, axes in abstract_params.items()}


def shard_params(params, mesh, shardings):
    """`jax.device_put(params, shardings)`: each full tensor of `params`
    (the same on every rank) as a DTensor with `shardings[name]`, its
    local shard sliced here, on the mesh's device."""
    return {name: _place(x, mesh, spec_of(mesh, shardings[name], x.ndim))
            for name, x in params.items()}
