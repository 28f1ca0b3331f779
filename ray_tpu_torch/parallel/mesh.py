"""Device meshes over a torch.distributed process group.

Port of `ray_tpu/parallel/mesh.py`. The axes are named as there (`dp`,
`fsdp`, `tp`, `sp`, `pp`, `ep`; `dcn` outermost in a hybrid mesh) and a
strategy is a set of shardings over those names. A device of the JAX
mesh is a rank of the process group here: one process per card (NCCL),
or per CPU process (gloo). `build_mesh` lays the ranks out row-major
over the axes, as the JAX package lays out its CPU devices, and builds a
`torch.distributed.device_mesh.DeviceMesh` with the axis names (one
process group per axis). The port's `Mesh` carries that `DeviceMesh`
with the JAX view of it (`shape` as a dict, `axis_names`, `devices` as
the array of ranks) and the process groups of axis tuples (a batch split
over `("dp", "fsdp")` reduces over both at once).

Every rank of the default process group builds the same meshes in the
same order (new groups are collective), as every process of a JAX
program builds the same `Mesh`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass
class MeshConfig:
    """Named mesh axes. At most one axis may be -1 (inferred from the device
    count, like a reshape)."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolved(self, n_devices: int) -> Dict[str, int]:
        axes = {k: v for k, v in self.axes.items()}
        unknown = [k for k, v in axes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = int(np.prod([v for v in axes.values() if v != -1])) if axes else 1
        if unknown:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known}"
                )
            axes[unknown[0]] = n_devices // known
        total = int(np.prod(list(axes.values()))) if axes else 1
        if total != n_devices:
            raise ValueError(
                f"mesh axes {axes} use {total} devices but {n_devices} present"
            )
        return axes

    @classmethod
    def data_parallel(cls) -> "MeshConfig":
        return cls({"dp": -1})

    @classmethod
    def fsdp(cls) -> "MeshConfig":
        return cls({"fsdp": -1})


def mesh_shape_for(
    n_devices: int,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
) -> Dict[str, int]:
    """Build an axes dict, inferring `dp` when it is left at 1 and devices
    remain (so `mesh_shape_for(8, tp=2)` -> dp=4, tp=2)."""
    fixed = fsdp * tp * sp * pp * ep * dp
    if fixed != n_devices:
        if dp == 1 and n_devices % (fsdp * tp * sp * pp * ep) == 0:
            dp = n_devices // (fsdp * tp * sp * pp * ep)
        else:
            raise ValueError(
                f"axes dp={dp} fsdp={fsdp} tp={tp} sp={sp} pp={pp} ep={ep} "
                f"do not factor {n_devices} devices"
            )
    axes = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp, "pp": pp, "ep": ep}
    return {k: v for k, v in axes.items() if v > 1} or {"dp": 1}


Axes = Union[str, Sequence[str]]


class Mesh:
    """A `DeviceMesh` seen as a JAX mesh.

    `device_mesh` is the torch mesh (DTensor placements refer to it);
    `devices` the array of global ranks, of shape `shape.values()`;
    `shape` maps each axis name to its size, as `jax.sharding.Mesh.shape`
    does. An axis the mesh does not have counts as size 1 in
    `axis_size`, and `group` returns None for axes of size 1 in all:
    a collective over them is the identity, as XLA emits none for a
    size-1 mesh axis."""

    def __init__(self, device_mesh, devices: np.ndarray,
                 axis_names: Tuple[str, ...]):
        self.device_mesh = device_mesh
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device_type = device_mesh.device_type
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.ravel().tolist()})"

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if a in self.shape)

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along `axes` (row-major over a tuple; 0 for
        axes the mesh lacks), the counterpart of `lax.axis_index`."""
        import torch.distributed as dist

        rank = dist.get_rank()
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self!r}")
        coords = dict(zip(self.axis_names, where[0]))
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + int(coords[a])
        return idx

    def group(self, axes: Axes):
        """The process group of this rank's members along `axes`, or None
        when they are one rank. A tuple's groups are made at its first
        use, by every rank (the same SPMD order on all)."""
        import torch.distributed as dist

        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            order = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(self.devices.ndim) if i not in order]
            lists = np.transpose(self.devices, rest + order).reshape(
                -1, self.axis_size(axes))
            mine, _ = dist.new_subgroups_by_enumeration(
                [[int(r) for r in ranks] for ranks in lists])
            self._groups[axes] = mine
        return self._groups[axes]


def _world_ranks(devices) -> list:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "ray_tpu_torch.parallel: a mesh needs a process group; call "
            "initialize_torch_distributed (or torch.distributed."
            "init_process_group) first")
    if devices is None:
        return list(range(dist.get_world_size()))
    return [int(d) for d in devices]


def _device_type(device) -> str:
    from ray_tpu_torch import resolve_device

    return resolve_device(device).type


def _make_mesh(ranks: np.ndarray, names: Tuple[str, ...], device) -> Mesh:
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(_device_type(device), torch.as_tensor(ranks),
                    mesh_dim_names=names)
    return Mesh(dm, ranks, names)


def build_mesh(
    config: MeshConfig | Dict[str, int],
    devices: Optional[Sequence[int]] = None,
    *,
    device=None,
) -> Mesh:
    """A mesh of `config`'s axes over `devices` (global ranks; default
    every rank of the group), row-major. `device` (the port's own) is
    where the mesh's tensors live: ``"cuda"`` by default, ``"cpu"`` for a
    gloo group on the host."""
    if isinstance(config, dict):
        config = MeshConfig(config)
    ranks = _world_ranks(devices)
    axes = config.resolved(len(ranks))
    names = tuple(axes.keys())
    return _make_mesh(np.asarray(ranks).reshape(tuple(axes.values())),
                      names, device)


def build_hybrid_mesh(
    ici_axes: Dict[str, int],
    dcn_axes: Dict[str, int],
    devices: Optional[Sequence[int]] = None,
    *,
    device=None,
) -> Mesh:
    """Hybrid ICI x DCN mesh for multislice: the dcn axes are OUTERMOST,
    so a collective over an ici axis stays inside one slice's block of
    ranks and only dcn-axis collectives (the data-parallel gradient
    reduction) cross slices. The ranks are partitioned into contiguous
    blocks, one block playing each slice (the JAX package's CPU layout)."""
    ranks = _world_ranks(devices)
    ici_shape = tuple(ici_axes.values())
    dcn_shape = tuple(dcn_axes.values())
    n_slices = int(np.prod(dcn_shape)) if dcn_shape else 1
    per_slice = int(np.prod(ici_shape)) if ici_shape else 1
    if n_slices * per_slice != len(ranks):
        raise ValueError(
            f"hybrid mesh {dcn_axes} x {ici_axes} needs "
            f"{n_slices * per_slice} devices, have {len(ranks)}")
    names = tuple(dcn_axes.keys()) + tuple(ici_axes.keys())
    return _make_mesh(np.asarray(ranks).reshape(dcn_shape + ici_shape),
                      names, device)


def slice_info() -> dict:
    """The CUDA devices of this host (the JAX function reports the TPU
    slice's): platform, device count, hosts in the process group's world
    (one when there is no group) and the device kind."""
    import torch
    import torch.distributed as dist

    n = torch.cuda.device_count()
    info = {
        "platform": "gpu" if n else "cpu",
        "num_devices": n,
        "num_hosts": 1,
        "device_kind": torch.cuda.get_device_name(0) if n else "cpu",
    }
    if dist.is_initialized():
        info["world_size"] = dist.get_world_size()
    return info
