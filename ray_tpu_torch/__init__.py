"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The package mirrors `ray_tpu`'s layout (`_private` runtime, `native`,
`ops`, `parallel`, `models`, `train`, `serve.llm`) with the same module
and function names, so each piece has an obvious counterpart in the JAX
package, which stays the reference the port is tested against. It
imports `torch` and `numpy` only — never `jax`, `flax` or anything of
`ray_tpu` — and this module imports neither: the runtime's daemons (GCS,
raylet) and its CPU workers import the package without paying for torch.

The public API is the runtime's, as in `ray_tpu/__init__.py`: `init`,
`remote`, `get`, `put`, `wait`, actors, placement groups. CUDA devices
are the `GPU` resource (`init(num_gpus=)`, `@remote(num_gpus=1)`): a
worker that holds GPUs sees exactly those through
`CUDA_VISIBLE_DEVICES`, every other worker sees none.

Every compute entry point takes `device=` and defaults to ``"cuda"``.
Only the caller may ask for the CPU (``device="cpu"``, as the tests do);
without a GPU and without that request an entry point raises instead of
quietly running on the host.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

# Lockdep must see every lock the runtime creates, so it installs before
# any other ray_tpu_torch module is imported (worker daemons spawned with
# RAY_TPU_LOCKDEP=1 in their environment self-install the same way).
from ray_tpu_torch._private import lockdep as _lockdep

_lockdep.init_from_env()

from ray_tpu_torch._private.core_worker import (  # noqa: E402
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    ObjectRefGenerator,
    OutOfMemoryError,
    RayTaskError,
    TaskCancelledError,
)
from ray_tpu_torch._private.object_ref import ObjectRef  # noqa: E402
from ray_tpu_torch._private.worker_api import (  # noqa: E402
    ActorClass,
    ActorHandle,
    NodeAffinitySchedulingStrategy,
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    list_actors,
    method,
    nodes,
    placement_group,
    put,
    remote,
    remove_placement_group,
    shutdown,
    wait,
)
from ray_tpu_torch.runtime_context import (  # noqa: E402
    RuntimeContext,
    get_runtime_context,
)

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, "torch.device"]] = None
                   ) -> "torch.device":
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and no GPU is present."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ray_tpu_torch: unsupported device {dev}")
    return dev


__all__ = [
    "ActorClass",
    "ActorDiedError",
    "ActorHandle",
    "GetTimeoutError",
    "NodeAffinitySchedulingStrategy",
    "ObjectLostError",
    "ObjectRef",
    "ObjectRefGenerator",
    "OutOfMemoryError",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "RayTaskError",
    "RuntimeContext",
    "TaskCancelledError",
    "available_resources",
    "cancel",
    "get_runtime_context",
    "cluster_resources",
    "get",
    "get_actor",
    "init",
    "is_initialized",
    "kill",
    "list_actors",
    "method",
    "nodes",
    "placement_group",
    "put",
    "remote",
    "remove_placement_group",
    "resolve_device",
    "shutdown",
    "wait",
]
