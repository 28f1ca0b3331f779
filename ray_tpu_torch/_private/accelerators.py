"""GPU accelerator abstraction: CUDA device detection + slice labels.

The port's own copy of `ray_tpu/_private/accelerators.py`, with CUDA
devices where the JAX package has TPU chips. A node advertises its CUDA
devices as the `GPU` resource (reference:
`python/ray/_private/accelerators/nvidia_gpu.py`, which counts the
devices a process may see). Detection reads the environment and the
device files, never the CUDA driver, so the daemons that detect GPUs
never import torch or initialise CUDA: `RAY_TPU_GPU_COUNT` first (a test
override, as `TPU_CHIP_COUNT` is for TPU chips), then a set
`CUDA_VISIBLE_DEVICES`, then the container runtime's
`NVIDIA_VISIBLE_DEVICES` where it lists devices (a container may hold
more `/dev/nvidia<N>` files than the devices it was given), then the
device files `/dev/nvidia<N>`.

The JAX package's pod-slice topology has no counterpart on one card:
`slice_env()` finds no slice membership in the environment and returns
None. The label-based gang placement stays (raylets carry slice labels
given to them explicitly, `Cluster.add_slice`, and the GCS places
slice-topology placement groups atomically, `scheduling.
place_slice_bundles`), with `GPU` where the JAX package has `TPU`, for
a later multi-GPU slice.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

# label keys carried by every raylet in a slice
LABEL_SLICE_NAME = "ray_tpu.slice_name"
LABEL_SLICE_TYPE = "ray_tpu.slice_type"
LABEL_SLICE_HOST_ID = "ray_tpu.slice_host_id"
LABEL_SLICE_NUM_HOSTS = "ray_tpu.slice_num_hosts"

# test override of the detected count
GPU_COUNT_ENV = "RAY_TPU_GPU_COUNT"
# the host's own CUDA_VISIBLE_DEVICES, kept for the raylet while the
# daemons themselves run with no visible device (node._spawn)
WORKER_VISIBLE_ENV = "RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES"


def num_local_gpus(visible_env: str = "CUDA_VISIBLE_DEVICES") -> int:
    """Detect this host's CUDA device count: the override first, then a
    device list in `visible_env` where it is set ("" is none), then one
    in NVIDIA_VISIBLE_DEVICES, then the device files /dev/nvidia<N>.

    A daemon that `node._spawn` started runs with CUDA_VISIBLE_DEVICES=""
    (daemons never touch a device), so it passes WORKER_VISIBLE_ENV,
    where the host's own setting is kept: a raylet started with no
    resources counts the GPUs it will hand to its workers."""
    env = os.environ.get(GPU_COUNT_ENV)
    if env:
        return int(env)
    visible = os.environ.get(visible_env)
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    given = os.environ.get("NVIDIA_VISIBLE_DEVICES", "").strip()
    if given in ("none", "void"):
        return 0
    if given and given != "all":
        return len([d for d in given.split(",") if d.strip()])
    return len(glob.glob("/dev/nvidia[0-9]*"))


def worker_visible_devices(gpu_ids, base: Optional[str]) -> str:
    """CUDA_VISIBLE_DEVICES of a worker that holds the node's GPUs
    `gpu_ids`: index i names the i-th entry of the host's own setting
    `base` where it has one, else device i."""
    names = [d for d in (base or "").split(",") if d.strip()]
    return ",".join(names[i] if i < len(names) else str(i)
                    for i in gpu_ids)


def head_resource_name(slice_type: str) -> str:
    """`GPU-{slice_type}-head` (the JAX package's `TPU-{pod_type}-head`)."""
    return f"GPU-{slice_type}-head"


def slice_env() -> Optional[Dict[str, str]]:
    """Slice membership labels for this host. One card belongs to no
    slice, and no environment of a GPU host declares one: always None."""
    return None


def slice_resources(labels: Dict[str, str]) -> Dict[str, float]:
    """Extra resources a raylet derives from its slice labels: host 0
    carries the one-per-slice head resource so a driver can target "one
    task per slice" exactly as in the reference convention."""
    if labels.get(LABEL_SLICE_TYPE) is None:
        return {}
    if int(labels.get(LABEL_SLICE_HOST_ID, "0")) != 0:
        return {}
    return {head_resource_name(labels[LABEL_SLICE_TYPE]): 1.0}
