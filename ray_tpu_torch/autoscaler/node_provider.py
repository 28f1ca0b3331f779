"""Node providers: how the autoscaler launches and kills machines.

Reference: `python/ray/autoscaler/node_provider.py:13` (the pluggable
NodeProvider ABC — AWS/GCP/... implementations) and the test harness
`python/ray/autoscaler/_private/fake_multi_node/node_provider.py`, which
realizes "cloud nodes" as local processes. The TPU deployment analogue
of a node type is a pod slice: a node type may declare `slice_type` and
`num_hosts`, and creating one instance brings up every host of a slice
(the gang the scheduler places on atomically).

The port's copy of `ray_tpu/autoscaler/node_provider.py`. A slice is the
port's GPU slice (`Cluster.add_slice`): each host carries
`resources["GPU"]` GPUs where the JAX package's carries `"TPU"` chips.
`FakeMultiNodeProvider.terminate_node` stops the instance's raylets,
and each raylet its workers, so a GPU node's card memory comes back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class NodeType:
    """A launchable shape (reference: available_node_types in the
    cluster YAML)."""

    name: str
    resources: Dict[str, float]
    max_workers: int = 10
    # GPU-slice node types: one instance = num_hosts raylets
    # carrying slice labels (scheduling.place_slice_bundles gang-places
    # onto them)
    slice_type: Optional[str] = None
    num_hosts: int = 1


@dataclasses.dataclass
class Instance:
    instance_id: str
    node_type: str
    node_ids: List[str]  # hex raylet node ids (slice: one per host)


class NodeProvider:
    """ABC. Implementations own machine lifecycle only — joining the
    cluster is the raylet's own registration path."""

    def create_node(self, node_type: NodeType) -> Instance:
        raise NotImplementedError

    def terminate_node(self, instance: Instance) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Instance]:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Fake cloud: every instance is a local raylet process (or a group
    of them for slice types) joined to an existing GCS — the test
    mechanism for autoscaling logic without machines."""

    def __init__(self, cluster):
        # `cluster` is a ray_tpu_torch._private.node.Cluster owning the
        # GCS
        self._cluster = cluster
        self._instances: Dict[str, Instance] = {}
        self._handles: Dict[str, list] = {}
        self._counter = 0

    def create_node(self, node_type: NodeType) -> Instance:
        self._counter += 1
        iid = f"fake-{node_type.name}-{self._counter}"
        if node_type.slice_type:
            handles = self._cluster.add_slice(
                node_type.slice_type, node_type.num_hosts,
                gpus_per_host=int(
                    node_type.resources.get("GPU", 4)),
                cpus_per_host=node_type.resources.get("CPU", 1.0),
                name=iid)
        else:
            handles = [self._cluster.add_node(dict(node_type.resources))]
        inst = Instance(iid, node_type.name,
                        [h.node_id_hex for h in handles])
        self._instances[iid] = inst
        self._handles[iid] = handles
        return inst

    def terminate_node(self, instance: Instance) -> None:
        for handle in self._handles.pop(instance.instance_id, []):
            if handle in self._cluster.nodes:
                self._cluster.remove_node(handle)
        self._instances.pop(instance.instance_id, None)

    def non_terminated_nodes(self) -> List[Instance]:
        return list(self._instances.values())
