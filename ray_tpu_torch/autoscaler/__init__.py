"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Reference: `python/ray/autoscaler/` (v1 StandardAutoscaler + v2
reconciler; SURVEY.md §2.8). Slice-aware: TPU pod slices scale up and
down as atomic multi-host instances.

The port's copy of `ray_tpu/autoscaler/`: slices are the port's GPU
slices, and `FakeMultiNodeProvider` launches nodes as local raylets of
a `ray_tpu_torch._private.node.Cluster`.
"""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler
from ray_tpu_torch.autoscaler.gcp_tpu import (
    GCEMetadataTransport,
    TPUQueuedResourceProvider,
    bootstrap_script,
)
from ray_tpu_torch.autoscaler.node_provider import (
    FakeMultiNodeProvider,
    Instance,
    NodeProvider,
    NodeType,
)

__all__ = ["Autoscaler", "FakeMultiNodeProvider", "GCEMetadataTransport",
           "Instance", "NodeProvider", "NodeType",
           "TPUQueuedResourceProvider", "bootstrap_script"]
