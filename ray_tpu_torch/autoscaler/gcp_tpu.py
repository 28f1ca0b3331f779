"""GCE TPU pod-slice node provider (queued-resources API).

Reference: `python/ray/autoscaler/node_provider.py:13` (the pluggable
NodeProvider ABC) + `python/ray/autoscaler/_private/gcp/node_provider.py`
(the GCP implementation) — re-designed TPU-first: the launchable unit is
a WHOLE pod slice via the TPU v2 `queuedResources` API (one create call
provisions every host of a v5e-16/v4-32/... slice atomically, matching
the scheduler's slice-atomic gang placement), not individual VMs.

Cloud access is injected: the provider talks to a `transport` —
`request(method, url, body) -> dict` — so unit tests drive the full
provider/reconciler path against a fake API surface, and production
supplies `GCEMetadataTransport` (OAuth token from the metadata server).

Host join flow (the reference's SSH command_runner equivalent, without
SSH): each TPU VM's cloud-init startup script starts a raylet pointed at
the head GCS with an `autoscaler_instance` label naming its queued
resource. The autoscaler matches registered raylets back to provider
instances by that label, so booting capacity is attributed to the
instance that launched it and slices retire atomically.

The port's copy of `ray_tpu/autoscaler/gcp_tpu.py`, with its names and
its injected `transport`: the tests drive it against a fake API whose
hosts are the port's GPU slices (`Cluster.add_slice`), with no network.
`bootstrap_script` starts a host with `python -m
ray_tpu_torch.scripts.cli start --address ... --labels ...`, the port's
CLI, which detects the host's GPUs.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    Instance,
    NodeProvider,
    NodeType,
)

logger = logging.getLogger(__name__)

INSTANCE_LABEL = "autoscaler_instance"

#: queued-resource states that still hold (or will hold) capacity
_LIVE_STATES = ("ACCEPTED", "PROVISIONING", "CREATING", "ACTIVE",
                "WAITING_FOR_RESOURCES")


def bootstrap_script(gcs_addr: str, instance_id: str) -> str:
    """Per-host startup script: join the cluster as a raylet labeled with
    the owning queued resource (reference `_private/command_runner.py`'s
    job, delivered via cloud-init instead of SSH). TPU chips are
    auto-detected on the VM (accelerators.py), so only the address and
    the instance label travel in."""
    labels = json.dumps({INSTANCE_LABEL: instance_id})
    return (
        "#!/bin/bash\n"
        "# ray_tpu_torch TPU-VM bootstrap (generated)\n"
        f"python -m ray_tpu_torch.scripts.cli start --address {gcs_addr} "
        f"--labels '{labels}'\n"
    )


class GCEMetadataTransport:
    """Production transport: bearer token from the GCE metadata server,
    cached until near expiry (tokens live ~1h; the reconcile loop runs
    every ~2s). Untestable in this environment (zero egress) — the
    provider logic is covered through the injected fake transport
    instead."""

    _TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                  "instance/service-accounts/default/token")

    def __init__(self):
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    def _get_token(self) -> str:
        import time
        import urllib.request

        if self._token is not None and \
                time.monotonic() < self._token_expiry:
            return self._token
        tok_req = urllib.request.Request(
            self._TOKEN_URL, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(tok_req, timeout=10) as r:
            payload = json.loads(r.read())
        self._token = payload["access_token"]
        # refresh 60s early
        self._token_expiry = time.monotonic() + \
            max(0, int(payload.get("expires_in", 0)) - 60)
        return self._token

    def request(self, method: str, url: str,
                body: Optional[dict] = None) -> dict:
        import urllib.request

        token = self._get_token()
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Authorization": f"Bearer {token}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            payload = r.read()
        return json.loads(payload) if payload else {}


class TPUQueuedResourceProvider(NodeProvider):
    """Slice instances through `projects.locations.queuedResources`.

    `node_type.slice_type` is the accelerator type string (e.g.
    "v5litepod-16" / "v5e-16"); one `create_node` equals one queued
    resource equals one whole slice. Instances report empty `node_ids` —
    raylets are matched by the INSTANCE_LABEL they register with (the
    autoscaler's label-resolution path).
    """

    _API = "https://tpu.googleapis.com/v2"

    def __init__(self, project: str, zone: str, gcs_addr: str,
                 runtime_version: str = "tpu-ubuntu2204-base",
                 transport=None, name_prefix: str = "raytpu"):
        self.project = project
        self.zone = zone
        self.gcs_addr = gcs_addr
        self.runtime_version = runtime_version
        self.transport = transport or GCEMetadataTransport()
        self.name_prefix = name_prefix
        self._counter = 0
        #: queued-resource name -> node type name (the API echoes labels
        #: back, so a restarted autoscaler recovers this mapping)
        self._types: Dict[str, str] = {}

    def _parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    # -- NodeProvider ----------------------------------------------------

    def create_node(self, node_type: NodeType) -> Instance:
        if not node_type.slice_type:
            raise ValueError(
                "TPUQueuedResourceProvider launches pod slices only; "
                f"node type {node_type.name!r} has no slice_type")
        self._counter += 1
        # random suffix: a restarted provider's counter restarts at 1,
        # and reusing a live queuedResourceId is a 409 that would wedge
        # scale-up permanently
        import os as _os
        qr_id = (f"{self.name_prefix}-{node_type.name}-{self._counter}"
                 f"-{_os.urandom(2).hex()}")
        body = {
            "tpu": {"nodeSpec": [{
                "parent": self._parent(),
                "nodeId": qr_id,
                "node": {
                    "acceleratorType": node_type.slice_type,
                    "runtimeVersion": self.runtime_version,
                    "labels": {INSTANCE_LABEL: qr_id,
                               "node_type": node_type.name},
                    "metadata": {
                        "startup-script": bootstrap_script(
                            self.gcs_addr, qr_id),
                    },
                },
            }]},
            "queueingPolicy": {},
        }
        url = (f"{self._API}/{self._parent()}/queuedResources"
               f"?queuedResourceId={qr_id}")
        self.transport.request("POST", url, body)
        logger.info("queued TPU slice %s (%s)", qr_id,
                    node_type.slice_type)
        self._types[qr_id] = node_type.name
        return Instance(qr_id, node_type.name, node_ids=[])

    def terminate_node(self, instance: Instance) -> None:
        url = (f"{self._API}/{self._parent()}/queuedResources/"
               f"{instance.instance_id}?force=true")
        self.transport.request("DELETE", url, None)
        self._types.pop(instance.instance_id, None)
        logger.info("deleted TPU slice %s", instance.instance_id)

    def non_terminated_nodes(self) -> List[Instance]:
        base = f"{self._API}/{self._parent()}/queuedResources"
        qrs: List[dict] = []
        page_token = None
        while True:
            url = base + (f"?pageToken={page_token}" if page_token else "")
            reply = self.transport.request("GET", url, None)
            qrs.extend(reply.get("queuedResources", []))
            page_token = reply.get("nextPageToken")
            if not page_token:
                break
        out: List[Instance] = []
        for qr in qrs:
            state = qr.get("state", {}).get("state", "")
            if state not in _LIVE_STATES:
                continue
            name = qr["name"].rsplit("/", 1)[-1]
            ntype = self._types.get(name)
            if ntype is None:
                # recover the mapping from the echoed node labels (e.g.
                # after an autoscaler restart)
                try:
                    ntype = qr["tpu"]["nodeSpec"][0]["node"]["labels"][
                        "node_type"]
                    self._types[name] = ntype
                except (KeyError, IndexError):
                    continue  # not one of ours
            out.append(Instance(name, ntype, node_ids=[]))
        return out
