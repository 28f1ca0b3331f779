"""Multi-process torch.distributed bootstrap over the port's control plane.

Port of `ray_tpu/parallel/distributed.py`, with `TorchDistributedConfig`
/ `initialize_torch_distributed` for `JaxDistributedConfig` /
`initialize_jax_distributed`. The GCS KV is the rendezvous store: rank 0
publishes ``host:port`` (a free port of its host), the other ranks read
it, and every rank calls `torch.distributed.init_process_group` with
``tcp://host:port``: NCCL when the group is on the card, gloo on the CPU.
Unlike `jax.distributed`, which a single process skips, a group of one
rank is formed too, so a sharded step's collectives run the same code at
every world size.
"""

from __future__ import annotations

import datetime
import logging
import socket
import time
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)

_NAMESPACE = "torch_coordination"

# seconds the rendezvous (and each collective's NCCL/gloo timeout) may take
TIMEOUT_S = 300.0


@dataclass
class TorchDistributedConfig:
    group_name: str
    world_size: int
    rank: int
    coordinator_port: int = 0  # 0: pick a free port on rank 0
    backend: Optional[str] = None  # None: nccl with a GPU, else gloo


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kv_put(key: str, value: bytes):
    from ray_tpu_torch._private.object_ref import get_core_worker

    cw = get_core_worker()
    cw._run_sync(cw.gcs.call("kv_put", {
        "ns": _NAMESPACE, "key": key.encode(), "value": value,
    }))


def _kv_get(key: str, timeout: float = 120.0) -> Optional[bytes]:
    from ray_tpu_torch._private.object_ref import get_core_worker

    cw = get_core_worker()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reply = cw._run_sync(cw.gcs.call("kv_get", {
            "ns": _NAMESPACE, "key": key.encode(),
        }))
        if reply["value"] is not None:
            return reply["value"]
        time.sleep(0.1)
    return None


def initialize_torch_distributed(cfg: TorchDistributedConfig) -> str:
    """Rendezvous via the GCS KV, then `init_process_group`; returns the
    backend. A rank that already has a group (a reused worker) leaves it
    first."""
    import torch
    import torch.distributed as dist

    key = f"coordinator:{cfg.group_name}"
    if cfg.rank == 0:
        port = cfg.coordinator_port or _free_port()
        host = "127.0.0.1" if cfg.world_size == 1 else \
            socket.gethostbyname(socket.gethostname())
        addr = f"{host}:{port}"
        _kv_put(key, addr.encode())
    else:
        raw = _kv_get(key)
        if raw is None:
            raise RuntimeError(
                f"torch.distributed rendezvous timed out for "
                f"{cfg.group_name}")
        addr = raw.decode()
    backend = cfg.backend or ("nccl" if torch.cuda.is_available()
                              else "gloo")
    if dist.is_initialized():
        dist.destroy_process_group()
    logger.info("init_process_group(%s, tcp://%s, %d, %d)", backend, addr,
                cfg.world_size, cfg.rank)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=cfg.world_size,
        rank=cfg.rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend
