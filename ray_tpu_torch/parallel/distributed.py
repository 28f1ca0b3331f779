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

`run_local` needs no runtime: it starts a group's ranks as processes of
this host (one card each; several on one card over gloo; or gloo CPU
ranks) around one function.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import shutil
import socket
import tempfile
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


def _local_rank(rank, fn, world_size, device, backend, store):
    import torch
    import torch.distributed as dist

    with open(store + ".args", "rb") as f:
        args = pickle.load(f)

    kw = {}
    if device == "cuda":
        card = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(card)
        if backend == "nccl":
            # bound to its card, the group makes its communicators at
            # once, not at its first collective (which a graph may be
            # capturing)
            kw["device_id"] = card
    else:
        # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{store}.result.{rank}", "wb") as f:
        pickle.dump(result, f)


def run_local(fn, world_size: int, *, device: str = "cuda",
              backend: Optional[str] = None, args=(),
              timeout: float = 2 * TIMEOUT_S) -> list:
    """`fn(*args)` in `world_size` new processes of this host, the ranks of
    one process group: every rank's return value, by rank. On ``"cuda"``
    the group is NCCL and rank i takes card i: with fewer visible cards
    than ranks this raises (there is no fallback to the CPU); with
    ``backend="gloo"`` every rank takes card 0 (several ranks on one
    card, gloo moving its tensors through the host). On ``"cpu"`` the
    ranks are gloo processes sharing the host's cores. The rendezvous is
    a file store in a temporary directory. A rank's error is raised here
    (the others are stopped); at `timeout` seconds every rank is killed.
    `fn` must be importable by name (a module-level function)."""
    import torch
    import torch.multiprocessing as mp

    if device not in ("cuda", "cpu"):
        raise ValueError(f"run_local: unsupported device {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend, device) == ("nccl",
                                                                "cpu"):
        raise ValueError(f"run_local: backend {backend!r} on {device}")
    cards = world_size if backend == "nccl" else 1
    if device == "cuda" and torch.cuda.device_count() < cards:
        raise RuntimeError(
            f"run_local: {world_size} ranks need {cards} "
            f"card{'s' if cards > 1 else ''} ({backend}); "
            f"{torch.cuda.device_count()} visible")
    tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_local_")
    store = os.path.join(tmp, "store")
    # the arguments go through a file: a few MiB passed to the spawn
    # itself delayed every rank's start by seconds
    with open(store + ".args", "wb") as f:
        pickle.dump(args, f)
    ctx = mp.start_processes(_local_rank,
                             args=(fn, world_size, device, backend, store),
                             nprocs=world_size, join=False,
                             start_method="spawn")
    try:
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"run_local: {world_size} ranks outlived "
                                   f"{timeout} s")
        results = []
        for rank in range(world_size):
            with open(f"{store}.result.{rank}", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
