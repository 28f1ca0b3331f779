"""Backend plugin ABC + the torch backend.

Port of `ray_tpu/train/backend.py`: `BackendConfig` and `Backend` as they
are there, and `TorchConfig` / `_TorchBackend` in place of `JaxConfig` /
`_JaxBackend` (reference: `python/ray/train/backend.py:16,32` and
`python/ray/train/torch/config.py:150`, `_TorchBackend.on_start`). Rank 0
picks a port, the executor hands ``tcp://host:port`` to every worker, and
each calls ``torch.distributed.init_process_group(backend, init_method=,
world_size=, rank=)``: NCCL when the worker's platform is ``cuda``, gloo
on ``cpu``. `TorchConfig` has no counterpart of `JaxConfig.xla_flags`.

Torch is imported inside the functions that run in the workers, never
here: the train controller and Tune's trial actors import this module
without it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    """Base backend config; subclass per framework."""

    @property
    def backend_cls(self):
        return Backend

    def worker_env(self) -> Dict[str, str]:
        """Env vars to set in worker processes before anything imports
        torch."""
        return {}


class Backend:
    """Hooks called by the BackendExecutor around training."""

    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: "WorkerGroup",
                          backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: BackendConfig) -> None:
        pass


# ---------------------------------------------------------------------------
# torch.distributed
# ---------------------------------------------------------------------------

# seconds a rendezvous (and each collective's NCCL/gloo timeout) may take
RENDEZVOUS_TIMEOUT_S = 300.0


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """Config for the torch backend.

    distributed: "auto" forms a process group only when there is more
        than one worker AND the workers see the accelerator (platform
        ``cuda``); "on" forces a group (NCCL on ``cuda``, gloo on
        ``cpu``), "off" never forms one. The meanings are `JaxConfig`'s.
    coordinator_port: fixed port for rank 0's rendezvous (0 = pick free).
    platform: ``"cuda"`` or ``"cpu"``; None takes ``cuda`` when the
        worker sees a GPU, else ``cpu``. A worker asked for ``cuda`` that
        sees no GPU raises.
    """

    distributed: str = "auto"
    coordinator_port: int = 0
    platform: Optional[str] = None

    def __post_init__(self):
        if self.distributed not in ("auto", "on", "off"):
            raise ValueError(
                f"TorchConfig.distributed must be 'auto', 'on' or 'off', "
                f"got {self.distributed!r}")
        if self.platform not in (None, "cuda", "cpu"):
            raise ValueError(
                f"TorchConfig.platform must be 'cuda', 'cpu' or None, got "
                f"{self.platform!r}")

    @property
    def backend_cls(self):
        return _TorchBackend


def _worker_platform(platform: Optional[str]) -> str:
    """The platform this worker trains on: the asked one, checked, or
    ``cuda`` when it sees a GPU."""
    import torch

    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchConfig(platform='cuda'): this train worker sees no CUDA "
            f"device (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); give it a GPU "
            "(ScalingConfig(use_gpu=True)) or ask for platform='cpu'")
    if platform is not None:
        return platform
    return "cuda" if torch.cuda.is_available() else "cpu"


def _init_torch_distributed(init_method: str, world_size: int, rank: int,
                            platform: str) -> str:
    import datetime

    import torch
    import torch.distributed as dist

    if platform == "cuda":
        # a GPU worker sees exactly its own card(s) through
        # CUDA_VISIBLE_DEVICES, so its card is always cuda:0, whatever
        # its local rank
        torch.cuda.set_device(0)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        # a reused process with a group from an earlier run: leave it
        # and join the new rendezvous
        dist.destroy_process_group()
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return f"{dist.get_rank()}/{dist.get_world_size()}"


def _destroy_torch_distributed() -> None:
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: TorchConfig) -> None:
        cfg = backend_config
        n = len(worker_group)
        want = cfg.distributed
        if cfg.platform != "cuda" and (
                want == "off" or (want == "auto" and n == 1)):
            # no group to form, and nothing to check: only a `cuda`
            # platform is probed (its workers must see a GPU). Probing
            # imports torch in every worker, seconds on a cold host
            # before the loop starts, as the JAX backend never does here
            return
        platforms = worker_group.execute(_worker_platform, cfg.platform)
        if want == "off" or (want == "auto" and (
                n == 1 or platforms[0] != "cuda")):
            return
        # Rendezvous: rank 0 picks the port, everyone joins.
        port = cfg.coordinator_port or worker_group.execute_single(
            0, _free_port_fn)
        hosts = worker_group.execute(_hostname_fn)
        # one host: the loopback address, which needs no name lookup
        host = "127.0.0.1" if len(set(hosts)) == 1 else hosts[0]
        init_method = f"tcp://{host}:{port}"
        import ray_tpu_torch
        refs = [
            w.execute.remote(_init_torch_distributed, init_method, n, rank,
                             platforms[0])
            for rank, w in enumerate(worker_group.workers)
        ]
        ray_tpu_torch.get(refs, timeout=RENDEZVOUS_TIMEOUT_S)

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: TorchConfig) -> None:
        import ray_tpu_torch
        refs = [w.execute.remote(_destroy_torch_distributed)
                for w in worker_group.workers]
        for ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception:  # noqa: BLE001 — a dead or wedged worker
                # is killed with its group right after this
                pass


def _free_port_fn() -> int:
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _hostname_fn() -> str:
    import socket
    return socket.gethostname()
