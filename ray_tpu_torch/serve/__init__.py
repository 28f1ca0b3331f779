"""ray_tpu_torch.serve — online model serving.

Reference: `python/ray/serve/` (SURVEY.md §2.4): declarative deployments
reconciled by a controller actor into replica actors; pow-2 routed handles;
request-rate autoscaling; batching; HTTP and gRPC proxies; the native
request ring (`dispatch.py`).

The port's copy of `ray_tpu/serve/__init__.py`, module for module.
Importing it imports no torch: `serve.llm` (the engine) loads lazily, and
only replicas of an LLM deployment pay for torch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import dispatch as _dispatch
from ray_tpu_torch.serve.asgi import ingress
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.schema import build, build_yaml, deploy_config
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentConfig,
    deployment,
)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    RequestTimeoutError,
)
from ray_tpu_torch.serve.multiplex import (
    get_multiplexed_model_id,
    multiplexed,
)


def __getattr__(name: str):
    # `serve.llm` pulls in torch + the model zoo; load it lazily so plain
    # serving (and `import ray_tpu_torch`) stays light (PEP 562)
    if name == "llm":
        import ray_tpu_torch.serve.llm as _llm
        return _llm
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

_state: Dict[str, Any] = {"controller": None, "proxy": None}


def _get_or_start_controller():
    if _state["controller"] is not None:
        return _state["controller"]
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        cls = ray_tpu_torch.remote(ServeController)
        ctrl = cls.options(name=CONTROLLER_NAME, lifetime="detached",
                           max_concurrency=8, num_cpus=0).remote()
        # fire-and-forget reconcile loop (health checks + autoscaling)
        ctrl.run_control_loop.remote()
    _state["controller"] = ctrl
    return ctrl


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", _blocking: bool = False,
        http_port: int = 0, grpc_port: int = 0) -> DeploymentHandle:
    """Deploy an application graph; returns the ingress handle
    (reference `python/ray/serve/api.py:545`)."""
    ctrl = _get_or_start_controller()
    nodes = app._flatten()
    handles: Dict[int, DeploymentHandle] = {}
    for node in nodes:
        dep = node.deployment
        # composed Applications become handles of already-deployed deps
        def resolve(v):
            if isinstance(v, Application):
                return handles[id(v)]
            return v
        init_args = tuple(resolve(a) for a in node.init_args)
        init_kwargs = {k: resolve(v) for k, v in node.init_kwargs.items()}
        is_ingress = node is nodes[-1]
        ray_tpu_torch.get(ctrl.deploy.remote(
            dep.name, dep.func_or_class, init_args, init_kwargs,
            dep.config,
            (route_prefix if is_ingress else dep.route_prefix),
        ), timeout=120)
        handles[id(node)] = DeploymentHandle(ctrl, dep.name)
    ingress = nodes[-1]
    if http_port:
        _start_proxy(http_port)
    if grpc_port:
        _start_grpc_proxy(grpc_port)
    return handles[id(ingress)]


HTTP_PROXY_NAME = "SERVE_HTTP_PROXY"


def _start_proxy(port: int):
    from ray_tpu_torch.serve.proxy import HTTPProxy
    if _state["proxy"] is not None:
        return
    # detached + named, like the controller: the serve instance (and the
    # `serve-deploy` CLI's ingress in particular) must outlive the driver
    # job that started it
    proxy = None
    try:
        proxy = ray_tpu_torch.get_actor(HTTP_PROXY_NAME)
    except Exception:
        pass  # no live proxy actor: start one
    if proxy is not None:
        info = ray_tpu_torch.get(proxy.ready.remote(), timeout=30)
        if info.get("port") != port:
            raise ValueError(
                f"a Serve HTTP proxy already listens on port "
                f"{info.get('port')}; cannot start another on {port} "
                "(serve.shutdown() first, or reuse the existing port)")
        _state["proxy"] = proxy
        return
    cls = ray_tpu_torch.remote(HTTPProxy)
    proxy = cls.options(name=HTTP_PROXY_NAME, lifetime="detached",
                        max_concurrency=16, num_cpus=0).remote(
        _state["controller"], "127.0.0.1", port)
    ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    ray_tpu_torch.get(_state["controller"].register_proxy.remote(proxy),
                timeout=30)
    _state["proxy"] = proxy


def _start_grpc_proxy(port: int) -> Dict[str, Any]:
    """gRPC ingress (reference `_private/proxy.py:534` gRPCProxy);
    returns {"host", "port"} with the bound port."""
    from ray_tpu_torch.serve.grpc_proxy import GRPCProxy
    if _state.get("grpc_proxy") is not None:
        return ray_tpu_torch.get(_state["grpc_proxy"].ready.remote(),
                           timeout=30)
    cls = ray_tpu_torch.remote(GRPCProxy)
    proxy = cls.options(max_concurrency=16, num_cpus=0).remote(
        _state["controller"], "127.0.0.1", port)
    info = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    ray_tpu_torch.get(_state["controller"].register_proxy.remote(proxy),
                timeout=30)
    _state["grpc_proxy"] = proxy
    return info


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(_get_or_start_controller(), deployment_name)


def status() -> Dict[str, Any]:
    ctrl = _get_or_start_controller()
    return ray_tpu_torch.get(ctrl.list_deployments.remote(), timeout=30)


def delete(deployment_name: str) -> None:
    ctrl = _get_or_start_controller()
    ray_tpu_torch.get(ctrl.delete_deployment.remote(deployment_name),
                      timeout=60)


def shutdown() -> None:
    ctrl = _state.get("controller")
    if ctrl is None:
        try:
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            ctrl = None
    if ctrl is not None:
        try:
            ray_tpu_torch.get(ctrl.shutdown.remote(), timeout=60)
            ray_tpu_torch.kill(ctrl)
        except Exception:
            pass
    for key in ("proxy", "grpc_proxy"):
        if _state.get(key) is not None:
            try:
                ray_tpu_torch.kill(_state[key])
            except Exception:
                pass
        elif key == "proxy":
            # detached proxy from another driver (e.g. serve-deploy CLI)
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(HTTP_PROXY_NAME))
            except Exception:
                pass
    _state["controller"] = None
    _state["proxy"] = None
    _state["grpc_proxy"] = None
    # this process's response ring goes with the deployments it served
    _dispatch.close_client_plane()


__all__ = [
    "multiplexed",
    "get_multiplexed_model_id",
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "batch",
    "build",
    "build_yaml",
    "delete",
    "deploy_config",
    "deployment",
    "get_deployment_handle",
    "RequestTimeoutError",
    "ingress",
    "llm",
    "run",
    "shutdown",
    "status",
]
