"""Deployment declarations.

Reference: `python/ray/serve/api.py:248` (`@serve.deployment`),
`python/ray/serve/deployment.py:87` (`Deployment`). A Deployment is a
declarative spec; `.bind()` produces an Application node whose init args
may contain other Applications (model composition); `serve.run` hands the
graph to the controller.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """Reference: `python/ray/serve/config.py` AutoscalingConfig."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    user_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    health_check_period_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 config: DeploymentConfig, route_prefix: Optional[str]):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config
        self.route_prefix = route_prefix

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        route = self.route_prefix
        name = self.name
        for k, v in kwargs.items():
            if k == "name":
                name = v
            elif k == "route_prefix":
                route = v
            elif k == "autoscaling_config" and isinstance(v, dict):
                cfg.autoscaling_config = AutoscalingConfig(**v)
            elif hasattr(cfg, k):
                setattr(cfg, k, v)
            else:
                raise ValueError(f"unknown deployment option {k!r}")
        return Deployment(self.func_or_class, name, cfg, route)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment(name={self.name!r})"


class Application:
    """A bound deployment DAG node (reference `serve.built_application`)."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    def _flatten(self, out: Optional[List["Application"]] = None
                 ) -> List["Application"]:
        """Dependency-first list of all Applications in the graph."""
        if out is None:
            out = []
        for a in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(a, Application) and a not in out:
                a._flatten(out)
        if self not in out:
            out.append(self)
        return out


def deployment(_func_or_class: Optional[Any] = None, *,
               name: Optional[str] = None,
               num_replicas: Optional[int] = None,
               max_ongoing_requests: int = 8,
               autoscaling_config: Optional[Any] = None,
               user_config: Optional[Dict[str, Any]] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               route_prefix: Optional[str] = None):
    """`@serve.deployment` decorator (reference `api.py:248`)."""

    def wrap(target):
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas or 1,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=asc,
            user_config=user_config,
            ray_actor_options=ray_actor_options,
        )
        return Deployment(target, name or target.__name__, cfg,
                          route_prefix)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
