"""Declarative Serve config: build an app to YAML, deploy from YAML.

Reference: `python/ray/serve/schema.py` (ServeDeploySchema /
ServeApplicationSchema) + the `serve build` / `serve deploy` CLI
(`python/ray/serve/scripts.py`). The config names an importable bound
Application (`import_path = "module:attr"`) plus per-deployment
overrides, so operators redeploy by editing config, not code.

Schema (YAML or dict):

    applications:
      - name: default            # application name
        import_path: mymod:app   # module attr holding Application|Deployment
        route_prefix: /          # ingress route
        deployments:             # optional per-deployment overrides
          - name: Api
            num_replicas: 2
            user_config: {...}
            max_ongoing_requests: 16
            autoscaling_config: {min_replicas: 1, max_replicas: 4}
    http_options:                # optional
      port: 8000
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.deployment import Application, Deployment

_OVERRIDABLE = ("num_replicas", "max_ongoing_requests", "user_config",
                "ray_actor_options", "health_check_period_s",
                "graceful_shutdown_timeout_s", "autoscaling_config")


def build(app: Application, *, name: str = "default",
          import_path: str = "", route_prefix: str = "/") -> Dict:
    """Generate the deployable config for a bound application (reference
    `serve build`). `import_path` is where operators' edits of this
    config will re-import the app from; fill it in before deploying."""
    deployments: List[Dict] = []
    for node in app._flatten():
        dep = node.deployment
        entry: Dict[str, Any] = {"name": dep.name}
        cfg = dep.config
        entry["num_replicas"] = cfg.num_replicas
        entry["max_ongoing_requests"] = cfg.max_ongoing_requests
        if cfg.user_config is not None:
            entry["user_config"] = cfg.user_config
        if cfg.autoscaling_config is not None:
            entry["autoscaling_config"] = dataclasses.asdict(
                cfg.autoscaling_config)
        deployments.append(entry)
    return {"applications": [{
        "name": name,
        "import_path": import_path,
        "route_prefix": route_prefix,
        "deployments": deployments,
    }]}


def build_yaml(app: Application, **kwargs) -> str:
    import yaml

    return yaml.safe_dump(build(app, **kwargs), sort_keys=False)


def _clone_app(app: Application,
               memo: Optional[Dict[int, Application]] = None
               ) -> Application:
    """Structure-preserving copy of an Application graph. deploy_config
    applies overrides onto the clone, never onto the module-cached app
    object — otherwise a second deploy in the same process would see the
    previous config's overrides baked in."""
    if memo is None:
        memo = {}
    if id(app) in memo:
        return memo[id(app)]

    def conv(v):
        return _clone_app(v, memo) if isinstance(v, Application) else v

    clone = Application(app.deployment,
                        tuple(conv(a) for a in app.init_args),
                        {k: conv(v) for k, v in app.init_kwargs.items()})
    memo[id(app)] = clone
    return clone


def _import_app(import_path: str) -> Application:
    if ":" not in import_path:
        raise ValueError(
            f"import_path must be 'module:attr', got {import_path!r}")
    mod_name, attr = import_path.split(":", 1)
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    if isinstance(obj, Deployment):
        obj = obj.bind()
    if not isinstance(obj, Application):
        raise TypeError(
            f"{import_path} is {type(obj).__name__}, expected a bound "
            "Application (call .bind()) or a Deployment")
    return _clone_app(obj)


def _apply_overrides(app: Application, overrides: List[Dict]) -> None:
    by_name = {o["name"]: o for o in overrides if "name" in o}
    for node in app._flatten():
        o = by_name.pop(node.deployment.name, None)
        if o is None:
            continue
        opts = {k: v for k, v in o.items()
                if k != "name" and k in _OVERRIDABLE}
        unknown = set(o) - set(_OVERRIDABLE) - {"name"}
        if unknown:
            raise ValueError(
                f"unknown deployment override fields for "
                f"{o['name']!r}: {sorted(unknown)}")
        node.deployment = node.deployment.options(**opts)
    if by_name:
        raise ValueError(
            f"config overrides reference unknown deployments: "
            f"{sorted(by_name)}")


def deploy_config(config: Any) -> Dict[str, Any]:
    """Deploy applications from a config dict / YAML string / YAML file
    path (reference `serve deploy`). Returns {app_name: ingress handle}.
    Redeploying an edited config updates live deployments through the
    controller's normal redeploy path."""
    import os

    from ray_tpu_torch import serve

    if isinstance(config, str):
        import yaml

        if os.path.exists(config):
            with open(config) as f:
                config = yaml.safe_load(f)
        else:
            config = yaml.safe_load(config)
    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("config must contain an 'applications' list")
    # default 8000 (the reference's serve default): a config deploy with
    # no http_options must still be reachable over HTTP
    http_port = int((config.get("http_options") or {}).get("port", 8000)
                    or 8000)
    handles: Dict[str, Any] = {}
    for app_cfg in config["applications"]:
        app = _import_app(app_cfg["import_path"])
        _apply_overrides(app, app_cfg.get("deployments", []))
        handles[app_cfg.get("name", "default")] = serve.run(
            app,
            name=app_cfg.get("name", "default"),
            route_prefix=app_cfg.get("route_prefix", "/"),
            http_port=http_port,
        )
    return handles
