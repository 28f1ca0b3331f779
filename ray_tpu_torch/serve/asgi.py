"""ASGI ingress for Serve deployments.

Reference: `python/ray/serve/api.py:248-545` (`@serve.ingress(app)`) and
`python/ray/serve/_private/http_util.py` (ASGIReceiveProxy / the scope
hand-off). The proxy forwards the RAW ASGI scope to the replica, which
runs the app on a private event loop and streams the app's `send` events
back over the generator protocol — status/headers/body chunks reach the
HTTP client as the app emits them, so StreamingResponse-style endpoints
work end to end.

Any ASGI callable works (FastAPI and Starlette apps are plain ASGI
callables); no framework is required. Three shapes are accepted:

    @serve.deployment
    @serve.ingress(asgi_app)            # a ready app
    class A: ...

    @serve.ingress(lambda: make_app())  # zero-arg factory, built once
    class B: ...                        #   per replica process

    @serve.ingress(lambda self: make_app(self))  # one-arg factory: gets
    class C: ...                        #   the deployment instance, so
                                        #   routes can close over self
"""

from __future__ import annotations

import inspect
from typing import Any, Callable


def ingress(app_or_factory: Any) -> Callable[[type], type]:
    """Class decorator marking a deployment as an ASGI ingress."""
    if app_or_factory is None:
        raise ValueError("serve.ingress requires an ASGI app or a factory")

    def decorator(cls: type) -> type:
        if not isinstance(cls, type):
            raise TypeError(
                "serve.ingress decorates a class; put it UNDER "
                "@serve.deployment")
        cls.__serve_asgi__ = app_or_factory
        return cls

    return decorator


def resolve_app(marker: Any, instance: Any) -> Any:
    """Replica-side: turn the ingress marker into the live ASGI app."""
    # an ASGI app itself takes (scope, receive, send) — distinguish it
    # from 0/1-arg factories by arity
    try:
        sig = inspect.signature(
            marker.__call__ if not inspect.isfunction(marker)
            and not inspect.ismethod(marker) and callable(marker)
            and not inspect.isclass(marker) else marker)
        required = [p for p in sig.parameters.values()
                    if p.default is p.empty
                    and p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD)]
        arity = len(required)
    except (TypeError, ValueError):
        arity = 3  # uninspectable callables: assume it's the app
    if arity >= 2:
        return marker  # (scope, receive, send): already an app
    if arity == 1:
        return marker(instance)
    return marker()
