"""The scenarios of `tests/test_serve.py` against the port's Serve
(`ray_tpu_torch.serve`) on the port's own runtime, one test per scenario
there: deployments, handles, routing, composition, autoscaling,
batching, HTTP proxy, streaming handles and JSONL, the gRPC proxy,
redeploy, replica recovery, ASGI ingress and the declarative config.

One module-scoped cluster, as in that file. The HTTP proxy listens on a
free port of its own (the JAX file's 8123 may be taken by its cluster in
another test worker), found when the module's cluster starts.
"""

import os
import socket
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import dispatch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


HTTP = {}


@pytest.fixture(scope="module", autouse=True)
def cluster():
    HTTP["port"] = _free_port()
    ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                       object_store_memory=256 * 1024 * 1024)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _url(path: str) -> str:
    return f"http://127.0.0.1:{HTTP['port']}{path}"


@pytest.fixture(autouse=True)
def clean_deployments():
    yield
    for name in list(serve.status()):
        serve.delete(name)


def test_function_deployment():
    @serve.deployment
    def doubler(x):
        return x * 2

    handle = serve.run(doubler.bind())
    assert handle.remote(21).result() == 42


def test_class_deployment_and_methods():
    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.base = start

        def __call__(self, x):
            return self.base + x

        def describe(self):
            return "counter"

    handle = serve.run(Counter.bind(100))
    assert handle.remote(5).result() == 105
    assert handle.describe.remote().result() == "counter"
    st = serve.status()
    assert st["Counter"]["num_replicas"] == 2


def test_composition():
    @serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            y = self.pre.remote(x).result(timeout=30)
            return y * 10

    handle = serve.run(Model.bind(Preprocessor.bind()))
    assert handle.remote(4).result() == 50


def test_batching():
    @serve.deployment(max_ongoing_requests=16)
    class BatchAdder:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, xs):
            # returns list; batch size recorded in each result
            return [(x, len(xs)) for x in xs]

    handle = serve.run(BatchAdder.bind())
    responses = [handle.remote(i) for i in range(8)]
    results = [r.result(timeout=30) for r in responses]
    assert sorted(x for x, _ in results) == list(range(8))
    # at least one real batch formed (size > 1)
    assert max(bs for _, bs in results) > 1


def test_autoscaling_scales_up():
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0, "upscale_delay_s": 0.0,
        "downscale_delay_s": 60.0})
    class Slow:
        def __call__(self, x):
            time.sleep(2.0)
            return x

    handle = serve.run(Slow.bind())
    # flood with concurrent requests to build up ongoing count
    responses = [handle.remote(i) for i in range(6)]
    deadline = time.monotonic() + 30
    scaled = False
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["num_replicas"] > 1:
            scaled = True
            break
        time.sleep(0.5)
    for r in responses:
        r.result(timeout=60)
    assert scaled, f"autoscaler never scaled up: {serve.status()}"


def test_redeploy_updates_version():
    @serve.deployment
    def v(x):
        return "v1"

    handle = serve.run(v.bind())
    assert handle.remote(0).result() == "v1"

    @serve.deployment(name="v")
    def v2(x):
        return "v2"

    handle = serve.run(v2.bind())
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if handle.remote(0).result(timeout=30) == "v2":
            return
        time.sleep(0.2)
    raise AssertionError("redeploy never took effect")


def test_replica_death_recovery():
    @serve.deployment(num_replicas=1)
    class Sturdy:
        def __call__(self, x):
            return x + 1

    handle = serve.run(Sturdy.bind())
    assert handle.remote(1).result() == 2
    # murder the replica behind the controller's back
    ctrl = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    info = ray_tpu_torch.get(ctrl.get_replicas.remote("Sturdy"), timeout=30)
    ray_tpu_torch.kill(info["replicas"][0])
    # reconcile loop must replace it
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        try:
            if handle.remote(5).result(timeout=10) == 6:
                return
        except Exception:
            time.sleep(0.5)
    raise AssertionError("replica never recovered")


def test_http_proxy():
    import urllib.request
    import json as json_mod

    @serve.deployment
    def echo(body):
        return {"got": body}

    serve.run(echo.bind(), route_prefix="/echo", http_port=HTTP["port"])
    req = urllib.request.Request(
        _url("/echo"),
        data=json_mod.dumps({"k": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        out = json_mod.loads(resp.read())
    assert out == {"got": {"k": 1}}
    # 404 for unknown route
    try:
        urllib.request.urlopen(_url("/nope"), timeout=30)
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_streaming_handle_response():
    """stream=True handles yield chunks as the replica produces them
    (reference: DeploymentResponseGenerator)."""
    @serve.deployment
    class Tokens:
        def generate(self, n):
            for i in range(n):
                yield {"token": i}

    handle = serve.run(Tokens.bind())
    chunks = list(handle.generate.options(stream=True).remote(4))
    assert chunks == [{"token": i} for i in range(4)]


def test_streaming_handle_early_close():
    @serve.deployment
    class Endless:
        def stream(self):
            i = 0
            while True:
                yield i
                i += 1

    handle = serve.run(Endless.bind())
    gen = handle.stream.options(stream=True).remote()
    got = [next(gen) for _ in range(3)]
    gen.close()
    assert got == [0, 1, 2]
    # replica metrics drain back to zero ongoing once cancelled
    time.sleep(1.0)
    st = serve.status()
    assert st["Endless"]["num_replicas"] == 1


def test_streaming_http_jsonl():
    """Generator deployments stream JSON-lines over the HTTP proxy."""
    import urllib.request

    @serve.deployment
    def streamer(body):
        for i in range(3):
            yield {"chunk": i, "echo": body}

    serve.run(streamer.bind(), route_prefix="/stream", http_port=HTTP["port"])
    req = urllib.request.Request(
        _url("/stream"), data=b'"hi"',
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        lines = [ln for ln in r.read().decode().splitlines() if ln]
    import json as json_mod

    parsed = [json_mod.loads(ln) for ln in lines]
    assert parsed == [{"chunk": i, "echo": "hi"} for i in range(3)]


def test_grpc_proxy_unary_and_streaming():
    """gRPC ingress (reference `_private/proxy.py:534` gRPCProxy):
    unary Call routes to a deployment, CallStreaming streams generator
    chunks, Healthz answers, unknown deployment -> INTERNAL."""
    import grpc
    import json as json_mod

    @serve.deployment
    def square(x):
        return {"sq": x * x}

    @serve.deployment
    def counter(n):
        for i in range(n):
            yield {"i": i}

    serve.run(square.bind(), route_prefix="/square")
    serve.run(counter.bind(), route_prefix="/counter")
    from ray_tpu_torch.serve import _start_grpc_proxy

    info = _start_grpc_proxy(0)  # ephemeral port
    addr = f"127.0.0.1:{info['port']}"
    with grpc.insecure_channel(addr) as channel:
        call = channel.unary_unary("/ray_tpu.serve.ServeAPI/Call")
        out = json_mod.loads(call(
            json_mod.dumps({"deployment": "square", "data": 7}).encode(),
            timeout=60))
        assert out == {"result": {"sq": 49}}

        healthz = channel.unary_unary("/ray_tpu.serve.ServeAPI/Healthz")
        assert healthz(b"", timeout=30) == b"ok"

        stream = channel.unary_stream(
            "/ray_tpu.serve.ServeAPI/CallStreaming")
        chunks = [json_mod.loads(c) for c in stream(
            json_mod.dumps({"deployment": "counter", "data": 3}).encode(),
            timeout=60)]
        assert chunks == [{"result": {"i": 0}}, {"result": {"i": 1}},
                          {"result": {"i": 2}}]

        with pytest.raises(grpc.RpcError):
            call(json_mod.dumps({"deployment": "missing",
                                 "data": 1}).encode(), timeout=60)
        # the proxy's router to a deployment that never existed leaves
        # no wakeup FIFO behind (only the controller creates one)
        assert not os.path.exists(dispatch.router_wake_path("missing"))


# -- ASGI ingress (reference serve/api.py:248 @serve.ingress) ---------------


def _tiny_asgi_router():
    """A framework-free ASGI app with path params, query handling, a
    middleware layer, and a streaming endpoint — the protocol surface a
    FastAPI/Starlette app exercises."""

    async def app(scope, receive, send):
        assert scope["type"] == "http"
        path = scope["path"]
        root = scope.get("root_path", "")
        rel = path[len(root):] if root and path.startswith(root) else path
        await receive()  # consume the request body event
        if rel.startswith("/items/"):
            item_id = rel.split("/items/", 1)[1]
            qs = scope["query_string"].decode()
            body = ('{"item": "%s", "qs": "%s", "method": "%s"}'
                    % (item_id, qs, scope["method"])).encode()
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type",
                                     b"application/json")]})
            await send({"type": "http.response.body", "body": body})
        elif rel == "/stream":
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            for i in range(4):
                await send({"type": "http.response.body",
                            "body": f"chunk{i};".encode(),
                            "more_body": True})
            await send({"type": "http.response.body", "body": b"",
                        "more_body": False})
        else:
            await send({"type": "http.response.start", "status": 404,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"nope"})

    async def middleware(scope, receive, send):
        # header-injecting middleware wrapping the router
        async def wrapped_send(ev):
            if ev["type"] == "http.response.start":
                ev = dict(ev)
                ev["headers"] = list(ev.get("headers", [])) + [
                    (b"x-middleware", b"on")]
            await send(ev)
        await app(scope, receive, wrapped_send)

    return middleware


def test_asgi_ingress_path_params_and_middleware():
    import urllib.request
    import json as json_mod

    @serve.deployment
    @serve.ingress(_tiny_asgi_router())
    class Api:
        pass

    serve.run(Api.bind(), route_prefix="/api", http_port=HTTP["port"])
    with urllib.request.urlopen(
            _url("/api/items/42?a=1"), timeout=60) as r:
        assert r.headers["x-middleware"] == "on"
        out = json_mod.loads(r.read())
    assert out == {"item": "42", "qs": "a=1", "method": "GET"}

    # 404 generated BY the app (not the proxy) passes through
    try:
        urllib.request.urlopen(_url("/api/missing"), timeout=30)
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404
        assert e.read() == b"nope"


def test_asgi_ingress_streaming_response():
    import urllib.request

    @serve.deployment
    @serve.ingress(_tiny_asgi_router())
    class StreamApi:
        pass

    serve.run(StreamApi.bind(), route_prefix="/s", http_port=HTTP["port"])
    with urllib.request.urlopen(_url("/s/stream"), timeout=60) as r:
        body = r.read()
    assert body == b"chunk0;chunk1;chunk2;chunk3;"


def test_asgi_ingress_instance_factory_and_body():
    """One-arg factory: routes close over the deployment instance, and
    the request body reaches the app through the forwarded scope."""
    import urllib.request
    import json as json_mod

    def make_app(instance):
        async def app(scope, receive, send):
            ev = await receive()
            n = json_mod.loads(ev["body"] or b"0")
            out = json_mod.dumps(
                {"scaled": n * instance.factor}).encode()
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type",
                                     b"application/json")]})
            await send({"type": "http.response.body", "body": out})
        return app

    @serve.deployment
    @serve.ingress(make_app)
    class Scaler:
        def __init__(self, factor):
            self.factor = factor

    serve.run(Scaler.bind(3), route_prefix="/scale", http_port=HTTP["port"])
    req = urllib.request.Request(_url("/scale"), data=b"7")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert json_mod.loads(r.read()) == {"scaled": 21}


def test_declarative_config_build_and_deploy(tmp_path):
    """serve.build -> YAML -> serve.deploy_config round trip (reference
    `serve build` / `serve deploy` + schema.py), with a num_replicas
    override applied from config."""
    import sys
    import yaml

    # the config deploy imports the app by path: write a real module
    mod = tmp_path / "torch_cfg_app_mod.py"
    mod.write_text(
        "from ray_tpu_torch import serve\n"
        "@serve.deployment\n"
        "def pinger(body):\n"
        "    return {'pong': body}\n"
        "app = pinger.bind()\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import torch_cfg_app_mod as cfg_app_mod

        cfg = serve.build(cfg_app_mod.app, name="cfgapp",
                          import_path="torch_cfg_app_mod:app",
                          route_prefix="/cfg")
        assert cfg["applications"][0]["deployments"][0]["name"] == "pinger"
        # operator edit: bump replicas in the YAML
        cfg["applications"][0]["deployments"][0]["num_replicas"] = 2
        # the module proxy (other tests) owns the port; a mismatched
        # port must be rejected loudly, so point the config at the same one
        cfg["http_options"] = {"port": HTTP["port"]}
        yml = yaml.safe_dump(cfg)
        path = tmp_path / "serve.yaml"
        path.write_text(yml)

        handles = serve.deploy_config(str(path))
        assert handles["cfgapp"].remote("x").result() == {"pong": "x"}
        st = serve.status()
        assert st["pinger"]["target_replicas"] == 2, st

        # overrides land on a CLONE of the module-cached app: a second
        # deploy without the override reverts to the code default
        cfg2 = serve.build(cfg_app_mod.app, name="cfgapp",
                           import_path="torch_cfg_app_mod:app",
                           route_prefix="/cfg")
        cfg2["http_options"] = {"port": HTTP["port"]}
        serve.deploy_config(cfg2)
        assert serve.status()["pinger"]["target_replicas"] == 1

        # unknown override fields fail loudly
        bad = {"http_options": {"port": HTTP["port"]},
               "applications": [{"name": "b", "import_path":
                                 "torch_cfg_app_mod:app",
                                 "deployments": [{"name": "pinger",
                                                  "nope": 1}]}]}
        with pytest.raises(ValueError, match="unknown deployment"):
            serve.deploy_config(bad)
    finally:
        sys.path.remove(str(tmp_path))


def test_asgi_lifespan_and_blocking_receive():
    """Framework-compat contract points: (a) the lifespan protocol runs
    once per replica (startup state visible to requests); (b) after the
    body, receive() BLOCKS instead of returning http.disconnect — a
    concurrent disconnect-listener (Starlette's listen_for_disconnect
    pattern) must not cancel a live streaming response."""
    import urllib.request

    def make_app():
        state = {}

        async def app(scope, receive, send):
            import asyncio
            if scope["type"] == "lifespan":
                while True:
                    ev = await receive()
                    if ev["type"] == "lifespan.startup":
                        state["ready"] = "yes"
                        await send({"type":
                                    "lifespan.startup.complete"})
                    elif ev["type"] == "lifespan.shutdown":
                        await send({"type":
                                    "lifespan.shutdown.complete"})
                        return
                return
            await receive()  # body

            async def listen_for_disconnect():
                # Starlette-style: second receive must BLOCK while the
                # response streams; an eager http.disconnect here would
                # cancel the stream below
                ev = await receive()
                return ev

            listener = asyncio.ensure_future(listen_for_disconnect())
            try:
                await send({"type": "http.response.start", "status": 200,
                            "headers": [(b"x-ready",
                                         state.get("ready",
                                                   "no").encode())]})
                for i in range(3):
                    await asyncio.sleep(0.05)
                    if listener.done():
                        return  # disconnected mid-stream: abort
                    await send({"type": "http.response.body",
                                "body": f"s{i};".encode(),
                                "more_body": True})
                await send({"type": "http.response.body", "body": b"",
                            "more_body": False})
            finally:
                listener.cancel()

        return app

    @serve.deployment
    @serve.ingress(make_app)
    class LifespanApp:
        pass

    serve.run(LifespanApp.bind(), route_prefix="/ls", http_port=HTTP["port"])
    with urllib.request.urlopen(_url("/ls"), timeout=60) as r:
        assert r.headers["x-ready"] == "yes"  # lifespan startup ran
        assert r.read() == b"s0;s1;s2;"  # stream survived the listener
