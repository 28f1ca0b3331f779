"""The port's HTTP server (`ray_tpu_torch/_private/http.py`) and the two
servers on it, the Serve proxy and the dashboard, held to the JAX
package's aiohttp ones.

- One script deploys the same plain, raising, streaming and ASGI
  deployments on each package (two subprocesses, a cluster each) and
  sends both proxies the same requests over a raw socket; the status,
  `Content-Type`, body and chunk list of every answer must be equal.
- The proxy and the dashboard serve in a cluster whose every process
  finds `aiohttp` unimportable (a `sitecustomize` on their path).
- The server's own protocol cases: keep-alive, `Connection: close`,
  chunked request bodies, `Expect: 100-continue`, HEAD, HTTP/1.0
  streams, a malformed request, a raising handler and the idle timeout.
"""

import asyncio
import inspect
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from ray_tpu_torch._private import http

ROOT = Path(__file__).resolve().parent.parent


def raw_request(port, method, path, body=None, headers=(),
                version="HTTP/1.1"):
    """One request on its own connection (`Connection: close`); returns
    {status, content_type, headers, body, chunks}: `chunks` lists the
    chunk payloads of a chunked answer, None for a sized one."""
    import socket as _socket

    lines = [f"{method} {path} {version}", f"Host: 127.0.0.1:{port}",
             "Connection: close"] + [f"{k}: {v}" for k, v in headers]
    if body is not None:
        lines.append(f"Content-Length: {len(body)}")
    data = ("\r\n".join(lines) + "\r\n\r\n").encode() + (body or b"")
    with _socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(data)
        raw = b""
        while True:
            part = s.recv(65536)
            if not part:
                break
            raw += part
    head, _, rest = raw.partition(b"\r\n\r\n")
    status_line, *header_lines = head.decode("latin-1").split("\r\n")
    hdrs = {}
    for line in header_lines:
        k, _, v = line.partition(":")
        hdrs.setdefault(k.strip().lower(), v.strip())
    chunks = None
    if hdrs.get("transfer-encoding") == "chunked":
        chunks = []
        while True:
            size_line, _, rest = rest.partition(b"\r\n")
            size = int(size_line, 16)
            if size == 0:
                break
            chunks.append(rest[:size].decode())
            rest = rest[size + 2:]
        payload = "".join(chunks)
    else:
        payload = rest[:int(hdrs.get("content-length", len(rest)))].decode()
    return {"status": int(status_line.split()[1]),
            "content_type": hdrs.get("content-type"), "headers": hdrs,
            "body": payload, "chunks": chunks}


TWO_PACKAGE_PROXY = r'''
import importlib, json, socket, sys

pkg = sys.argv[1]
rt = importlib.import_module(pkg)
serve = importlib.import_module(pkg + ".serve")

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    PORT = s.getsockname()[1]

RAW_REQUEST


@serve.deployment
def echo(body=None):
    return {"got": body}


@serve.deployment
def boom(body=None):
    raise ValueError("kaboom")


@serve.deployment
def raw(body=None):
    return b"not-json"


@serve.deployment
def streamer(body):
    for i in range(3):
        yield {"chunk": i, "echo": body}


def make_app():
    async def app(scope, receive, send):
        msg = await receive()
        rel = scope["path"][len(scope["root_path"]):]
        if rel == "/scope":
            keep = ("type", "http_version", "method", "scheme", "path",
                    "root_path")
            out = {k: scope[k] for k in keep}
            out["raw_path"] = scope["raw_path"].decode()
            out["query_string"] = scope["query_string"].decode()
            out["headers"] = [[k.decode(), v.decode()]
                              for k, v in scope["headers"]]
            out["body"] = msg.get("body", b"").decode()
            await send({"type": "http.response.start", "status": 201,
                        "headers": [(b"content-type", b"application/json"),
                                    (b"x-custom", b"yes")]})
            await send({"type": "http.response.body",
                        "body": json.dumps(out).encode()})
        elif rel == "/stream":
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            for i in range(4):
                await send({"type": "http.response.body",
                            "body": f"part{i};".encode(), "more_body": True})
            await send({"type": "http.response.body", "body": b"",
                        "more_body": False})
        elif rel == "/bare":
            await send({"type": "http.response.start", "status": 200,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"x"})
        elif rel == "/fail":
            raise RuntimeError("asgi-kaboom")
        else:
            await send({"type": "http.response.start", "status": 404,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"nope"})
    return app


@serve.deployment
@serve.ingress(make_app)
class Api:
    pass


def masked(rec):
    rec = dict(rec)
    rec.pop("headers")
    if rec["status"] == 500:  # the remote traceback names each package
        rec["body"] = sorted(json.loads(rec["body"]))
    elif rec["status"] == 413:  # aiohttp counts what it had read so far
        rec["body"] = rec["body"].split(", actual body size")[0]
    else:
        rec["body"] = rec["body"].replace(str(PORT), "PORT")
    if rec["chunks"] is not None:
        rec["chunks"] = [c.replace(str(PORT), "PORT") for c in rec["chunks"]]
    return rec


kw = {"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}
rt.init(num_cpus=6, object_store_memory=128 << 20, **kw)
out = {}
try:
    for name, app, prefix in (("echo", echo, "/echo"), ("boom", boom, "/boom"),
                              ("raw", raw, "/raw"),
                              ("stream", streamer, "/stream"),
                              ("api", Api, "/api")):
        serve.run(app.bind(), name=name, route_prefix=prefix, http_port=PORT)
    cases = [
        ("POST", "/echo", b'{"k": [1, 2.5, "x"]}', ()),
        ("GET", "/echo", None, ()),
        ("POST", "/echo", b"plain words", ()),
        ("POST", "/echo/deeper", b"1", ()),
        ("GET", "/nope", None, ()),
        ("POST", "/boom", b"1", ()),
        ("POST", "/raw", None, ()),
        ("POST", "/stream", b'"hi"', ()),
        ("POST", "/api/scope?a=1&b=two", b"payload",
         (("X-Trace", "t1"), ("Content-Type", "text/plain"))),
        ("GET", "/api/stream", None, ()),
        ("GET", "/api/bare", None, ()),
        ("GET", "/api/missing", None, ()),
        ("GET", "/api/fail", None, ()),
        # aiohttp's client_max_size: a body of 1 MiB is refused
        ("POST", "/echo", b"x" * (1 << 20), ()),
    ]
    for method, path, body, headers in cases:
        rec = raw_request(PORT, method, path, body, headers)
        if path == "/boom":
            assert "kaboom" in json.loads(rec["body"])["error"]
        if path.startswith("/api/scope"):
            rec["x_custom"] = rec["headers"].get("x-custom")
        shown = body if body is None or len(body) < 100 \
            else f"<{len(body)} bytes>"
        out[f"{method} {path} {shown!r}"] = masked(rec)
finally:
    serve.shutdown()
    rt.shutdown()
print(json.dumps(out))
'''


def test_proxy_answers_as_the_jax_proxy():
    script = TWO_PACKAGE_PROXY.replace(
        "RAW_REQUEST", inspect.getsource(raw_request))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", script, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    jax = results["ray_tpu"]
    assert len(jax) == 14
    assert jax["""POST /echo b'{"k": [1, 2.5, "x"]}'"""]["body"] == \
        '{"got": {"k": [1, 2.5, "x"]}}'
    assert jax["POST /echo b'plain words'"]["body"] == \
        '{"got": "plain words"}'
    assert jax["GET /nope None"]["status"] == 404
    assert jax["POST /boom b'1'"]["status"] == 500
    assert jax["""POST /stream b'"hi"'"""]["chunks"] == [
        json.dumps({"chunk": i, "echo": "hi"}) + "\n" for i in range(3)]
    assert jax["GET /api/stream None"]["chunks"] == [
        f"part{i};" for i in range(4)]
    scope = jax["POST /api/scope?a=1&b=two b'payload'"]
    assert scope["x_custom"] == "yes" and scope["status"] == 201
    too_big = jax["POST /echo '<1048576 bytes>'"]
    assert too_big["status"] == 413
    assert too_big["body"] == "Maximum request body size 1048576 exceeded"
    assert results["ray_tpu_torch"] == jax


_NO_AIOHTTP = r'''
import json, socket, sys, urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.dashboard import start_dashboard


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@serve.deployment
def probe(body=None):
    try:
        import aiohttp  # noqa: F401
        return {"aiohttp": True, "body": body}
    except ImportError:
        return {"aiohttp": False, "body": body}


http_port, dash_port = free_port(), free_port()
ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=128 << 20)
out = {}
try:
    serve.run(probe.bind(), route_prefix="/probe", http_port=http_port)
    req = urllib.request.Request(f"http://127.0.0.1:{http_port}/probe",
                                 data=b'{"x": 1}')
    with urllib.request.urlopen(req, timeout=60) as r:
        out["proxy"] = json.loads(r.read())
    start_dashboard(port=dash_port)
    with urllib.request.urlopen(f"http://127.0.0.1:{dash_port}/api/nodes",
                                timeout=60) as r:
        out["nodes"] = [n["Alive"] for n in json.loads(r.read())]
    with urllib.request.urlopen(f"http://127.0.0.1:{dash_port}/",
                                timeout=60) as r:
        out["index"] = "ray_tpu_torch dashboard" in r.read().decode()
    out["driver_aiohttp"] = "aiohttp" in sys.modules and \
        sys.modules["aiohttp"] is not None
finally:
    serve.shutdown()
    ray_tpu_torch.shutdown()
print(json.dumps(out))
'''


def test_proxy_and_dashboard_serve_without_aiohttp(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['aiohttp'] = None\n")
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", _NO_AIOHTTP], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the replica (like the proxy's worker) could not import aiohttp
    assert got["proxy"] == {"aiohttp": False, "body": {"x": 1}}
    assert got["nodes"] == [True] and got["index"]
    assert got["driver_aiohttp"] is False


# -- the server's own protocol cases ------------------------------------------


@pytest.fixture(scope="module")
def server():
    seen = []

    async def handler(request):
        seen.append(request)
        if request.path == "/raise":
            raise RuntimeError("handler failed")
        if request.path == "/raise_mid":
            resp = http.StreamResponse()
            await resp.prepare(request)
            await resp.write(b"first")
            raise RuntimeError("handler failed mid-stream")
        if request.path == "/stream":
            resp = http.StreamResponse(headers={"Content-Type": "text/x"})
            await resp.prepare(request)
            for part in (b"a", b"", b"bc"):
                await resp.write(part)
            await resp.write_eof()
            return resp
        return http.json_response({"path": request.path,
                                   "query": request.query_string,
                                   "body": request.body.decode()})

    loop = asyncio.new_event_loop()
    srv = loop.run_until_complete(http.start_server(handler, "127.0.0.1", 0))
    port = srv.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield port, seen
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=5)


def _read_response(sock):
    """One sized response off a kept-alive socket."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(4096)
    head, _, body = buf.partition(b"\r\n\r\n")
    length = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                  if ln.lower().startswith(b"content-length")][0])
    while len(body) < length:
        body += sock.recv(4096)
    return head.decode(), json.loads(body[:length])


def test_keep_alive_serves_requests_on_one_connection(server):
    port, _ = server
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        for i in range(3):
            s.sendall(f"GET /k{i}?q={i} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            head, body = _read_response(s)
            assert head.startswith("HTTP/1.1 200 OK")
            assert "Connection: close" not in head
            assert body == {"path": f"/k{i}", "query": f"q={i}", "body": ""}
        s.sendall(b"GET /last HTTP/1.1\r\nConnection: close\r\n\r\n")
        head, body = _read_response(s)
        assert "Connection: close" in head
        assert s.recv(10) == b""  # the server closed its end


def test_request_bodies_sized_chunked_and_after_100_continue(server):
    port, _ = server
    assert json.loads(raw_request(port, "POST", "/b", b"sized")["body"])[
        "body"] == "sized"
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"POST /c HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
                  b"Connection: close\r\n\r\n3\r\nabc\r\n2;x=1\r\nde\r\n"
                  b"0\r\n\r\n")
        _, body = _read_response(s)
        assert body["body"] == "abcde"
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"POST /e HTTP/1.1\r\nExpect: 100-continue\r\n"
                  b"Content-Length: 4\r\nConnection: close\r\n\r\n")
        assert s.recv(64).startswith(b"HTTP/1.1 100 Continue\r\n\r\n")
        s.sendall(b"wxyz")
        _, body = _read_response(s)
        assert body["body"] == "wxyz"


def test_streams_head_and_http10(server):
    port, _ = server
    rec = raw_request(port, "GET", "/stream")
    assert rec["chunks"] == ["a", "bc"]  # an empty write sends no chunk
    assert rec["content_type"] == "text/x"
    rec = raw_request(port, "GET", "/stream", version="HTTP/1.0")
    assert rec["chunks"] is None and rec["body"] == "abc"
    rec = raw_request(port, "HEAD", "/h")
    assert rec["status"] == 200 and rec["body"] == ""
    assert int(rec["headers"]["content-length"]) > 0
    assert rec["content_type"] == "application/json; charset=utf-8"


def test_malformed_request_and_raising_handler(server):
    port, _ = server
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"NONSENSE\r\n\r\n")
        data = s.recv(4096)
    assert data.startswith(b"HTTP/1.1 400 Bad Request")
    rec = raw_request(port, "POST", "/b", headers=(("Content-Length",
                                                     "lots"),))
    assert rec["status"] == 400 and "bad length" in rec["body"]
    rec = raw_request(port, "GET", "/raise")
    assert rec["status"] == 500
    assert rec["content_type"] == "text/plain; charset=utf-8"
    # after the head went out: the stream is cut short and the
    # connection closed (no second status line), as aiohttp does
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"GET /raise_mid HTTP/1.1\r\nHost: x\r\n\r\n")
        raw = b""
        while part := s.recv(4096):
            raw += part
    assert raw.count(b"HTTP/1.1 ") == 1
    assert raw.endswith(b"5\r\nfirst\r\n")


def test_request_body_of_a_mebibyte_is_refused_unread(server):
    """A body of `MAX_BODY_BYTES` or more, sized or chunked, gets
    aiohttp's 413 and never reaches the handler; the connection then
    closes. One byte less is served."""
    port, seen = server
    before = len(seen)
    big = b"y" * http.MAX_BODY_BYTES
    rec = raw_request(port, "POST", "/big", big)
    assert rec["status"] == 413
    assert rec["content_type"] == "text/plain; charset=utf-8"
    assert rec["body"] == ("Maximum request body size 1048576 exceeded, "
                           "actual body size 1048576")
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        half = len(big) // 2
        s.sendall(b"POST /bigc HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
                  b"\r\n" + b"%x\r\n" % half + big[:half] + b"\r\n" +
                  b"%x\r\n" % half + big[half:] + b"\r\n0\r\n\r\n")
        raw = b""
        while part := s.recv(4096):
            raw += part
    assert raw.startswith(b"HTTP/1.1 413 Request Entity Too Large")
    assert len(seen) == before
    rec = raw_request(port, "POST", "/fits", big[1:])
    assert rec["status"] == 200
    assert len(json.loads(rec["body"])["body"]) == len(big) - 1


def test_idle_connection_is_closed_after_the_read_timeout(server,
                                                          monkeypatch):
    port, _ = server
    monkeypatch.setattr(http, "READ_TIMEOUT_S", 0.3)
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        start = time.monotonic()
        assert s.recv(10) == b""  # closed by the server, not by us
        assert time.monotonic() - start < 5.0
