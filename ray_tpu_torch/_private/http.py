"""A small HTTP/1.1 server on asyncio streams.

The Serve HTTP proxy, the dashboard and the daemons' `/metrics`
endpoint (`util.metrics.serve_metrics`) serve through it: a node needs
no web framework to answer HTTP. Its surface is the part of aiohttp's
`web` API the proxy and the dashboard use, with the same bytes on the
wire for what their clients read (status, `Content-Type`, body, the
chunks of a chunked stream):

- `start_server(handler, host, port)`: `handler(request)` is a coroutine
  that returns a `Response` or a `StreamResponse` it has written;
- `Request`: method, path (percent-decoded), the raw request target,
  query string, headers in arrival order, the body (`Content-Length`
  or a chunked request body, after `Expect: 100-continue`), the peer;
- `Response`, `json_response`, `text_response`: a whole body with its
  length (`json_response` and `text_response` give aiohttp's
  `application/json; charset=utf-8` and `text/plain; charset=utf-8`);
- `StreamResponse`: `prepare`, `write`, `write_eof`; a chunked body,
  one chunk per non-empty `write`, `application/octet-stream` unless a
  `Content-Type` header is set.

HTTP/1.1 connections are kept alive unless the client sends
`Connection: close` (HTTP/1.0: closed unless it sends `keep-alive`).
Each read waits at most `READ_TIMEOUT_S`, so an idle connection cannot
hold its task. A request body of `MAX_BODY_BYTES` (aiohttp's default
`client_max_size`, 1 MiB) or more is answered 413 with aiohttp's text
and not buffered; aiohttp answers so only where the handler reads the
body, as the proxy does, so a dashboard GET with such a body is refused
here and served there. A handler that raises answers 500; one that
raises after its stream's head went out leaves the stream cut short
and the connection closed, as aiohttp does.
"""

from __future__ import annotations

import asyncio
import http as _http
import json
import logging
from typing import Any, Awaitable, Callable, List, Optional, Tuple
from urllib.parse import unquote

logger = logging.getLogger(__name__)

READ_TIMEOUT_S = 30.0
MAX_HEADERS = 128
MAX_BODY_BYTES = 1 << 20
# after a 413, what the client still sends is read and dropped until it
# closes, for at most this long (aiohttp's lingering_time), so that the
# client reads the answer instead of a reset
LINGER_S = 10.0
_CRLF = b"\r\n"


class BadRequest(Exception):
    pass


class BodyTooLarge(Exception):
    def __init__(self, size: int):
        super().__init__(f"Maximum request body size {MAX_BODY_BYTES} "
                         f"exceeded, actual body size {size}")


class Request:
    """One parsed request. `headers` keeps the names as sent."""

    __slots__ = ("method", "raw_path", "path", "query_string", "version",
                 "headers", "body", "peer", "keep_alive", "started",
                 "_writer")

    def __init__(self, method: str, raw_path: str, version: str,
                 headers: List[Tuple[str, str]], peer, writer):
        self.method = method
        self.raw_path = raw_path
        path, _, query = raw_path.partition("?")
        self.path = unquote(path)
        self.query_string = query
        self.version = version
        self.headers = headers
        self.body = b""
        self.peer = peer
        conn = (self.header("connection") or "").lower()
        if version == "HTTP/1.0":
            self.keep_alive = conn == "keep-alive"
        else:
            self.keep_alive = conn != "close"
        self.started = False  # a StreamResponse's head went out
        self._writer = writer

    def header(self, name: str, default: Optional[str] = None):
        name = name.lower()
        for k, v in self.headers:
            if k.lower() == name:
                return v
        return default


def _reason(status: int) -> str:
    try:
        return _http.HTTPStatus(status).phrase
    except ValueError:
        return ""


def _head(request: Request, status: int,
          headers: List[Tuple[str, str]]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers]
    if not request.keep_alive:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole response body, sent with its `Content-Length`."""

    def __init__(self, body: bytes, status: int, content_type: str):
        self.body = body
        self.status = status
        self.content_type = content_type

    async def _send(self, request: Request):
        headers = [("Content-Type", self.content_type),
                   ("Content-Length", str(len(self.body)))]
        data = _head(request, self.status, headers)
        if request.method != "HEAD":
            data += self.body
        request._writer.write(data)
        await request._writer.drain()


def json_response(data: Any, status: int = 200) -> Response:
    """`data` as JSON (raises `TypeError` for what JSON cannot hold)."""
    return Response(json.dumps(data).encode(), status,
                    "application/json; charset=utf-8")


def text_response(text: str, status: int = 200,
                  content_type: str = "text/plain") -> Response:
    return Response(text.encode(), status,
                    f"{content_type}; charset=utf-8")


class StreamResponse:
    """A chunked response: `await prepare(request)` sends the head, each
    non-empty `await write(data)` one chunk, `await write_eof()` the
    last chunk. A client on HTTP/1.0 gets the bytes unframed and the
    connection closes after them."""

    def __init__(self, status: int = 200,
                 headers: Optional[dict] = None):
        self.status = status
        self.headers: List[Tuple[str, str]] = list((headers or {}).items())
        self._request: Optional[Request] = None
        self._chunked = True
        self._eof = False

    def set_status(self, status: int):
        self.status = status

    def add_header(self, name: str, value: str):
        self.headers.append((name, value))

    async def prepare(self, request: Request):
        if self._request is not None:
            return
        self._request = request
        request.started = True
        headers = list(self.headers)
        if not any(k.lower() == "content-type" for k, _ in headers):
            headers.append(("Content-Type", "application/octet-stream"))
        if request.version == "HTTP/1.0":
            self._chunked = False
            request.keep_alive = False
        elif self.status in (204, 304) or request.method == "HEAD":
            self._chunked = False
        else:
            headers.append(("Transfer-Encoding", "chunked"))
        request._writer.write(_head(request, self.status, headers))
        await request._writer.drain()

    async def write(self, data: bytes):
        if not data or self._request.method == "HEAD" \
                or self.status in (204, 304):
            return
        w = self._request._writer
        if self._chunked:
            w.write(f"{len(data):x}\r\n".encode() + bytes(data) + _CRLF)
        else:
            w.write(bytes(data))
        await w.drain()

    async def write_eof(self):
        if self._eof:
            return
        self._eof = True
        if self._chunked:
            self._request._writer.write(b"0\r\n\r\n")
            await self._request._writer.drain()


async def _readline(reader: asyncio.StreamReader) -> bytes:
    return await asyncio.wait_for(reader.readline(), READ_TIMEOUT_S)


def _parse_int(text, base: int = 10) -> int:
    try:
        value = int(text, base)
    except ValueError:
        raise BadRequest(f"bad length {text[:40]!r}") from None
    if value < 0:
        raise BadRequest(f"negative length {value}")
    return value


async def _continue(writer, request: Request):
    if (request.header("expect") or "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()


async def _read_body(reader: asyncio.StreamReader, writer,
                     request: Request) -> bytes:
    """The request's body; `BodyTooLarge` once it reaches
    `MAX_BODY_BYTES` (a sized body before any of it is read)."""
    if (request.header("transfer-encoding") or "").lower() == "chunked":
        await _continue(writer, request)
        parts, total = [], 0
        while True:
            size = _parse_int((await _readline(reader)).split(b";")[0]
                              .strip(), 16)
            if size == 0:
                while (await _readline(reader)) not in (_CRLF, b"\n", b""):
                    pass  # trailers
                return b"".join(parts)
            total += size
            if total >= MAX_BODY_BYTES:
                raise BodyTooLarge(total)
            parts.append(await asyncio.wait_for(
                reader.readexactly(size), READ_TIMEOUT_S))
            await _readline(reader)
    length = _parse_int(request.header("content-length") or "0")
    if length >= MAX_BODY_BYTES:
        raise BodyTooLarge(length)
    if not length:
        return b""
    await _continue(writer, request)
    return await asyncio.wait_for(reader.readexactly(length), READ_TIMEOUT_S)


async def _drop_input(reader: asyncio.StreamReader):
    """Read and drop what the client still sends until it closes, for at
    most `LINGER_S`."""
    loop = asyncio.get_running_loop()
    end = loop.time() + LINGER_S
    while (left := end - loop.time()) > 0:
        try:
            if not await asyncio.wait_for(reader.read(65536), left):
                return
        except asyncio.TimeoutError:
            return


async def _read_request(reader, writer) -> Optional[Request]:
    line = await _readline(reader)
    while line in (_CRLF, b"\n"):  # stray blank lines between requests
        line = await _readline(reader)
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise BadRequest(f"bad request line {line[:80]!r}") from None
    headers = []
    while True:
        hl = await _readline(reader)
        if hl in (_CRLF, b"\n", b""):
            break
        if len(headers) >= MAX_HEADERS:
            raise BadRequest("too many headers")
        name, sep, value = hl.decode("latin-1").partition(":")
        if not sep:
            raise BadRequest(f"bad header line {hl[:80]!r}")
        headers.append((name.strip(), value.strip()))
    request = Request(method.upper(), target, version, headers,
                      writer.get_extra_info("peername"), writer)
    try:
        request.body = await _read_body(reader, writer, request)
    except BodyTooLarge as e:
        request.keep_alive = False
        await text_response(str(e), status=413)._send(request)
        if writer.can_write_eof():
            writer.write_eof()  # the answer is whole: the client may close
        await _drop_input(reader)
        return None
    return request


Handler = Callable[[Request], Awaitable[Any]]


async def start_server(handler: Handler, host: str = "127.0.0.1",
                       port: int = 0) -> asyncio.AbstractServer:
    """Listen on `host:port` (0: a free port, read it from
    `server.sockets[0].getsockname()`) and answer every request with
    `await handler(request)`."""

    async def connection(reader, writer):
        try:
            while True:
                try:
                    request = await _read_request(reader, writer)
                except BadRequest as e:
                    writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                                 b"Content-Type: text/plain; charset=utf-8"
                                 b"\r\nConnection: close\r\n"
                                 b"Content-Length: " +
                                 str(len(str(e))).encode() + b"\r\n\r\n" +
                                 str(e).encode())
                    await writer.drain()
                    return
                if request is None:
                    return
                try:
                    resp = await handler(request)
                except Exception:  # noqa: BLE001 — the client gets a 500
                    logger.exception("HTTP handler failed on %s %s",
                                     request.method, request.path)
                    if request.started:
                        return  # mid-stream: cut it short
                    resp = text_response(
                        "500 Internal Server Error\n\n"
                        "Server got itself in trouble", status=500)
                if isinstance(resp, StreamResponse):
                    await resp.prepare(request)
                    await resp.write_eof()
                else:
                    await resp._send(request)
                if not request.keep_alive:
                    return
        except (ConnectionError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, ValueError):
            # the client went away or stalled; ValueError: a line over
            # the stream's limit (StreamReader.readline)
            pass
        finally:
            writer.close()

    return await asyncio.start_server(connection, host, port)
