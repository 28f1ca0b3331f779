"""Asyncio RPC: length-prefixed msgpack frames over TCP.

This is the control-plane transport equivalent of the reference's gRPC layer
(`src/ray/rpc/`): every daemon (GCS, raylet, worker) runs an `RpcServer` with
named async handlers, and holds `RpcClient` connections to its peers. Direct
worker→worker task push (the reference's `CoreWorkerService.PushTask`) rides
the same transport. Payloads are msgpack maps; binary blobs (pickled task
args, serialized objects) are msgpack `bytes` and are never copied through
JSON/base64.

Frame format:  u32_be length | msgpack [msgid, kind, method, payload]
kinds: 0=request 1=reply_ok 2=reply_err 3=notify 4=batch

A BATCH frame carries N logical messages in one wire frame: its payload is a
list of individually msgpack-packed `[msgid, kind, method, payload]` bodies.
Both sides run a per-connection write coalescer (`_WriteCoalescer`): the
first message on a cold connection writes through immediately (serial
request/response traffic pays no added latency) and opens a one-tick
window; every message queued within that same event-loop tick — plus a
size/count watermark — folds into one BATCH frame: one `_pack`, one
syscall, one drain for N logical messages (reference: gRPC's stream write
coalescing in `src/ray/rpc/`). A single queued message is emitted as a
plain frame, byte-identical to the unbatched format. Fault injection (`rpc_send` /
`rpc_recv`) acts per *logical* message, never per wire frame, so seeded
FaultPlan replays stay valid with batching on.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
import traceback
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

import msgpack

from ray_tpu_torch._private import fault_injection as _fi

logger = logging.getLogger(__name__)

REQUEST, REPLY_OK, REPLY_ERR, NOTIFY, BATCH = 0, 1, 2, 3, 4

_MAX_FRAME = 1 << 31


class RpcError(Exception):
    """Remote handler raised; carries the remote traceback string."""


class ConnectionLost(Exception):
    pass


def _pack(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return len(body).to_bytes(4, "big") + body


async def _read_frame(reader: asyncio.StreamReader):
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "big")
    if length > _MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


def _unbatch(bodies: List[bytes]):
    RPC_STATS.batch_frames_recv += 1
    RPC_STATS.messages_unbatched += len(bodies)
    for body in bodies:
        yield msgpack.unpackb(body, raw=False, strict_map_key=False)


class _RpcStats:
    """Process-wide frame-coalescing counters (every connection feeds the
    same instance; per-connection figures live on each `_WriteCoalescer`).
    `messages_sent / frames_sent` is the amortization factor the batching
    win comes from — scraped through `/metrics` on every daemon and read
    directly by `bench.py` for attribution."""

    __slots__ = ("messages_sent", "frames_sent", "batches_sent",
                 "messages_batched", "drain_backoffs", "batch_frames_recv",
                 "messages_unbatched")

    def __init__(self):
        self.reset()

    def reset(self):
        for name in self.__slots__:
            setattr(self, name, 0)

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


RPC_STATS = _RpcStats()


def metrics_text() -> str:
    s = RPC_STATS
    lines = ["# TYPE rpc_coalescing counter"]
    lines += [f"rpc_{name} {getattr(s, name)}" for name in _RpcStats.__slots__]
    return "\n".join(lines) + "\n"


try:  # join every daemon's /metrics scrape (like the channel frame plane)
    from ray_tpu_torch.util import metrics as _metrics

    _metrics.DEFAULT_REGISTRY.register_callback("rpc_coalescing", metrics_text)
except Exception:  # noqa: BLE001 — metrics are never load-bearing
    pass


def _batch_knobs():
    from ray_tpu_torch._private.config import global_config

    cfg = global_config()
    return (max(1, cfg.rpc_batch_max_msgs), cfg.rpc_batch_max_bytes,
            cfg.rpc_send_high_watermark)


class _WriteCoalescer:
    """Per-connection write-side coalescer. Loop-thread only.

    Write-through first: on a cold connection (nothing queued, no open
    tick window) the message is written immediately as a plain frame —
    zero added latency for serial request/response traffic — and a
    one-tick window opens; every message sent within that same
    event-loop tick queues behind it and flushes as one BATCH frame on
    the next tick (`call_soon`). Crossing the count or byte watermark
    flushes immediately. The flush itself never runs under a lock — the
    timer-started flush pattern from PR-2's pubsub batching fix. When
    the transport buffer crosses the high-watermark the coalescer stops
    writing and parks behind one awaited `drain()` (backpressure: a
    slow peer queues messages here instead of growing the kernel send
    buffer unboundedly); awaited senders can additionally park in
    `send_wait()` until the drain clears."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer
        self._loop = asyncio.get_event_loop()
        self._max_msgs, self._max_bytes, self._high_watermark = _batch_knobs()
        self._pending: List[bytes] = []
        self._pending_bytes = 0
        self._scheduled = False
        self._tick_open = False
        self._draining = False
        self._drain_waiters: List[asyncio.Future] = []
        # per-connection coalescing counters (aggregate lives in RPC_STATS)
        self.messages_sent = 0
        self.frames_sent = 0
        self.batches_sent = 0

    def send(self, msg) -> None:
        """Queue one logical `[msgid, kind, method, payload]` message."""
        body = msgpack.packb(msg, use_bin_type=True)
        self.messages_sent += 1
        RPC_STATS.messages_sent += 1
        if (not self._pending and not self._tick_open and not self._draining
                and not self._writer.is_closing()):
            # cold connection: write through — serial round trips pay no
            # coalescing latency; same-tick followers batch behind this
            self._writer.write(len(body).to_bytes(4, "big") + body)
            self.frames_sent += 1
            RPC_STATS.frames_sent += 1
            self._tick_open = True
            self._loop.call_soon(self._close_tick)
            self._check_watermark()
            return
        self._pending.append(body)
        self._pending_bytes += len(body)
        if (len(self._pending) >= self._max_msgs
                or self._pending_bytes >= self._max_bytes):
            self._flush()
        elif not self._scheduled:
            self._scheduled = True
            self._loop.call_soon(self._tick_flush)

    def _close_tick(self):
        self._tick_open = False

    def _tick_flush(self):
        self._scheduled = False
        self._flush()

    def _flush(self):
        if not self._pending or self._draining:
            return  # draining: the drain task re-flushes when it clears
        if self._writer.is_closing():
            self._pending.clear()
            self._pending_bytes = 0
            return
        bodies, self._pending = self._pending, []
        self._pending_bytes = 0
        if len(bodies) == 1:
            body = bodies[0]  # plain frame — byte-identical to unbatched
            self._writer.write(len(body).to_bytes(4, "big") + body)
        else:
            self._writer.write(_pack([0, BATCH, "", bodies]))
            self.batches_sent += 1
            RPC_STATS.batches_sent += 1
            RPC_STATS.messages_batched += len(bodies)
        self.frames_sent += 1
        RPC_STATS.frames_sent += 1
        self._check_watermark()

    def _check_watermark(self):
        transport = self._writer.transport
        if (transport is not None
                and transport.get_write_buffer_size() > self._high_watermark):
            self._draining = True
            RPC_STATS.drain_backoffs += 1
            asyncio.ensure_future(self._drain_then_flush())

    async def _drain_then_flush(self):
        try:
            await self._writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        self._draining = False
        for fut in self._drain_waiters:
            if not fut.done():
                fut.set_result(None)
        self._drain_waiters.clear()
        self._flush()

    async def wait_drained(self) -> None:
        """Park until an in-progress backpressure drain clears."""
        while self._draining:
            fut = self._loop.create_future()
            self._drain_waiters.append(fut)
            await fut

    async def send_wait(self, msg) -> None:
        """Awaited variant: when the connection is parked behind a drain,
        wait for it to clear before queueing (backpressure for `call` /
        `notify` / server replies)."""
        if self._draining:
            await self.wait_drained()
        self.send(msg)

    def flush_now(self) -> None:
        """Best-effort synchronous flush (connection teardown)."""
        self._draining = False
        self._flush()


class RpcServer:
    """Serves named async handlers. Handlers: async def h(payload) -> payload."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: Dict[str, Callable[[Any], Awaitable[Any]]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()

    def register(self, method: str, handler: Callable[[Any], Awaitable[Any]]):
        self._handlers[method] = handler

    def register_all(self, obj, prefix: str = "rpc_"):
        """Register every `rpc_*` coroutine method of obj under its bare name."""
        for name in dir(obj):
            if name.startswith(prefix):
                self.register(name[len(prefix):], getattr(obj, name))

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def stop(self):
        if self._server:
            self._server.close()
        # Cancel live connection handlers BEFORE wait_closed(): on
        # Python >= 3.12.1 wait_closed() waits for all handlers, which would
        # otherwise block forever on connections idling in _read_frame.
        for t in list(self._conn_tasks):
            t.cancel()
        if self._server:
            await self._server.wait_closed()

    async def _handle_conn(self, reader, writer):
        coal = _WriteCoalescer(writer)
        conn_task = asyncio.current_task()
        self._conn_tasks.add(conn_task)
        try:
            while True:
                try:
                    msg = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                msgs = _unbatch(msg[3]) if msg[1] == BATCH else (msg,)
                for msgid, kind, method, payload in msgs:
                    task = asyncio.ensure_future(
                        self._dispatch(msgid, kind, method, payload, coal)
                    )
                    self._conn_tasks.add(task)
                    task.add_done_callback(self._conn_tasks.discard)
        except asyncio.CancelledError:
            pass
        finally:
            self._conn_tasks.discard(conn_task)
            coal.flush_now()
            writer.close()

    async def _dispatch(self, msgid, kind, method, payload, coal):
        handler = self._handlers.get(method)
        try:
            if handler is None:
                raise RpcError(f"no handler for method {method!r}")
            result = await handler(payload)
            reply = [msgid, REPLY_OK, method, result]
        except asyncio.CancelledError:
            raise
        except BaseException:
            if kind == NOTIFY:
                logger.exception("error in notify handler %s", method)
                return
            reply = [msgid, REPLY_ERR, method, traceback.format_exc()]
        if kind == REQUEST:
            try:
                # replies completing in the same tick re-batch into one
                # frame; only the backpressured path pays an await
                if coal._draining:
                    await coal.wait_drained()
                coal.send(reply)
            except (ConnectionResetError, BrokenPipeError):
                pass


class RpcClient:
    """Persistent connection to one RpcServer; safe for concurrent requests."""

    def __init__(self, address: str, connect_timeout: float = 10.0):
        self.address = address
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._timeout = connect_timeout
        self._reader = None
        self._writer = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._msgid = itertools.count(1)
        self._read_task = None
        self._coal: Optional[_WriteCoalescer] = None
        self._closed = False
        self._dead = False  # read loop saw EOF/reset — no replies can come

    async def connect(self):
        deadline = asyncio.get_event_loop().time() + self._timeout
        while True:
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self._host, self._port
                )
                break
            except OSError:
                if asyncio.get_event_loop().time() > deadline:
                    raise
                await asyncio.sleep(0.05)
        self._coal = _WriteCoalescer(self._writer)
        self._read_task = asyncio.ensure_future(self._read_loop())
        return self

    def _resolve(self, msgid, kind, payload) -> None:
        fut = self._pending.pop(msgid, None)
        if fut is None or fut.done():
            return
        if kind == REPLY_OK:
            fut.set_result(payload)
        else:
            fut.set_exception(RpcError(payload))

    async def _deliver(self, msgid, kind, method, payload):
        # recv faults act per logical reply, even inside a BATCH frame
        if _fi._PLAN is not None:
            act = _fi._PLAN.rpc_recv(method)
            if act is not None:
                if act[1]:
                    await asyncio.sleep(act[1])  # delayed delivery
                if act[0]:
                    return  # reply lost on the wire
        self._resolve(msgid, kind, payload)

    async def _read_loop(self):
        try:
            while True:
                msg = await _read_frame(self._reader)
                # fault-free fast path resolves inline — one coroutine
                # per reply is measurable at control-plane rates
                if msg[1] == BATCH:
                    for m in _unbatch(msg[3]):
                        if _fi._PLAN is not None:
                            await self._deliver(*m)
                        else:
                            self._resolve(m[0], m[1], m[3])
                elif _fi._PLAN is not None:
                    await self._deliver(*msg)
                else:
                    self._resolve(msg[0], msg[1], msg[3])
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError,
                asyncio.CancelledError):
            # the peer is gone: no reply will EVER arrive on this
            # connection — mark dead so `connected` stops advertising it
            # (a not-yet-closing writer would otherwise let new calls
            # wait forever on a drained pending table)
            self._dead = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost(self.address))
            self._pending.clear()

    async def call(self, method: str, payload: Any = None,
                   timeout: float | None = None) -> Any:
        if self._writer is None or self._dead:
            raise ConnectionLost(f"not connected: {self.address}")
        msgid = next(self._msgid)
        fut = asyncio.get_event_loop().create_future()
        self._pending[msgid] = fut
        msg = [msgid, REQUEST, method, payload]
        dup = False
        if _fi._PLAN is not None:
            act = _fi._PLAN.rpc_send(method)
            if act is not None:
                drop, dup, delay = act
                if delay:
                    await asyncio.sleep(delay)
                if drop:
                    # request lost: the pending future only resolves via
                    # the caller's timeout / retry machinery
                    if timeout is None:
                        return await fut
                    return await asyncio.wait_for(fut, timeout)
        coal = self._coal
        if coal._draining:
            await coal.wait_drained()
        coal.send(msg)
        if dup:
            # at-least-once duplication; the second reply's msgid is
            # already popped, ignored
            coal.send(msg)
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    def call_nowait(self, method: str, payload: Any = None) -> asyncio.Future:
        """Loop-thread-only fast path: queue the request on the write
        coalescer synchronously (no drain round-trip; the coalescer's
        transport high-watermark supplies backpressure) and return the
        pending reply future."""
        if self._writer is None or self._dead:
            raise ConnectionLost(f"not connected: {self.address}")
        msgid = next(self._msgid)
        fut = asyncio.get_event_loop().create_future()
        self._pending[msgid] = fut
        msg = [msgid, REQUEST, method, payload]
        if _fi._PLAN is not None:
            act = _fi._PLAN.rpc_send(method)
            if act is not None:
                drop, dup, delay = act
                if drop:
                    return fut  # lost: resolves via caller timeout/retry
                if delay:
                    # sync fast path cannot await: reschedule the queueing
                    def _late_send(c=self._coal, m=msg, d=dup):
                        if not c._writer.is_closing():
                            c.send(m)
                            if d:
                                c.send(m)
                    asyncio.get_event_loop().call_later(delay, _late_send)
                    return fut
                if dup:
                    self._coal.send(msg)
        self._coal.send(msg)
        return fut

    async def notify(self, method: str, payload: Any = None):
        if self._writer is None or self._dead:
            raise ConnectionLost(f"not connected: {self.address}")
        msg = [0, NOTIFY, method, payload]
        dup = False
        if _fi._PLAN is not None:
            act = _fi._PLAN.rpc_send(method)
            if act is not None:
                drop, dup, delay = act
                if delay:
                    await asyncio.sleep(delay)
                if drop:
                    return  # fire-and-forget message lost entirely
        coal = self._coal
        if coal._draining:
            await coal.wait_drained()
        coal.send(msg)
        if dup:
            coal.send(msg)

    async def close(self):
        self._closed = True
        if self._read_task:
            self._read_task.cancel()
        if self._coal:
            self._coal.flush_now()
        if self._writer:
            self._writer.close()

    @property
    def connected(self) -> bool:
        return (self._writer is not None
                and not self._writer.is_closing()
                and not self._dead)


class ReconnectingClient:
    """A stable handle to a peer that may restart (the GCS): every call
    resolves the live connection through the pool and retries once after
    re-establishing it (reference: the gRPC channel's transparent
    reconnect that raylet/worker GCS clients rely on)."""

    def __init__(self, pool: "ClientPool", address: str):
        self._pool = pool
        self._address = address

    @property
    def address(self) -> str:
        return self._address

    async def call(self, method: str, payload, timeout: float = 30.0):
        for attempt in (0, 1):
            client = await self._pool.get(self._address)
            if client._dead:
                # stale pool entry: refresh and retry the CONNECT — the
                # request was never sent, so this is always safe
                self._pool.invalidate(self._address)
                if attempt:
                    raise ConnectionLost(self._address)
                await asyncio.sleep(0.2)
                continue
            try:
                return await client.call(method, payload, timeout=timeout)
            except ConnectionLost:
                # the request MAY have been applied before the peer went
                # away — blindly replaying would double-apply mutations
                # (e.g. a named-actor registration). Invalidate so the
                # next call reconnects, and surface the loss.
                self._pool.invalidate(self._address)
                raise

    async def notify(self, method: str, payload):
        client = await self._pool.get(self._address)
        try:
            await client.notify(method, payload)
        except ConnectionLost:
            self._pool.invalidate(self._address)
            raise


class ClientPool:
    """Lazily-created, cached RpcClients keyed by address (reference:
    per-service client pools in `src/ray/rpc/`)."""

    # a failed connect poisons the address briefly: callers queued
    # behind it — e.g. a raylet draining pulls whose advertised
    # location just died — fail fast instead of each serializing a
    # full connect timeout against the same dead peer
    CONNECT_FAIL_TTL_S = 3.0
    # a GCS death notice poisons for much longer: the control plane
    # already decided the peer is gone, so even the FIRST dial (a full
    # rpc_connect_timeout_s against a black hole) is wasted work. Kept
    # finite so a pathological address reuse self-heals.
    DEAD_ADDR_TTL_S = 60.0

    def __init__(self):
        self._clients: Dict[str, RpcClient] = {}
        self._locks: Dict[str, asyncio.Lock] = {}
        # addr -> (poisoned_at, ttl)
        self._connect_failed_at: Dict[str, Tuple[float, float]] = {}

    def get_cached(self, address: str) -> Optional[RpcClient]:
        """Synchronous lookup; None when no live connection exists yet."""
        client = self._clients.get(address)
        if client is not None and client.connected:
            return client
        return None

    def mark_dead(self, address: str):
        """Record an authoritative death notice (GCS node-removal):
        dials within DEAD_ADDR_TTL_S fail fast with ConnectionLost
        instead of timing out against a peer that no longer exists."""
        self._connect_failed_at[address] = (
            time.monotonic(), self.DEAD_ADDR_TTL_S)

    def mark_failed(self, address: str):
        """Record a connection to `address` lost or refused: dials
        within CONNECT_FAIL_TTL_S fail fast with ConnectionLost."""
        self._connect_failed_at[address] = (
            time.monotonic(), self.CONNECT_FAIL_TTL_S)

    def _check_poisoned(self, address: str):
        entry = self._connect_failed_at.get(address)
        if entry is None:
            return
        t, ttl = entry
        age = time.monotonic() - t
        if age < ttl:
            raise ConnectionLost(
                f"connect to {address} failed {age:.1f}s ago "
                f"(fail-fast for {ttl:.0f}s)")
        self._connect_failed_at.pop(address, None)

    async def get(self, address: str) -> RpcClient:
        client = self.get_cached(address)
        if client is not None:
            return client
        self._check_poisoned(address)
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            client = self.get_cached(address)
            if client is not None:
                return client
            # re-check under the lock: the head of the queue may have
            # just recorded the failure the rest were waiting on
            self._check_poisoned(address)
            client = RpcClient(address)
            try:
                await client.connect()
            except (OSError, asyncio.TimeoutError):
                self._connect_failed_at[address] = (
                    time.monotonic(), self.CONNECT_FAIL_TTL_S)
                raise
            self._connect_failed_at.pop(address, None)
            self._clients[address] = client
            return client

    def invalidate(self, address: str):
        client = self._clients.pop(address, None)
        if client:
            asyncio.ensure_future(client.close())

    async def close_all(self):
        # snapshot first: an invalidate() racing with shutdown would
        # otherwise mutate the dict mid-iteration; drop the per-address
        # connect locks too (the dict grows forever on a churning pool)
        clients, self._clients = list(self._clients.values()), {}
        self._locks.clear()
        self._connect_failed_at.clear()
        for client in clients:
            await client.close()
