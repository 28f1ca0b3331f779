"""Mutable shared-memory channels between actor processes.

Reference: the compiled-graph (aDAG) channel layer —
`src/ray/core_worker/experimental_mutable_object_manager.h:37` and
`python/ray/experimental/channel/shared_memory_channel.py`. A channel is
a PRE-ALLOCATED single-writer/single-reader shm buffer reused across
executions: writing a new value mutates the buffer in place and bumps a
sequence number instead of creating an object + submitting a task, which
is what makes a compiled DAG's steady-state latency land in microseconds
instead of the task-submission path's hundreds.

Synchronization is a seqlock-style pair of 8-byte counters (write_seq
advanced only by the writer, read_seq only by the reader) — no
cross-process mutex, so a crashed peer can never leave the lock held.
The payload store happens before the seq bump in program order; on
x86-64's total-store-order memory model the reader observing the new
seq therefore observes the payload. (A weakly-ordered ISA would need
explicit fences here.)

Waiting is NOT a poll loop: each channel carries two advisory-wakeup
FIFOs next to its shm segment (`<name>.rdy` wakes the reader after a
publish, `<name>.fre` wakes the writer after a release). A waiter
re-checks the seq pair, then blocks in select() on its FIFO; the peer
writes a token AFTER updating its counter, so the select returns
immediately — a kernel-directed wakeup instead of a timeslice lottery:
sched_yield-style backoff leaves the handoff to the scheduler, which
parks spinners for whole timeslices on a busy host. Tokens are advisory
(extra tokens cause one spurious re-check, and a bounded select timeout
re-checks the shutdown flag), so a crashed peer still can't wedge the
channel. Hosts without FIFO support fall back to the old spin->sleep
backoff.

Channels are same-node by construction (POSIX shm). For tensors on the
card the compiled path is the fused chain — see ray_tpu_torch/dag.py
`torch_stage` — which runs as one CUDA graph; these channels are the
host-side control/data plane for actor graphs.

The port's differences from the JAX package's channels: segments and
their FIFOs are named `ray_tpu_torch_ch_<pid>_...` (the JAX package's
`rtpu_ch_<pid>_...`), so the two packages' channels on one host never
meet; and a frame carries torch tensors by the runtime's wire rules
(`ray_tpu_torch._private.serialization._reduce_tensor`), in band: a
CUDA tensor is copied to the host at the write and restored onto the
reader's card, and a reader that sees no GPU raises. A frame with no
tensor is byte for byte the JAX package's.

Frame format (the zero-pickle hot path): a frame is a fixed raw header
— tag byte, 8-byte LE seq — followed by the payload bytes, written in
place into the shm buffer. Readers parse tag and seq straight from the
header, so a stale frame (driver timed out and bumped its execution
counter) is discarded by releasing the slot WITHOUT deserializing the
payload; only a current frame's payload is unpickled, zero-copy, from a
memoryview over the shm segment. Writers serialize once into a reusable
`FrameScratch` and memcpy the same view into every consumer edge — no
per-call `pickle.dumps` allocation, no (tag, seq, value) tuple.
"""

from __future__ import annotations

import os
import pickle
import select
import sys
import tempfile
import time
import uuid
from multiprocessing import shared_memory
from typing import Optional, Tuple

_HEADER = 32  # write_seq | read_seq | length | flags — 4 x 8 bytes LE
_FLAG_SHUTDOWN = 1

# the port's own name space in /dev/shm (the JAX package's: "rtpu_ch_")
SEGMENT_PREFIX = "ray_tpu_torch_ch_"

_FRAME = 16   # tag (1 byte) | pad (7) | seq (8 bytes LE)
TAG_OK = 0
TAG_ERR = 1

# bounded select() slice: a waiter re-checks the shutdown flag at least
# this often even if a wakeup token is lost (crashed peer)
_BLOCK_SLICE = 0.05


def _fifo_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") \
        else tempfile.gettempdir()


class _ChannelStats:
    """Process-wide frame-plane counters (flight-recorder plane).

    Hot-path cost is plain integer increments; blocked-wait time is
    only measured when a wait actually parks, so the fast path pays
    nothing for it. Exposed as a
    scrape-time /metrics callback — no metric objects are constructed
    per call (see raylint `metric-in-hot-loop`)."""

    __slots__ = ("frames_written", "frames_read", "stale_skips",
                 "write_wait_ns", "read_wait_ns", "wakeup_tokens")

    def __init__(self):
        self.frames_written = 0
        self.frames_read = 0
        self.stale_skips = 0
        self.write_wait_ns = 0
        self.read_wait_ns = 0
        self.wakeup_tokens = 0

    def as_dict(self) -> dict:
        return {
            "frames_written": self.frames_written,
            "frames_read": self.frames_read,
            "stale_skips": self.stale_skips,
            "write_wait_ms": round(self.write_wait_ns / 1e6, 3),
            "read_wait_ms": round(self.read_wait_ns / 1e6, 3),
            "wakeup_tokens": self.wakeup_tokens,
        }


CHANNEL_STATS = _ChannelStats()


def channel_stats() -> dict:
    return CHANNEL_STATS.as_dict()


def note_stale_skip() -> None:
    """A stale frame was released from its raw header without
    deserializing the payload (driver timeout recovery)."""
    CHANNEL_STATS.stale_skips += 1


def _stats_metrics_text() -> str:
    s = CHANNEL_STATS
    return (
        "# TYPE channel_frames_total counter\n"
        f'channel_frames_total{{op="write"}} {s.frames_written}\n'
        f'channel_frames_total{{op="read"}} {s.frames_read}\n'
        "# TYPE channel_stale_skips_total counter\n"
        f"channel_stale_skips_total {s.stale_skips}\n"
        "# TYPE channel_wait_ms_total counter\n"
        f'channel_wait_ms_total{{side="write"}} '
        f"{round(s.write_wait_ns / 1e6, 3)}\n"
        f'channel_wait_ms_total{{side="read"}} '
        f"{round(s.read_wait_ns / 1e6, 3)}\n")


def _register_metrics() -> None:
    from ray_tpu_torch.util import metrics as _metrics

    _metrics.DEFAULT_REGISTRY.register_callback(
        "channel_frames", _stats_metrics_text)


_register_metrics()


class ChannelClosedError(RuntimeError):
    """The channel was shut down by its owner (compiled DAG teardown)."""


def _pause(spins: int) -> None:
    # Fallback for hosts without FIFO wakeups. Tuned for the
    # sub-millisecond round-trip regime: stay on the zero-sleep probe
    # longer and cap the parked sleep at 200 µs — the old 1 ms cap
    # could bill a frame that arrived just after parking half a
    # round-trip's worth of idle time.
    if spins < 400:
        time.sleep(0)  # yield the GIL, stay hot
    else:
        time.sleep(min(2e-4, 1e-5 * (spins - 399)))


class _FramePickler(pickle.Pickler):
    """The frame pickler: plain pickle, but a torch tensor is reduced by
    the runtime's wire rules, its bytes in band. Nothing here imports
    torch: a value can hold a tensor only once torch is loaded."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in (torch.Tensor,
                                               torch.nn.Parameter):
            from ray_tpu_torch._private.serialization import _reduce_tensor

            reduced = _reduce_tensor(torch, obj)
            if reduced is not None:
                return reduced
        return NotImplemented


class FrameScratch:
    """Reusable serialization buffer: pickle a value once, hand out a
    zero-copy view to write into any number of edges. Grows
    geometrically and is never shrunk, so a steady-state pipeline does
    no per-call allocation at all."""

    __slots__ = ("_buf", "_len")

    def __init__(self, initial: int = 1024):
        self._buf = bytearray(initial)
        self._len = 0

    def write(self, data) -> int:
        """File-like sink for pickle.Pickler. Any buffer: the pickler
        hands a large in-band buffer (a tensor's bytes) over as the
        `PickleBuffer` itself."""
        data = memoryview(data).cast("B")
        n = data.nbytes
        end = self._len + n
        if end > len(self._buf):
            grow = max(end, 2 * len(self._buf))
            self._buf.extend(b"\x00" * (grow - len(self._buf)))
        self._buf[self._len:end] = data
        self._len = end
        return n

    def pack(self, value) -> memoryview:
        """Serialize `value` into the scratch; the returned view is valid
        until the next pack()."""
        self._len = 0
        _FramePickler(self, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
        return memoryview(self._buf)[:self._len]


class ShmChannel:
    """Single-writer single-reader mutable buffer (capacity fixed at
    creation). `write` blocks until the reader consumed the previous
    value (depth-1 backpressure — the aDAG execution semantics: one
    in-flight value per edge)."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool,
                 name: Optional[str] = None):
        self._shm = shm
        self._owner = owner
        self._buf = shm.buf
        self._name = name or shm.name.lstrip("/")
        self._rdy_fd: Optional[int] = None  # tokens: data published
        self._fre_fd: Optional[int] = None  # tokens: slot released
        self._fifo_paths: Tuple[str, ...] = ()
        self._open_fifos()

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, name: str, capacity: int = 8 << 20) -> "ShmChannel":
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=_HEADER + capacity)
        shm.buf[:_HEADER] = b"\x00" * _HEADER
        return cls(shm, owner=True, name=name)

    @classmethod
    def attach(cls, name: str) -> "ShmChannel":
        return cls(shared_memory.SharedMemory(name=name), owner=False,
                   name=name)

    @staticmethod
    def make_name(index: int) -> str:
        return (f"{SEGMENT_PREFIX}{os.getpid()}_"
                f"{uuid.uuid4().hex[:12]}_{index}")

    def _open_fifos(self) -> None:
        """Best-effort wakeup FIFOs beside the shm segment; on any
        failure the channel silently degrades to the spin fallback."""
        paths = []
        fds = []
        try:
            base = os.path.join(_fifo_dir(), self._name)
            for suffix in (".rdy", ".fre"):
                path = base + suffix
                try:
                    os.mkfifo(path)
                except FileExistsError:
                    pass
                paths.append(path)
                # O_RDWR: never blocks on open and keeps the FIFO alive
                # with a single endpoint attached
                fds.append(os.open(path, os.O_RDWR | os.O_NONBLOCK))
        except (OSError, AttributeError, NotImplementedError):
            for fd in fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            return
        self._rdy_fd, self._fre_fd = fds
        self._fifo_paths = tuple(paths)

    def _token(self, fd: Optional[int]) -> None:
        if fd is None:
            return
        try:
            os.write(fd, b"\x00")
        except (BlockingIOError, OSError):
            pass  # full FIFO still wakes the peer; closed fd is benign

    def _block(self, fd: Optional[int], spins: int,
               deadline: Optional[float]) -> None:
        """Wait for a wakeup token (or fall back to the spin pause),
        bounded so shutdown/timeout are always re-checked."""
        if fd is None:
            _pause(spins)
            return
        timeout = _BLOCK_SLICE
        if deadline is not None:
            timeout = min(timeout, max(0.0, deadline - time.monotonic()))
        try:
            select.select([fd], [], [], timeout)
            os.read(fd, 4096)  # drain: tokens are advisory, level-check
        except (BlockingIOError, OSError, ValueError):
            pass

    def close(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except (OSError, BufferError):
            pass
        for fd in (self._rdy_fd, self._fre_fd):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._rdy_fd = self._fre_fd = None

    def destroy(self) -> None:
        """Owner side: signal shutdown, then unlink the segment."""
        try:
            self._set(3, _FLAG_SHUTDOWN)
        except (TypeError, ValueError):
            pass  # already closed
        # wake any peer parked in select() so it sees the flag now
        self._token(self._rdy_fd)
        self._token(self._fre_fd)
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
        for path in self._fifo_paths:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- header ------------------------------------------------------------

    def _get(self, slot: int) -> int:
        return int.from_bytes(self._buf[slot * 8:(slot + 1) * 8], "little")

    def _set(self, slot: int, value: int) -> None:
        self._buf[slot * 8:(slot + 1) * 8] = value.to_bytes(8, "little")

    @property
    def capacity(self) -> int:
        return len(self._buf) - _HEADER

    def signal_shutdown(self) -> None:
        self._set(3, self._get(3) | _FLAG_SHUTDOWN)
        self._token(self._rdy_fd)
        self._token(self._fre_fd)

    def _check_open(self) -> None:
        if self._get(3) & _FLAG_SHUTDOWN:
            raise ChannelClosedError("channel was shut down")

    # -- data path ---------------------------------------------------------

    def _wait_writable(self, timeout: Optional[float]) -> None:
        """Block until the depth-1 slot is free (previous value
        consumed). Parked time is charged to CHANNEL_STATS only when the
        wait actually loops — the already-free fast path pays nothing."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        waited_from = None
        while self._get(0) != self._get(1):
            if waited_from is None:
                waited_from = time.perf_counter_ns()
            self._check_open()
            if deadline is not None and time.monotonic() > deadline:
                CHANNEL_STATS.write_wait_ns += (
                    time.perf_counter_ns() - waited_from)
                raise TimeoutError("channel write timed out")
            self._block(self._fre_fd, spins, deadline)
            spins += 1
        if waited_from is not None:
            CHANNEL_STATS.write_wait_ns += (
                time.perf_counter_ns() - waited_from)
        self._check_open()

    def _wait_readable(self, timeout: Optional[float]) -> None:
        """Block until a value is published."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        waited_from = None
        while self._get(0) == self._get(1):
            if waited_from is None:
                waited_from = time.perf_counter_ns()
            self._check_open()
            if deadline is not None and time.monotonic() > deadline:
                CHANNEL_STATS.read_wait_ns += (
                    time.perf_counter_ns() - waited_from)
                raise TimeoutError("channel read timed out")
            self._block(self._rdy_fd, spins, deadline)
            spins += 1
        if waited_from is not None:
            CHANNEL_STATS.read_wait_ns += (
                time.perf_counter_ns() - waited_from)

    def write(self, data: bytes, timeout: Optional[float] = None) -> None:
        if len(data) > self.capacity:
            raise ValueError(
                f"value of {len(data)} bytes exceeds channel capacity "
                f"{self.capacity}")
        self._wait_writable(timeout)
        self._buf[_HEADER:_HEADER + len(data)] = data
        self._set(2, len(data))
        self._set(0, self._get(0) + 1)  # publish AFTER the payload store
        self._token(self._rdy_fd)

    def read(self, timeout: Optional[float] = None) -> bytes:
        self._wait_readable(timeout)
        n = self._get(2)
        data = bytes(self._buf[_HEADER:_HEADER + n])
        self._set(1, self._get(1) + 1)  # release the slot to the writer
        self._token(self._fre_fd)
        return data

    # -- frame path (zero-pickle compiled-DAG hot loop) --------------------

    def write_frame(self, tag: int, seq: int, payload,
                    timeout: Optional[float] = None) -> None:
        """Write a raw-header frame: tag byte + 8-byte seq, then the
        payload bytes copied in place from `payload` (any buffer —
        typically a FrameScratch view, so a fan-out producer serializes
        once and memcpys per edge)."""
        n = len(payload)
        if _FRAME + n > self.capacity:
            raise ValueError(
                f"frame of {n} payload bytes exceeds channel capacity "
                f"{self.capacity - _FRAME}")
        self._wait_writable(timeout)
        buf = self._buf
        buf[_HEADER] = tag
        buf[_HEADER + 8:_HEADER + 16] = seq.to_bytes(8, "little")
        buf[_HEADER + _FRAME:_HEADER + _FRAME + n] = payload
        self._set(2, _FRAME + n)
        self._set(0, self._get(0) + 1)  # publish AFTER the payload store
        self._token(self._rdy_fd)
        CHANNEL_STATS.frames_written += 1

    def read_frame(
            self, timeout: Optional[float] = None
    ) -> Tuple[int, int, memoryview]:
        """Block until a frame is available and return (tag, seq,
        payload_view) with tag and seq parsed from the raw header — the
        payload is NOT deserialized. The view aliases the shm buffer:
        the caller inspects seq, unpickles the view only when current,
        and MUST call release_frame() afterwards (a stale frame is
        released without ever touching the payload)."""
        self._wait_readable(timeout)
        buf = self._buf
        n = self._get(2)
        tag = buf[_HEADER]
        seq = int.from_bytes(buf[_HEADER + 8:_HEADER + 16], "little")
        CHANNEL_STATS.frames_read += 1
        return tag, seq, buf[_HEADER + _FRAME:_HEADER + n]

    def release_frame(self) -> None:
        """Release the slot of the last read_frame() to the writer. Any
        payload view from that read_frame() is dead after this call."""
        self._set(1, self._get(1) + 1)
        self._token(self._fre_fd)
