"""Dispatch plane v2 — Python bindings for the native request ring.

The zero-Python serve hot path: clients enqueue raw request frames
into a per-node shared-memory segment where trace-id mint,
deadline check, and power-of-two replica choice happen in native code
(`native/request_ring.cc`); the replica/engine drain loop re-enters
Python ONCE PER BATCH. The controller publishes the replica snapshot
`{version, replica table, inflight counters}` into the same segment
(seqlock publish, generation-checked CAS reads — the shm_store v2
packed-word idiom), which is what lets the client-side choice run
lock-free.

Wakeups reuse the compiled-DAG channel idiom: an advisory FIFO token
beside the segment per sub-ring. `rr_enqueue` reports "ring was empty" and the
wrapper posts one token; a parked drain loop blocks in select() with a
bounded slice so a lost token costs one slice, never a hang.

Env knobs (documented in README "Dispatch plane v2"):

    RAY_TPU_NATIVE_DISPATCH      "1" routes eligible serve traffic
                                 through the ring; "0" (or unset)
                                 keeps the Python router path — the
                                 always-available fallback.
    RAY_TPU_DISPATCH_RING_SLOTS  per-replica sub-ring depth (default
                                 1024, rounded up to a power of two).

Everything degrades: if the native library can't build/load, or a
payload exceeds the slot size, or the ring is full (backpressure), the
caller falls back to the Python path — same results, fewer req/s.
`DispatchRing.stats()` says whether the ring carried the traffic.

The port's copy of `ray_tpu/serve/dispatch.py`. The knobs keep their
names and are shared with the JAX package; the names that locate a
segment are the port's own (`SEGMENT_PREFIX`: domains
`/ray_tpu_torch_ds.<digest>`, router FIFOs
`/dev/shm/ray_tpu_torch_ds.<digest>.routers.rdy`, response rings
`/ray_tpu_torch_ds.c<cookie>`), so a JAX deployment and a port
deployment of one name on one host never share a segment. The digest
covers the cluster (`cluster_key()`, its GCS address) as well as the
deployment's name, so two clusters of the port on one host that deploy
the same name keep apart too; the JAX package digests the name alone.
The library is built from `ray_tpu_torch/native/request_ring.cc`.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import logging
import os
import pickle
import queue
import select
import struct
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

ENV_FLAG = "RAY_TPU_NATIVE_DISPATCH"
ENV_SLOTS = "RAY_TPU_DISPATCH_RING_SLOTS"

# every shm name of the port's dispatch plane starts with this (the JAX
# package's start with "rtds.")
SEGMENT_PREFIX = "ray_tpu_torch_ds."

# segment encoding modes (RingHeader.mode — set by the controller when
# replicas attach, read by handles to pick the frame codec)
MODE_UNSET = 0
MODE_PICKLE = 1   # generic deployments: payload = pickle((method, ...))
MODE_RAW_LLM = 2  # serve.llm: raw token-id frames, zero pickle

# frame tags
TAG_REQUEST = 0
TAG_RESULT = 1   # unary result (pickle payload)
TAG_ERROR = 2    # terminal error (utf-8 message payload)
TAG_TOKEN = 3    # one streamed token: payload "<II" (index, token)
TAG_DONE = 4     # stream end: payload = finish reason (utf-8)

# negative rr_* return codes (keep in sync with request_ring.cc)
ERR_FULL = -1
ERR_DEADLINE = -2
ERR_TOO_BIG = -3
ERR_NO_REPLICA = -4
ERR_BAD = -5

_FLAG_WAS_EMPTY = 1

_FRAME_HDR = struct.Struct("<QQQQQIIII")  # trace,rid,deadline,enq,client,
                                          # gen,tag,len,pad
_LLM_REQ = struct.Struct("<II8s")  # max_new_tokens, n_prompt, job label
_LLM_TOK = struct.Struct("<II")    # index, token

# payload bytes of a request slot (the controller's domain geometry): one
# serve.llm frame of a prompt of up to 2048 tokens, the longest serving
# context of the port's model configs. The JAX controller's 1 KiB slots
# hold prompts of at most 252 tokens and send longer ones down the
# Python path (ERR_TOO_BIG).
REQUEST_SLOT_BYTES = _LLM_REQ.size + 4 * 2048

_STAT_KEYS = (
    "enqueued", "drained", "drain_batches", "full_rejects",
    "deadline_shed", "too_big", "no_replica", "publishes", "done_stale",
    "choice_retries", "lock_wait_ns", "lock_contended",
)

# bounded select() slice: a parked drain loop re-checks shutdown/level
# at least this often even if a wakeup token is lost (crashed peer) —
# same constant family as experimental/channel.py
_BLOCK_SLICE = 0.05

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """The native library, built on demand; None when the toolchain
    can't produce it (callers fall back to the Python path)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            from ray_tpu_torch.native import load_request_ring
            _lib = load_request_ring()
        except Exception as e:  # toolchain-less box: Python path only
            logger.warning("native dispatch unavailable: %s", e)
            _lib_failed = True
    return _lib


def native_requested() -> bool:
    """Whether the env asks for the native hot path (opt-in)."""
    return os.environ.get(ENV_FLAG, "0") == "1"


def native_available() -> bool:
    return native_requested() and _load() is not None


def ring_slots() -> int:
    try:
        return max(64, int(os.environ.get(ENV_SLOTS, "1024")))
    except ValueError:
        return 1024


def cluster_key() -> str:
    """The cluster this process belongs to: its GCS address, with a
    loopback host spelled one way ("" outside a cluster). Every process
    of a cluster (the controller, handles, replicas) computes the same
    key; two clusters on one host never do, their GCS ports differ."""
    from ray_tpu_torch._private.object_ref import get_core_worker

    cw = get_core_worker()
    addr = getattr(cw, "gcs_addr", "") or ""
    host, sep, port = addr.rpartition(":")
    if sep and host in ("localhost", "0.0.0.0", "::1", "[::1]", ""):
        addr = f"127.0.0.1:{port}"
    return addr


def _digest(deployment: str) -> str:
    key = f"{cluster_key()}\0{deployment}"
    return hashlib.sha1(key.encode()).hexdigest()[:12]


def domain_segment(deployment: str) -> str:
    """shm segment name for a deployment's dispatch domain in this
    process's cluster."""
    return f"/{SEGMENT_PREFIX}{_digest(deployment)}"


def replica_key(actor: Any) -> str:
    """Stable string identity for a replica actor handle — survives
    serialization (the controller and every router see the same key for
    the same actor), unlike a positional index or `id(handle)`."""
    raw = getattr(actor, "_actor_id", None)
    if raw is not None and hasattr(raw, "hex"):
        return raw.hex()
    return repr(actor)


def replica_cookie(actor: Any) -> int:
    """Stable nonzero u64 id for a replica actor handle — the snapshot
    table key (NOT a positional index; the whole point)."""
    digest = hashlib.sha1(replica_key(actor).encode()).digest()
    val = int.from_bytes(digest[:8], "little")
    return val or 1


def router_wake_path(deployment: str) -> str:
    """FIFO the controller posts on every replica-set version bump;
    empty-waiting routers park here instead of sleep-polling. Pure
    FIFO — works with or without the native library."""
    return f"/dev/shm/{SEGMENT_PREFIX}{_digest(deployment)}.routers.rdy"


def format_trace(trace: int) -> str:
    """A natively-minted trace id in request_recorder wire format (16
    hex chars — same shape as `mint_request_id()`), so frames stitch
    into records, `ray_tpu requests --slow`, and the unified timeline."""
    return f"{trace:016x}"


class Frame(NamedTuple):
    trace: int
    rid: int
    deadline_ns: int
    enq_ns: int
    client: int
    gen: int
    tag: int
    payload: bytes

    @property
    def trace_id(self) -> str:
        return format_trace(self.trace)


class _Wakeup:
    """Advisory FIFO token beside the segment (the compiled-DAG channel idiom):
    `post()` after an empty->nonempty transition, `wait()` parks in
    select() with a bounded slice. Tokens are advisory — level checks
    stay with the caller."""

    def __init__(self, path: str, create: bool = True):
        self._path = path
        self._create = create
        self._fd: Optional[int] = None

    def _ensure(self) -> Optional[int]:
        if self._fd is not None:
            return self._fd
        try:
            if self._create:
                try:
                    os.mkfifo(self._path)
                except FileExistsError:
                    pass
            # O_RDWR so opening never blocks and never ENXIOs
            self._fd = os.open(self._path, os.O_RDWR | os.O_NONBLOCK)
        except OSError:
            self._fd = None
        return self._fd

    def post(self) -> None:
        fd = self._ensure()
        if fd is None:
            return
        try:
            os.write(fd, b"\x01")
        except (BlockingIOError, OSError):
            pass  # full FIFO = a wakeup is already pending

    def wait(self, timeout: float) -> bool:
        """Park until a token arrives or `timeout` elapses; True when a
        token was consumed. select() runs in bounded slices so a poster
        that died between level-check and post costs one slice, never a
        hang past `timeout`."""
        fd = self._ensure()
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            if fd is None:
                time.sleep(min(left, _BLOCK_SLICE))
                if self._create:
                    return False
                # an opener waits out its timeout for the creator's FIFO
                fd = self._ensure()
                continue
            try:
                r, _, _ = select.select([fd], [], [],
                                        min(left, _BLOCK_SLICE))
            except OSError:
                time.sleep(min(left, _BLOCK_SLICE))
                return False
            if r:
                try:
                    os.read(fd, 4096)  # drain: tokens are advisory
                except OSError:
                    pass
                return True

    def close(self, unlink: bool = False) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        if unlink:
            try:
                os.unlink(self._path)
            except OSError:
                pass


class DispatchRing:
    """One dispatch domain: the native segment + its wakeup FIFOs.

    A *request* domain has table_cap sub-rings (one per snapshot slot);
    a client *response* segment is the same structure with table_cap=1
    and only `enqueue_to(0, ...)` producers.
    """

    def __init__(self, segment: str, table_cap: int = 8,
                 slots: Optional[int] = None, slot_bytes: int = 1024,
                 create: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native dispatch library unavailable")
        self._lib = lib
        self.segment = segment
        if not create and not os.path.exists(
                os.path.join("/dev/shm", segment.lstrip("/"))):
            # attach-only callers (handles, replicas attaching a client
            # response segment) must not create a segment with THEIR
            # geometry — the owner's create carries the real one
            raise FileNotFoundError(segment)
        self._h = lib.rr_open(segment.encode(), table_cap,
                              slots or ring_slots(), slot_bytes)
        if self._h < 0:
            raise RuntimeError(f"rr_open({segment}) failed")
        self.table_cap = lib.rr_table_cap(self._h)
        self.slot_bytes = lib.rr_slot_bytes(self._h)
        self.slots = lib.rr_slots(self._h)
        # allocated at the first drain: handles only enqueue
        self._drain_buf: Optional[ctypes.Array] = None
        base = os.path.join("/dev/shm", segment.lstrip("/"))
        self._wake = [_Wakeup(f"{base}.{r}.rdy")
                      for r in range(self.table_cap)]
        self._closed = False

    # -- snapshot plane (controller writes, everyone reads) ---------------

    def publish(self, version: int, ids: Sequence[int]) -> None:
        arr = (ctypes.c_uint64 * max(1, len(ids)))(*ids)
        rc = self._lib.rr_publish(self._h, version, arr, len(ids))
        if rc != 0:
            raise RuntimeError(f"rr_publish failed: {rc}")
        # replicas may be parked waiting for first frames; the publish
        # itself needs no wakeup, but empty-waiting routers do (the
        # satellite's event/wakeup replacing the 0.1 s sleep-poll)
        self.post_all()

    def mark_dead(self, rid: int) -> None:
        self._lib.rr_mark_dead(self._h, rid)

    def done(self, rid: int, gen: int) -> bool:
        return bool(self._lib.rr_done(self._h, rid, gen))

    def snapshot(self) -> Tuple[int, List[Tuple[int, int, int, int, int]]]:
        """(version, rows) where each row is (id, gen, inflight, alive,
        ring) — a seqlock-consistent copy."""
        rows = (ctypes.c_uint64 * (5 * self.table_cap))()
        ver = ctypes.c_uint64()
        n = self._lib.rr_snapshot(self._h, rows, self.table_cap,
                                  ctypes.byref(ver))
        if n < 0:
            return 0, []
        out = [(rows[i * 5], rows[i * 5 + 1], rows[i * 5 + 2],
                rows[i * 5 + 3], rows[i * 5 + 4]) for i in range(n)]
        return ver.value, out

    def version(self) -> int:
        return self._lib.rr_snapshot_version(self._h)

    def mode(self) -> int:
        return self._lib.rr_mode(self._h)

    def set_mode(self, mode: int) -> None:
        self._lib.rr_set_mode(self._h, mode)

    def ring_of(self, rid: int) -> int:
        return self._lib.rr_ring_of(self._h, rid)

    # -- data plane --------------------------------------------------------

    def enqueue(self, payload: bytes, deadline_ns: int = 0,
                client: int = 0, tag: int = TAG_REQUEST
                ) -> Tuple[int, int, int]:
        """Native hot path: mint + deadline + pow-2 choice + frame
        publish in one call. Returns (trace, rid, gen); raises on the
        shed/fallback codes (callers map them)."""
        tr = ctypes.c_uint64()
        rid = ctypes.c_uint64()
        gen = ctypes.c_uint32()
        rc = self._lib.rr_enqueue(
            self._h, payload, len(payload), deadline_ns, client, tag,
            ctypes.byref(tr), ctypes.byref(rid), ctypes.byref(gen))
        if rc < 0:
            raise DispatchRejected(int(rc))
        if rc & _FLAG_WAS_EMPTY:
            ring = self._lib.rr_ring_of(self._h, rid.value)
            if ring >= 0:
                self._wake[ring].post()
        return tr.value, rid.value, gen.value

    def enqueue_to(self, ring: int, payload: bytes, trace: int = 0,
                   client: int = 0, tag: int = TAG_RESULT) -> bool:
        """Direct enqueue into one sub-ring (response path). Returns
        False when the ring is full — callers decide whether to spin."""
        rc = self._lib.rr_enqueue_to(self._h, ring, payload,
                                     len(payload), trace, client, tag)
        if rc < 0:
            if rc == ERR_FULL:
                return False
            raise DispatchRejected(int(rc))
        if rc & _FLAG_WAS_EMPTY:
            self._wake[ring].post()
        return True

    def drain(self, ring: int, max_frames: int = 256) -> List[Frame]:
        """ONE native call per batch; Python unpacks the batch flat."""
        buf = self._drain_buf
        if buf is None:
            buf = self._drain_buf = (ctypes.c_uint8 * (
                self.slots * (_FRAME_HDR.size + self.slot_bytes)))()
        nbytes = ctypes.c_uint64()
        n = self._lib.rr_drain(self._h, ring, buf, len(buf), max_frames,
                               ctypes.byref(nbytes))
        if n <= 0:
            return []
        raw = bytes(buf[:nbytes.value])
        frames: List[Frame] = []
        off = 0
        for _ in range(n):
            (trace, rid, deadline, enq, client, gen, tag, ln,
             _pad) = _FRAME_HDR.unpack_from(raw, off)
            off += _FRAME_HDR.size
            frames.append(Frame(trace, rid, deadline, enq, client, gen,
                                tag, raw[off:off + ln]))
            off += ln
        return frames

    def pending(self, ring: int) -> int:
        return max(0, self._lib.rr_pending(self._h, ring))

    def wait(self, ring: int, timeout: float = _BLOCK_SLICE) -> None:
        self._wake[ring].wait(timeout)

    def post(self, ring: int) -> None:
        self._wake[ring].post()

    def post_all(self) -> None:
        for w in self._wake:
            w.post()

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        row = (ctypes.c_uint64 * len(_STAT_KEYS))()
        self._lib.rr_stats(self._h, row)
        return dict(zip(_STAT_KEYS, row))

    def metrics_text(self, domain: str) -> str:
        s = self.stats()
        lab = f'{{domain="{domain}"}}'
        lines = []
        for key in ("enqueued", "drained", "drain_batches",
                    "full_rejects", "deadline_shed", "no_replica",
                    "done_stale"):
            lines.append(
                f"# TYPE serve_dispatch_{key}_total counter")
            lines.append(f"serve_dispatch_{key}_total{lab} {s[key]}")
        return "\n".join(lines) + "\n"

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        for w in self._wake:
            w.close(unlink=unlink)
        self._lib.rr_detach(self._h)
        if unlink:
            self._lib.rr_unlink(self.segment.encode())

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DispatchRejected(Exception):
    """Native enqueue refused the frame; `.code` is the RR_* reason.
    FULL/TOO_BIG mean "fall back to the Python path", DEADLINE means
    "shed", NO_REPLICA means "wait or fall back"."""

    def __init__(self, code: int):
        super().__init__(f"dispatch rejected (code {code})")
        self.code = code


# ---------------------------------------------------------------------------
# client plane: per-process response segment + demux
# ---------------------------------------------------------------------------


class _PendingStream:
    """Per-request response mailbox the demux thread fills."""

    __slots__ = ("q",)

    def __init__(self):
        self.q: "queue.Queue[Frame]" = queue.Queue()


class ClientPlane:
    """Per-process response plane: one shm segment (a 1-ring domain)
    that replicas produce result/token frames into, and ONE demux
    thread that drains batches and routes frames to per-request
    mailboxes by trace id — the client side also enters Python once per
    batch.

    The client cookie IS the segment name
    (`/ray_tpu_torch_ds.c<cookie hex>`), so a replica can attach a
    requester's response segment from the 8-byte cookie riding the
    request frame — no registration round trip.
    """

    _instance: Optional["ClientPlane"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls) -> "ClientPlane":
        with cls._instance_lock:
            if cls._instance is None or cls._instance._pid != os.getpid():
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._pid = os.getpid()
        seed = int.from_bytes(os.urandom(6), "little")
        self.cookie = (seed << 16) | (self._pid & 0xffff) or 1
        self.ring = DispatchRing(client_segment(self.cookie),
                                 table_cap=1, slots=ring_slots(),
                                 slot_bytes=1024)
        self._lock = threading.Lock()
        self._pending: Dict[int, _PendingStream] = {}
        # frames that beat their waiter registration (enqueue returns
        # the trace AFTER the replica could already have replied)
        self._orphans: Dict[int, List[Frame]] = {}
        self._stop = False
        self._thread = threading.Thread(target=self._demux, daemon=True,
                                        name="dispatch_demux")
        self._thread.start()
        # the cookie names a real shm segment; reclaim it when the owning
        # process exits (guarded against forked children in close()).
        atexit.register(self.close)

    def register(self, trace: int) -> _PendingStream:
        ps = _PendingStream()
        with self._lock:
            for f in self._orphans.pop(trace, ()):
                ps.q.put(f)
            self._pending[trace] = ps
        return ps

    def unregister(self, trace: int) -> None:
        with self._lock:
            self._pending.pop(trace, None)
            self._orphans.pop(trace, None)

    def _demux(self) -> None:
        while not self._stop:
            frames = self.ring.drain(0, max_frames=512)
            if not frames:
                self.ring.wait(0, _BLOCK_SLICE)
                continue
            with self._lock:
                for f in frames:
                    ps = self._pending.get(f.trace)
                    if ps is not None:
                        ps.q.put(f)
                    else:
                        box = self._orphans.setdefault(f.trace, [])
                        box.append(f)
                        if len(self._orphans) > 4096:  # bounded
                            self._orphans.pop(next(iter(self._orphans)))

    def close(self) -> None:
        if os.getpid() != self._pid or self._stop:
            return  # forked child: the segment belongs to the parent
        self._stop = True
        self.ring.post(0)
        self._thread.join(timeout=2)
        self.ring.close(unlink=True)


def close_client_plane() -> None:
    """Closes this process's response ring, if it opened one (the next
    native request opens a new one)."""
    with ClientPlane._instance_lock:
        plane, ClientPlane._instance = ClientPlane._instance, None
    if plane is not None:
        plane.close()


def client_segment(cookie: int) -> str:
    return f"/{SEGMENT_PREFIX}c{cookie:016x}"


# replica-side cache of requester response segments, keyed by cookie —
# attaching is a one-time mmap per (replica process, client process)
_resp_lock = threading.Lock()
_resp_rings: Dict[int, DispatchRing] = {}


def response_ring(cookie: int) -> Optional[DispatchRing]:
    with _resp_lock:
        ring = _resp_rings.get(cookie)
        if ring is None:
            try:
                ring = DispatchRing(client_segment(cookie), table_cap=1,
                                    slots=ring_slots(), slot_bytes=1024,
                                    create=False)
            except Exception:
                return None  # client gone: drop the response
            _resp_rings[cookie] = ring
        return ring


# ---------------------------------------------------------------------------
# frame codecs
# ---------------------------------------------------------------------------


def encode_llm_request(prompt: Sequence[int], max_new_tokens: int,
                       job: str) -> bytes:
    """Zero-pickle serve.llm request frame: two u32s + the job label +
    raw u32 prompt token ids."""
    body = _LLM_REQ.pack(max_new_tokens, len(prompt),
                         job.encode()[:8].ljust(8, b"\x00"))
    return body + struct.pack(f"<{len(prompt)}I", *prompt)


def decode_llm_request(payload: bytes) -> Tuple[List[int], int, str]:
    max_new, n, job = _LLM_REQ.unpack_from(payload, 0)
    toks = struct.unpack_from(f"<{n}I", payload, _LLM_REQ.size)
    return list(toks), max_new, job.rstrip(b"\x00").decode() or "none"


def encode_call(method: str, args: tuple, kwargs: dict,
                job: str) -> bytes:
    """Generic-deployment request frame. The arguments are pickled ONCE
    here (the Python path pickles per-hop); everything else in the
    frame stays raw."""
    return pickle.dumps((method, args, kwargs, job),
                        protocol=pickle.HIGHEST_PROTOCOL)


def decode_call(payload: bytes) -> Tuple[str, tuple, dict, str]:
    return pickle.loads(payload)
