"""Python binding for the native shared-memory object store.

The raylet creates one arena per node (`ObjectStore.create`); every worker on
the node attaches (`ObjectStore.attach`). Reads are zero-copy: Python mmaps
the same shm file the C++ library manages and returns memoryview slices over
the data region, so `get` of a numpy array is a view onto shared memory
(reference: plasma client `src/ray/object_manager/plasma/client.cc` +
`python/ray/_private/serialization.py` zero-copy reads).
"""

from __future__ import annotations

import mmap
import os
import sys

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.native import load_shm_store

import ctypes

SS_OK = 0
SS_EXISTS = -1
SS_NOT_FOUND = -2
SS_NO_MEMORY = -3
SS_TABLE_FULL = -4
SS_TIMEOUT = -5
SS_NOT_SEALED = -6
SS_QUOTA = -9


class ObjectStoreError(Exception):
    pass


class ObjectStoreFullError(ObjectStoreError):
    pass


class ObjectTimeoutError(ObjectStoreError):
    pass


class QuotaExceededError(ObjectStoreError):
    """The creating job is at its per-job object-store byte quota and
    has no evictable objects of its own left to reclaim. Only the
    offending job sees this — other tenants' puts and objects are
    untouched (the quota sweep never crosses job boundaries)."""


def job_key(job_id_binary: bytes) -> int:
    """Fold a 16-byte JobID into the u64 accounting key the native
    store tracks. XOR of the two halves so small `JobID.from_int`
    values (big-endian, value in the tail) still map to nonzero keys;
    key 0 (the nil job) means untracked — v2 semantics, no quota."""
    a = int.from_bytes(job_id_binary[:8], "little")
    b = int.from_bytes(job_id_binary[8:16], "little")
    return a ^ b


class PlasmaBuffer:
    """Holds one store reference for the lifetime of its zero-copy views.

    Views are exported through the PEP-688 buffer protocol on 3.12+, so any
    memoryview slice (and any numpy array reconstructed from one by pickle5)
    keeps this object alive; when the last view is garbage-collected, __del__
    drops the store refcount and the object becomes evictable again. This
    mirrors the reference's plasma client Buffer semantics
    (src/ray/object_manager/plasma/client.cc — release-on-buffer-destruction).

    Interpreters older than 3.12 cannot export a buffer from pure Python
    (`__buffer__` is ignored and memoryview(self) raises TypeError), so
    `export()` re-exports the view through a ctypes array: the array pins the
    underlying view, derived memoryviews pin the array, and an attribute on
    the array pins this object — the same release-on-last-view lifetime.
    """

    __slots__ = ("_store", "_id_bytes", "_view", "__weakref__")

    def __init__(self, store: "ObjectStore", id_bytes: bytes, view: memoryview):
        self._store = store
        self._id_bytes = id_bytes
        self._view = view

    def __buffer__(self, flags: int) -> memoryview:
        return self._view

    def export(self) -> memoryview:
        """A memoryview over the object's bytes that holds the store ref."""
        if sys.version_info >= (3, 12):
            return memoryview(self)
        arr = (ctypes.c_char * self._view.nbytes).from_buffer(self._view)
        arr._plasma_ref = self  # released when the last derived view dies
        return memoryview(arr)

    @property
    def nbytes(self) -> int:
        return self._view.nbytes

    def __del__(self):
        store = self._store
        if store is None:
            return
        # snapshot: close() nulls _lib/_h BEFORE detaching, so a __del__
        # racing close()/destroy() either sees a live handle or a dead
        # store — never a detached handle index another attach may have
        # reused (which would corrupt the new store's refcounts)
        lib, h = store._lib, store._h
        if lib is not None and h >= 0:
            lib.ss_release(h, self._id_bytes)


class ObjectStore:
    def __init__(self, name: str, handle: int, lib):
        self._name = name
        self._lib = lib
        self._h = handle
        self._job_key = 0       # creator attribution for puts (0 = none)
        self._job_labels = {}   # job key -> short hex label for /metrics
        self._data_off = lib.ss_data_offset(handle)
        map_size = lib.ss_map_size(handle)
        fd = os.open(f"/dev/shm{name}", os.O_RDWR)
        try:
            self._mmap = mmap.mmap(fd, map_size)
        finally:
            os.close(fd)
        self._view = memoryview(self._mmap)

    # -- lifecycle --------------------------------------------------------

    @classmethod
    def create(cls, name: str, capacity: int, table_size: int = 65536,
               shards: int = 0):
        """Create a store arena. `shards` picks the index/allocator
        stripe count (0 = scale with capacity: one stripe per 128 MB,
        capped at 16 — small test stores keep single-lock semantics).
        `RAY_TPU_STORE_SHARDS` overrides the default."""
        lib = load_shm_store()
        if shards == 0:
            shards = int(os.environ.get("RAY_TPU_STORE_SHARDS", "0"))
        h = lib.ss_create_store(name.encode(), capacity, table_size, shards)
        if h < 0:
            raise ObjectStoreError(f"failed to create store {name}: {h}")
        return cls(name, h, lib)

    @classmethod
    def attach(cls, name: str):
        lib = load_shm_store()
        h = lib.ss_attach(name.encode())
        if h < 0:
            raise ObjectStoreError(f"failed to attach store {name}: {h}")
        return cls(name, h, lib)

    def close(self):
        if self._h < 0:
            return
        lib, h = self._lib, self._h
        # Invalidate the handle BEFORE detaching: a late
        # PlasmaBuffer.__del__ (GC on another thread) must observe a
        # dead store rather than call ss_release on a handle index a
        # subsequent attach may have reused.
        self._h = -1
        self._lib = None
        lib.ss_detach(h)
        self._view.release()
        try:
            self._mmap.close()
        except BufferError:
            # Zero-copy views handed to callers still reference the
            # mapping; it is reclaimed when they are garbage-collected.
            pass

    def destroy(self):
        name, lib = self._name, self._lib
        self.close()
        if lib is None:  # already closed earlier; unlink still applies
            from ray_tpu_torch.native import load_shm_store

            lib = load_shm_store()
        lib.ss_unlink_store(name.encode())

    # -- data plane -------------------------------------------------------

    def _slice(self, offset: int, size: int) -> memoryview:
        start = self._data_off + offset
        return self._view[start : start + size]

    def set_current_job(self, job_id_binary: bytes, label: str = "") -> None:
        """Stamp every subsequent create/put from this process with the
        job as creator (per-job byte accounting + quota enforcement).
        Called once after attach by workers/drivers with their JobID."""
        key = job_key(job_id_binary)
        self._job_key = key
        if key:
            self._job_labels[key] = label or job_id_binary.hex()[:8]

    def create_buffer(self, object_id: ObjectID, size: int) -> memoryview:
        if self._lib is None or self._h < 0:
            raise ObjectStoreError("store is closed")
        off = self._lib.ss_create_job(
            self._h, object_id.binary(), size, self._job_key)
        if off == SS_EXISTS:
            raise ObjectStoreError(f"object already exists: {object_id}")
        if off in (SS_NO_MEMORY, SS_TABLE_FULL):
            raise ObjectStoreFullError(
                f"object store out of {'memory' if off == SS_NO_MEMORY else 'table slots'}"
            )
        if off == SS_QUOTA:
            raise QuotaExceededError(
                f"job {self._job_labels.get(self._job_key, self._job_key)} "
                f"is at its object-store byte quota")
        if off < 0:
            raise ObjectStoreError(f"create failed: {off}")
        return self._slice(off, size)

    def seal(self, object_id: ObjectID):
        if self._lib is None or self._h < 0:
            raise ObjectStoreError("store is closed")
        rc = self._lib.ss_seal(self._h, object_id.binary())
        if rc not in (SS_OK, SS_EXISTS):
            raise ObjectStoreError(f"seal failed: {rc}")

    def put_value(self, object_id: ObjectID, value) -> int:
        """One-copy put: create the writer-private shm buffer first, then
        serialize the frame directly into it, then seal (reference:
        plasma create→write→seal). The payload is copied exactly once —
        from the caller's arrays into shared memory; the pickle stream
        is written from a view of the pickler's buffer, never
        materialized as intermediate bytes. Returns stored size; the
        creator reference is dropped (the object is immediately
        evictable once unreferenced)."""
        sv = serialization.serialize_value(value)
        buf = self.create_buffer(object_id, sv.size)
        try:
            sv.write_into(buf)
        except BaseException:
            self.delete(object_id)  # abort the unsealed create
            raise
        self.seal(object_id)
        self.release(object_id)
        return sv.size

    def put_serialized(self, object_id: ObjectID, pickled: bytes, buffers) -> int:
        """Write a framed serialized value; returns stored size."""
        size = serialization.serialized_size(pickled, buffers)
        buf = self.create_buffer(object_id, size)
        serialization.write_to(buf, pickled, buffers)
        self.seal(object_id)
        self.release(object_id)
        return size

    def put_raw(self, object_id: ObjectID, data: bytes | memoryview) -> int:
        """Store pre-framed bytes verbatim (used by object transfer)."""
        data = memoryview(data)
        buf = self.create_buffer(object_id, data.nbytes)
        serialization._fast_copy(buf, data)
        self.seal(object_id)
        self.release(object_id)
        return data.nbytes

    def get_buffer(self, object_id: ObjectID, timeout: float | None = -1
                   ) -> memoryview | None:
        """Framed bytes of a sealed object as a zero-copy view, or None.

        The returned memoryview holds one store reference (via PlasmaBuffer):
        the object cannot be evicted until the view — and every view derived
        from it, including numpy arrays from `get` — is garbage-collected.

        timeout: -1/None = non-blocking; 0 = wait forever; >0 = wait seconds.
        """
        if self._lib is None or self._h < 0:
            raise ObjectStoreError("store is closed")
        size = ctypes.c_uint64()
        t = -1.0 if timeout is None else float(timeout)
        off = self._lib.ss_get(self._h, object_id.binary(), ctypes.byref(size), t)
        if off in (SS_NOT_FOUND, SS_NOT_SEALED):
            return None
        if off == SS_TIMEOUT:
            raise ObjectTimeoutError(f"timed out waiting for {object_id}")
        if off < 0:
            raise ObjectStoreError(f"get failed: {off}")
        raw = self._slice(off, size.value)
        return PlasmaBuffer(self, object_id.binary(), raw).export()

    def get(self, object_id: ObjectID, timeout: float | None = -1):
        buf = self.get_buffer(object_id, timeout)
        if buf is None:
            return None
        return serialization.deserialize(buf)

    def contains(self, object_id: ObjectID) -> bool:
        if self._lib is None or self._h < 0:
            return False
        return self._lib.ss_contains(self._h, object_id.binary()) == 2

    def release(self, object_id: ObjectID):
        if self._lib is None or self._h < 0:
            return  # closed: nothing to release (benign at shutdown)
        self._lib.ss_release(self._h, object_id.binary())

    def delete(self, object_id: ObjectID):
        if self._lib is None or self._h < 0:
            return
        self._lib.ss_delete(self._h, object_id.binary())

    def evict(self, nbytes: int) -> int:
        if self._lib is None or self._h < 0:
            return 0
        return self._lib.ss_evict(self._h, nbytes)

    # -- ownership GC / recovery plane ------------------------------------

    def set_primary(self, object_id: ObjectID, flag: bool = True) -> bool:
        """Mark (or clear) the primary-copy location hint. The raylet
        sets it when it pins an object as the authoritative copy for an
        owner; replicas pulled from peers stay unmarked. Advisory: loss
        sweeps and the drop_objects chaos fault use it to tell primary
        data from caches. Returns False when the object is absent."""
        if self._lib is None or self._h < 0:
            return False
        return self._lib.ss_set_primary(
            self._h, object_id.binary(), 1 if flag else 0) == SS_OK

    def is_primary(self, object_id: ObjectID) -> bool:
        if self._lib is None or self._h < 0:
            return False
        return self._lib.ss_is_primary(self._h, object_id.binary()) == 1

    def refcount(self, object_id: ObjectID) -> int:
        """Client reference count of a stored object (creator + live
        buffer views), or -1 when absent. The owner's free-on-zero path
        checks this before force-delete: yanking a slot with mapped
        views alive would corrupt zero-copy readers."""
        if self._lib is None or self._h < 0:
            return -1
        rc = self._lib.ss_refcount(self._h, object_id.binary())
        return -1 if rc < 0 else int(rc)

    def list_sealed(self, max_objects: int = 65536) -> list:
        """Sealed objects as (ObjectID, primary, referenced) rows — a
        per-shard-consistent snapshot for chaos sweeps and loss
        accounting."""
        if self._lib is None or self._h < 0:
            return []
        ids = (ctypes.c_uint8 * (max_objects * 16))()
        flags = (ctypes.c_uint8 * max_objects)()
        n = self._lib.ss_list_sealed(self._h, ids, flags, max_objects)
        out = []
        for i in range(max(n, 0)):
            oid = ObjectID(bytes(ids[i * 16:(i + 1) * 16]))
            out.append((oid, bool(flags[i] & 1), bool(flags[i] & 2)))
        return out

    # -- per-job accounting (multi-tenant quota plane) --------------------

    def set_job_quota(self, job_id_binary: bytes, quota_bytes: int,
                      label: str = "") -> None:
        """Set (0 = clear) a job's object-store byte quota on this
        arena. A job at its quota reclaims its own evictable objects
        first, then gets QuotaExceededError — never another job's
        bytes."""
        if self._lib is None or self._h < 0:
            raise ObjectStoreError("store is closed")
        key = job_key(job_id_binary)
        if not key:
            return  # nil job: untracked by design
        self._job_labels[key] = label or job_id_binary.hex()[:8]
        rc = self._lib.ss_set_job_quota(self._h, key, quota_bytes)
        if rc == SS_TABLE_FULL:
            raise ObjectStoreError("job accounting table full")
        if rc != SS_OK:
            raise ObjectStoreError(f"set_job_quota failed: {rc}")

    def job_stats(self, job_id_binary: bytes) -> dict | None:
        """This job's accounting row, or None if it never touched the
        store (and has no quota)."""
        if self._lib is None or self._h < 0:
            return None
        key = job_key(job_id_binary)
        return self._job_stats_by_key(key)

    def _job_stats_by_key(self, key: int) -> dict | None:
        if not key:
            return None
        row = (ctypes.c_uint64 * 5)()
        if self._lib.ss_job_stats(self._h, key, row) != SS_OK:
            return None
        return {
            "quota": row[0],
            "used": row[1],
            "evicted_bytes": row[2],
            "quota_rejects": row[3],
            "num_objects": row[4],
        }

    def jobs(self) -> dict:
        """All active accounting rows keyed by job label (hex prefix of
        the JobID when known, else the raw key)."""
        out = {}
        if self._lib is None or self._h < 0:
            return out
        keys = (ctypes.c_uint64 * 32)()
        n = self._lib.ss_job_list(self._h, keys, 32)
        for i in range(max(n, 0)):
            st = self._job_stats_by_key(keys[i])
            if st is not None:
                label = self._job_labels.get(keys[i], f"{keys[i]:016x}")
                out[label] = st
        return out

    def evict_job(self, nbytes: int, job_id_binary: bytes) -> int:
        """Reclaim up to nbytes from ONE job's own evictable objects."""
        if self._lib is None or self._h < 0:
            return 0
        key = job_key(job_id_binary)
        if not key:
            return 0
        return self._lib.ss_evict_job(self._h, nbytes, key)

    @property
    def num_shards(self) -> int:
        if self._lib is None or self._h < 0:
            return 0
        return self._lib.ss_num_shards(self._h)

    def stats(self) -> dict:
        cap = ctypes.c_uint64()
        alloc = ctypes.c_uint64()
        n = ctypes.c_uint32()
        ref = ctypes.c_uint64()
        wait = ctypes.c_uint64()
        cont = ctypes.c_uint64()
        evd = ctypes.c_uint64()
        if self._lib is None or self._h < 0:
            lib = None
        else:
            lib = self._lib
            lib.ss_stats2(
                self._h, ctypes.byref(cap), ctypes.byref(alloc),
                ctypes.byref(n), ctypes.byref(ref), ctypes.byref(wait),
                ctypes.byref(cont), ctypes.byref(evd)
            )
        return {
            "capacity": cap.value,
            "allocated": alloc.value,
            "num_objects": n.value,
            # bytes a create CANNOT reclaim (unsealed or still
            # referenced); `allocated` additionally counts evictable
            # garbage — use `referenced` for backpressure
            "referenced": ref.value,
            # contention instrumentation, summed over index shards and
            # allocator regions (per-shard breakdown: shard_stats())
            "lock_wait_ns": wait.value,
            "lock_contended": cont.value,
            "evicted_objects": evd.value,
        }

    def metrics_text(self) -> str:
        """Prometheus exposition of store + per-shard contention stats,
        computed at scrape time (daemon `/metrics` extra_text — the
        flight-recorder view of the sharded shm plane)."""
        st = self.stats()
        lines = [
            "# TYPE object_store_lock_wait_ns_total counter",
            f"object_store_lock_wait_ns_total {st['lock_wait_ns']}",
            "# TYPE object_store_lock_contended_total counter",
            f"object_store_lock_contended_total {st['lock_contended']}",
            "# TYPE object_store_evicted_objects_total counter",
            f"object_store_evicted_objects_total {st['evicted_objects']}",
            "# TYPE object_store_referenced_bytes gauge",
            f"object_store_referenced_bytes {st['referenced']}",
            "# TYPE object_store_shards gauge",
            f"object_store_shards {self.num_shards}",
        ]
        job_rows = self.jobs()
        if job_rows:
            lines.append("# TYPE object_store_job_used_bytes gauge")
            for label, jst in sorted(job_rows.items()):
                lines.append(
                    f'object_store_job_used_bytes{{job="{label}"}} '
                    f"{jst['used']}")
                lines.append(
                    f'object_store_job_quota_bytes{{job="{label}"}} '
                    f"{jst['quota']}")
                lines.append(
                    f'object_store_job_evicted_bytes{{job="{label}"}} '
                    f"{jst['evicted_bytes']}")
                lines.append(
                    f'object_store_job_quota_rejects{{job="{label}"}} '
                    f"{jst['quota_rejects']}")
        shard_rows = self.shard_stats()
        if shard_rows:
            lines.append("# TYPE object_store_shard_lock_wait_ns gauge")
            for i, row in enumerate(shard_rows):
                lines.append(
                    f'object_store_shard_lock_wait_ns{{shard="{i}"}} '
                    f"{row['lock_wait_ns']}")
                lines.append(
                    f'object_store_shard_contended{{shard="{i}"}} '
                    f"{row['lock_contended']}")
                lines.append(
                    f'object_store_shard_evicted{{shard="{i}"}} '
                    f"{row['evicted_objects']}")
                lines.append(
                    f'object_store_shard_objects{{shard="{i}"}} '
                    f"{row['num_objects']}")
        return "\n".join(lines) + "\n"

    def shard_stats(self) -> list:
        """Per-shard contention/eviction rows (index stripe + its
        allocator region), for bench auditing and hot-shard triage."""
        out = []
        if self._lib is None or self._h < 0:
            return out
        row = (ctypes.c_uint64 * 8)()
        for shard in range(self._lib.ss_num_shards(self._h)):
            if self._lib.ss_shard_stats(self._h, shard, row) != SS_OK:
                break
            out.append({
                "lock_wait_ns": row[0],
                "lock_contended": row[1],
                "lock_acquisitions": row[2],
                "evicted_objects": row[3],
                "evicted_bytes": row[4],
                "num_objects": row[5],
                "region_allocated": row[6],
                "region_lock_wait_ns": row[7],
            })
        return out
