"""Native (C++) components and their ctypes bindings.

The port's own copy of `ray_tpu/native/__init__.py`: the shared-memory
object store (`shm_store.cc`, a copy of the JAX package's source, so the
two packages' stores share one layout) is compiled with `g++` from this
directory at first use into `build/` (listed in `.gitignore`). The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. The GCS,
the raylet, every worker and the driver may reach the first build at
once: the build runs under an exclusive file lock (`build/.lock`), into
a temporary name, and is renamed into place, so a process loads either
nothing or a whole library. The serve dispatch ring (`request_ring.cc`,
a copy of the JAX package's source) is built the same way by
`load_request_ring`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
CXXFLAGS = ("-O2", "-g", "-Wall", "-Wextra", "-std=c++17", "-fPIC",
            "-shared")
LDLIBS = ("-lpthread", "-lrt")
_build_lock = threading.Lock()


def library_path(name: str) -> str:
    """`build/lib<name>-<hash>.so`: the hash covers `<name>.cc` and the
    compiler flags."""
    digest = hashlib.sha1()
    with open(os.path.join(_DIR, f"{name}.cc"), "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile `<name>.cc` unless its library exists; returns the path.
    Safe across processes (file lock, temporary name, atomic rename) and
    threads (`_build_lock`)."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    with _build_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            # one-time per checkout: every daemon loads the library during
            # startup, steady state never reaches this
            # raylint: disable=blocking-under-lock
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(out):  # another process built it meanwhile
                return out
            tmp = f"{out}.tmp{os.getpid()}"
            cxx = os.environ.get("CXX", "g++")
            proc = subprocess.run(  # raylint: disable=async-blocking
                [cxx, *CXXFLAGS, "-o", tmp,
                 os.path.join(_DIR, f"{name}.cc"), *LDLIBS],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build of {name}.cc failed "
                    f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def load_shm_store() -> ctypes.CDLL:
    """Load (building on demand) the native shared-memory store library."""
    lib = ctypes.CDLL(build("shm_store"))
    lib.ss_create_store.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_uint32,  # num_shards (0 = scale with capacity)
    ]
    lib.ss_create_store.restype = ctypes.c_int
    lib.ss_attach.argtypes = [ctypes.c_char_p]
    lib.ss_attach.restype = ctypes.c_int
    lib.ss_create.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64]
    lib.ss_create.restype = ctypes.c_int64
    lib.ss_create_job.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,  # job key (0 = untracked)
    ]
    lib.ss_create_job.restype = ctypes.c_int64
    lib.ss_set_job_quota.argtypes = [
        ctypes.c_int,
        ctypes.c_uint64,  # job key
        ctypes.c_uint64,  # byte quota (0 = unlimited)
    ]
    lib.ss_set_job_quota.restype = ctypes.c_int
    lib.ss_job_stats.argtypes = [
        ctypes.c_int,
        ctypes.c_uint64,  # job key
        ctypes.POINTER(ctypes.c_uint64),  # 5-element row
    ]
    lib.ss_job_stats.restype = ctypes.c_int
    lib.ss_job_list.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.ss_job_list.restype = ctypes.c_int
    lib.ss_evict_job.argtypes = [
        ctypes.c_int,
        ctypes.c_uint64,  # nbytes
        ctypes.c_uint64,  # job key
    ]
    lib.ss_evict_job.restype = ctypes.c_uint64
    lib.ss_seal.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.ss_seal.restype = ctypes.c_int
    lib.ss_get.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_double,
    ]
    lib.ss_get.restype = ctypes.c_int64
    lib.ss_contains.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.ss_contains.restype = ctypes.c_int
    lib.ss_release.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.ss_release.restype = ctypes.c_int
    lib.ss_delete.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.ss_delete.restype = ctypes.c_int
    lib.ss_evict.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.ss_evict.restype = ctypes.c_uint64
    lib.ss_stats.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ss_stats.restype = None
    lib.ss_data_offset.argtypes = [ctypes.c_int]
    lib.ss_data_offset.restype = ctypes.c_uint64
    lib.ss_map_size.argtypes = [ctypes.c_int]
    lib.ss_map_size.restype = ctypes.c_uint64
    lib.ss_detach.argtypes = [ctypes.c_int]
    lib.ss_detach.restype = ctypes.c_int
    lib.ss_unlink_store.argtypes = [ctypes.c_char_p]
    lib.ss_unlink_store.restype = ctypes.c_int
    lib.ss_stats2.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),  # capacity
        ctypes.POINTER(ctypes.c_uint64),  # allocated
        ctypes.POINTER(ctypes.c_uint32),  # num_objects
        ctypes.POINTER(ctypes.c_uint64),  # referenced
        ctypes.POINTER(ctypes.c_uint64),  # lock_wait_ns
        ctypes.POINTER(ctypes.c_uint64),  # lock_contended
        ctypes.POINTER(ctypes.c_uint64),  # evicted_objects
    ]
    lib.ss_stats2.restype = None
    lib.ss_num_shards.argtypes = [ctypes.c_int]
    lib.ss_num_shards.restype = ctypes.c_uint32
    lib.ss_shard_stats.argtypes = [
        ctypes.c_int,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64),  # 8-element row
    ]
    lib.ss_shard_stats.restype = ctypes.c_int
    lib.ss_set_primary.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,  # flag (0 clears)
    ]
    lib.ss_set_primary.restype = ctypes.c_int
    lib.ss_is_primary.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.ss_is_primary.restype = ctypes.c_int
    lib.ss_refcount.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.ss_refcount.restype = ctypes.c_int64
    lib.ss_list_sealed.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),  # ids_out (cap * 16 bytes)
        ctypes.POINTER(ctypes.c_uint8),  # flags_out (cap bytes)
        ctypes.c_int,
    ]
    lib.ss_list_sealed.restype = ctypes.c_int
    lib.ss_memcpy_mt.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.ss_memcpy_mt.restype = None
    return lib


def load_request_ring() -> ctypes.CDLL:
    """Load (building on demand) the native dispatch-ring library
    (request_ring.cc — the zero-Python serve dispatch plane)."""
    lib = ctypes.CDLL(build("request_ring"))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rr_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint32,  # table_cap (== sub-ring count)
        ctypes.c_uint32,  # slots per sub-ring (rounded to pow2)
        ctypes.c_uint32,  # payload bytes per slot
    ]
    lib.rr_open.restype = ctypes.c_int
    lib.rr_detach.argtypes = [ctypes.c_int]
    lib.rr_detach.restype = ctypes.c_int
    lib.rr_unlink.argtypes = [ctypes.c_char_p]
    lib.rr_unlink.restype = ctypes.c_int
    for name in ("rr_table_cap", "rr_slots", "rr_slot_bytes", "rr_mode"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_uint32
    lib.rr_set_mode.argtypes = [ctypes.c_int, ctypes.c_uint32]
    lib.rr_set_mode.restype = ctypes.c_int
    lib.rr_snapshot_version.argtypes = [ctypes.c_int]
    lib.rr_snapshot_version.restype = ctypes.c_uint64
    lib.rr_publish.argtypes = [
        ctypes.c_int,
        ctypes.c_uint64,  # replica-set version
        u64p,             # replica ids
        ctypes.c_uint32,
    ]
    lib.rr_publish.restype = ctypes.c_int
    lib.rr_mark_dead.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.rr_mark_dead.restype = ctypes.c_int
    lib.rr_done.argtypes = [
        ctypes.c_int,
        ctypes.c_uint64,  # replica id
        ctypes.c_uint32,  # generation the inflight++ hit (ABA guard)
    ]
    lib.rr_done.restype = ctypes.c_int
    lib.rr_enqueue.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_uint32,  # payload len
        ctypes.c_uint64,  # deadline (CLOCK_MONOTONIC ns, 0 = none)
        ctypes.c_uint64,  # client cookie (response-ring routing)
        ctypes.c_uint32,  # tag
        u64p,             # out: trace id
        u64p,             # out: chosen replica id
        ctypes.POINTER(ctypes.c_uint32),  # out: generation
    ]
    lib.rr_enqueue.restype = ctypes.c_int64
    lib.rr_enqueue_to.argtypes = [
        ctypes.c_int,
        ctypes.c_uint32,  # sub-ring index
        ctypes.c_char_p,
        ctypes.c_uint32,  # payload len
        ctypes.c_uint64,  # trace (caller-supplied: response correlation)
        ctypes.c_uint64,  # client cookie
        ctypes.c_uint32,  # tag
    ]
    lib.rr_enqueue_to.restype = ctypes.c_int64
    lib.rr_ring_of.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.rr_ring_of.restype = ctypes.c_int
    lib.rr_drain.argtypes = [
        ctypes.c_int,
        ctypes.c_uint32,  # sub-ring index
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,  # out buffer capacity
        ctypes.c_uint32,  # max frames
        u64p,             # out: bytes written
    ]
    lib.rr_drain.restype = ctypes.c_int64
    lib.rr_pending.argtypes = [ctypes.c_int, ctypes.c_uint32]
    lib.rr_pending.restype = ctypes.c_int64
    lib.rr_stats.argtypes = [ctypes.c_int, u64p]
    lib.rr_stats.restype = None
    lib.rr_snapshot.argtypes = [
        ctypes.c_int,
        u64p,             # out rows ({id, gen, inflight, alive, ring} x5)
        ctypes.c_uint32,  # row capacity
        u64p,             # out: published version
    ]
    lib.rr_snapshot.restype = ctypes.c_int
    return lib
