"""Object serialization: cloudpickle + pickle-5 out-of-band zero-copy buffers.

Mirrors the reference's split (`python/ray/_private/serialization.py`):
values are cloudpickled with protocol 5 and large contiguous buffers (numpy
arrays, arrow buffers, bytes) are captured out-of-band so that storing to the
shared-memory object store and reading back is zero-copy — on `get`, buffers
are reconstructed as memoryviews over the store's mmap, and numpy arrays are
views onto shared memory.

Wire layout of a stored object (64-byte aligned buffers):

    u32 magic | u32 n_buffers | u64 size[n] ... | pad | buf0 | pad | buf1 ...

buf0 is always the pickle stream; buf1.. are the out-of-band buffers.

The port's own copy of `ray_tpu/_private/serialization.py`, with the same
wire layout, so each package reads the other's frames. Torch tensors are
the port's arrays: once `torch` is in `sys.modules`, the pickler reduces
a plain tensor (or `nn.Parameter`) to its raw bytes, out of band like a
numpy array's, plus its dtype name, shape and device type (`_reduce_tensor`).
So every dtype travels, bf16 (which numpy lacks) included, and
non-contiguous, 0-d and empty tensors round-trip with shape, dtype and
values. A CUDA tensor is copied to the host at `put` and restored onto the
`cuda` device of the process that reads it; a process that sees no GPU
raises instead of placing it on the CPU. A CPU tensor from `get` is a
zero-copy view over the store's shared memory, as a numpy array from
`get` is: the object stays pinned while the tensor lives, and writing to
it would change the stored object for every reader, so a caller that
mutates it clones it first. Values without tensors pickle byte for byte
as in the JAX package, and nothing here imports torch.

A process that only relays values, the client server
(`util/client/server.py`), calls `relay_cuda_tensors()`: from then on a
CUDA tensor it reads stays on the host, tagged with its device, and
serializing it again restores the tag, so the relay needs no GPU and
the reader at the far end gets a CUDA tensor.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import sys
from typing import Any, Callable, List, Sequence

import cloudpickle

from ray_tpu_torch._private.object_ref import ObjectRef

MAGIC = 0x52415931  # "RAY1"
_ALIGN = 64

# set by `relay_cuda_tensors()`: CUDA tensors read in this process stay
# on the host, tagged with `_RELAY_ATTR`
_relay = False
_RELAY_ATTR = "_ray_tpu_torch_device"


def relay_cuda_tensors():
    """Keep the CUDA tensors this process reads on the host, each tagged
    so that serializing it again marks it `cuda` (see the module's
    docstring)."""
    global _relay
    _relay = True


# Registry of custom serializers, mirroring ray.util.register_serializer.
_custom_serializers: dict[type, tuple[Callable, Callable]] = {}


def register_serializer(cls: type, *, serializer: Callable, deserializer: Callable):
    _custom_serializers[cls] = (serializer, deserializer)


def deregister_serializer(cls: type):
    _custom_serializers.pop(cls, None)


class _Pickler(cloudpickle.CloudPickler):
    def __init__(self, file, buffers: List):
        super().__init__(
            file, protocol=5, buffer_callback=lambda b: buffers.append(b.raw())
        )
        # ObjectRefs pickled anywhere inside the value (nested in
        # containers included). The submit path uses them two ways: a
        # non-empty list keeps the spec out of multi-task actor batches
        # (resolving such a ref may need an earlier in-batch task's
        # withheld reply — deadlock), and the owner pins each one for
        # the task's lifetime so dropping the caller's handle cannot
        # free an object the task still needs.
        self.object_refs: List[ObjectRef] = []
        self.saw_object_ref = False

    def reducer_override(self, obj):
        if type(obj) is ObjectRef:
            self.saw_object_ref = True
            self.object_refs.append(obj)
        ser = _custom_serializers.get(type(obj))
        if ser is not None:
            serializer, deserializer = ser
            return (_reconstruct_custom, (type(obj), deserializer, serializer(obj)))
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in (torch.Tensor,
                                               torch.nn.Parameter):
            reduced = _reduce_tensor(torch, obj)
            if reduced is not None:
                return reduced
        return super().reducer_override(obj)


def _reconstruct_custom(cls, deserializer, payload):
    return deserializer(payload)


def _reduce_tensor(torch, t):
    """(rebuild, args) carrying a strided tensor's bytes out of band, or
    None for a tensor this layout cannot describe (sparse, quantized,
    meta), which then pickles through torch's own reduce."""
    if (t.layout != torch.strided or t.is_quantized or t.is_meta
            or t.device.type not in ("cpu", "cuda")):
        return None
    device_type = getattr(t, _RELAY_ATTR, None) or t.device.type
    data = t.detach()
    if data.device.type != "cpu":
        data = data.to("cpu")  # CUDA tensors travel through the host
    data = data.resolve_conj().resolve_neg().contiguous()
    raw = data.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(t.dtype).split(".", 1)[1],
             tuple(t.shape), device_type, t.requires_grad,
             type(t) is torch.nn.Parameter))


def _rebuild_tensor(buf, dtype_name, shape, device_type, requires_grad,
                    parameter):
    """Inverse of `_reduce_tensor`. A CPU tensor is a view over `buf`
    (the store's memory on `get`); an in-band frame's read-only bytes are
    copied first. A CUDA tensor lands on this process's `cuda` device,
    and raises where no GPU is visible; in a relay
    (`relay_cuda_tensors`) it stays on the host, tagged."""
    import torch

    dtype = getattr(torch, dtype_name)
    relayed = device_type == "cuda" and _relay
    if device_type == "cuda" and not relayed \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f"ray_tpu_torch: a CUDA tensor {list(shape)} {dtype_name} "
            f"cannot be restored in this process: it sees no GPU "
            f"(CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); read it in a "
            f"task or actor with num_gpus, or put a CPU tensor")
    view = memoryview(buf)
    if view.nbytes == 0:
        t = torch.empty(shape, dtype=dtype)
    else:
        if view.readonly:
            view = memoryview(bytearray(view))
        t = torch.frombuffer(view, dtype=dtype).reshape(shape)
    if device_type == "cuda" and not relayed:
        t = t.to("cuda")
    if parameter:
        t = torch.nn.Parameter(t, requires_grad=requires_grad)
    elif requires_grad:
        t = t.requires_grad_(requires_grad)
    if relayed:
        setattr(t, _RELAY_ATTR, "cuda")
    return t


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def serialize(value: Any) -> tuple[bytes, List[memoryview]]:
    """Serialize to (pickle_bytes, out_of_band_buffers)."""
    buffers: List[memoryview] = []
    f = io.BytesIO()
    _Pickler(f, buffers).dump(value)
    return f.getvalue(), buffers


class SerializedValue:
    """A pickled value held without any copy of its payload.

    `pickled` is a zero-copy view over the pickler's internal buffer
    (io.BytesIO.getbuffer() — the view keeps the BytesIO alive) and
    `buffers` are pickle-5 out-of-band views over the original arrays,
    so after `serialize_value` NOTHING large has been copied yet. The
    one-copy put protocol (reference: plasma client create→write→seal,
    `src/ray/object_manager/plasma/client.cc`) is then:

        sv = serialize_value(value)
        buf = store.create_buffer(oid, sv.size)   # writer-private shm
        sv.write_into(buf)                        # the ONE payload copy
        store.seal(oid)

    `to_bytes()` materializes the framed object for the in-band path.
    """

    __slots__ = ("pickled", "buffers", "size")

    def __init__(self, pickled: memoryview, buffers: List[memoryview]):
        self.pickled = pickled
        # normalize to flat byte views once, so sizing and writing agree
        self.buffers = [
            b if b.ndim == 1 and b.format == "B" else b.cast("B")
            for b in buffers
        ]
        self.size = serialized_size(pickled, self.buffers)

    def write_into(self, dst: memoryview) -> int:
        """Write the framed object in place; returns bytes written."""
        return write_to(dst, self.pickled, self.buffers)

    def to_bytes(self) -> bytes:
        out = bytearray(self.size)
        write_to(memoryview(out), self.pickled, self.buffers)
        return bytes(out)


def serialize_value(value: Any) -> SerializedValue:
    """Pickle `value` capturing out-of-band buffers, copying nothing
    large: the pickle stream stays a view of the pickler's buffer and
    the oob buffers stay views of the caller's arrays."""
    return serialize_value_with_refs(value)[0]


def serialize_value_with_refs(
        value: Any) -> tuple[SerializedValue, List[ObjectRef]]:
    """`serialize_value` plus every ObjectRef pickled anywhere inside
    `value` — the executor's return path must know them to hand the
    borrows off to the caller before its own handles die."""
    buffers: List[memoryview] = []
    f = io.BytesIO()
    p = _Pickler(f, buffers)
    p.dump(value)
    return SerializedValue(f.getbuffer(), buffers), p.object_refs


def serialize_into(dst: memoryview, value: Any) -> int:
    """Serialize `value` writing the frame directly into `dst` (a
    pre-created shm view). Returns bytes written; raises ValueError when
    the frame does not fit. Callers that need exact sizing should use
    `serialize_value` + `create_buffer(sv.size)` + `sv.write_into`."""
    sv = serialize_value(value)
    if sv.size > dst.nbytes:
        raise ValueError(
            f"serialized frame ({sv.size} B) exceeds destination "
            f"({dst.nbytes} B)")
    return sv.write_into(dst)


def dumps_with_ref_flag(value: Any) -> tuple[bytes, list]:
    """Like `dumps`, additionally returning every ObjectRef pickled
    anywhere inside `value` (nested in containers included) — truthy
    exactly when the old boolean flag was."""
    buffers: List[memoryview] = []
    f = io.BytesIO()
    p = _Pickler(f, buffers)
    p.dump(value)
    return pack(f.getvalue(), buffers), p.object_refs


def serialized_size(pickled: bytes, buffers: Sequence[memoryview]) -> int:
    n = 1 + len(buffers)
    header = 8 + 8 * n
    total = _align(header)
    total += _align(len(pickled))
    for b in buffers:
        total += _align(b.nbytes)
    return total


_native_copy_lib = None
_MT_COPY_MIN = 8 << 20  # below this a plain memcpy wins (thread spawn cost)


def _fast_copy(dst: memoryview, src: memoryview) -> None:
    """Copy a large contiguous buffer with the native multi-threaded
    memcopy (reference: the plasma client's memcopy_threads,
    `src/ray/object_manager/plasma/client.cc`) — one memcpy thread
    cannot saturate multi-channel DRAM, and big puts are exactly the
    copy-bound path. Small copies and missing-lib fall back to the
    plain buffer assignment."""
    global _native_copy_lib
    if dst.nbytes != src.nbytes:
        # the raw-pointer native path has no bounds — keep the loud
        # ValueError the plain buffer assignment used to raise
        raise ValueError(
            f"copy size mismatch: dst {dst.nbytes} != src {src.nbytes}")
    if src.nbytes < _MT_COPY_MIN:
        dst[:] = src
        return
    if _native_copy_lib is None:
        try:
            from ray_tpu_torch.native import load_shm_store

            _native_copy_lib = load_shm_store()
        except Exception:  # noqa: BLE001 — fallback is correct, just slower
            _native_copy_lib = False
    if _native_copy_lib is False:
        dst[:] = src
        return
    import os as os_mod

    import numpy as np

    threads = int(os_mod.environ.get("RAY_TPU_MEMCPY_THREADS", "0"))
    d = np.frombuffer(dst, np.uint8)
    s = np.frombuffer(src, np.uint8)
    _native_copy_lib.ss_memcpy_mt(d.ctypes.data, s.ctypes.data,
                                  src.nbytes, threads)


def write_to(dst: memoryview, pickled: bytes, buffers: Sequence[memoryview]) -> int:
    """Write the framed object into a writable buffer; returns bytes written."""
    n = 1 + len(buffers)
    struct.pack_into("<II", dst, 0, MAGIC, n)
    sizes = [len(pickled)] + [b.nbytes for b in buffers]
    struct.pack_into(f"<{n}Q", dst, 8, *sizes)
    off = _align(8 + 8 * n)
    dst[off : off + len(pickled)] = pickled
    off += _align(len(pickled))
    for b in buffers:
        flat = b.cast("B") if b.ndim != 1 or b.format != "B" else b
        _fast_copy(dst[off : off + flat.nbytes], flat)
        off += _align(flat.nbytes)
    return off


def pack(pickled: bytes, buffers: Sequence[memoryview]) -> bytes:
    out = bytearray(serialized_size(pickled, buffers))
    write_to(memoryview(out), pickled, buffers)
    return bytes(out)


def deserialize(src: memoryview) -> Any:
    """Reconstruct a value from a framed buffer (zero-copy for oob buffers)."""
    magic, n = struct.unpack_from("<II", src, 0)
    if magic != MAGIC:
        raise ValueError("corrupt object: bad magic")
    sizes = struct.unpack_from(f"<{n}Q", src, 8)
    off = _align(8 + 8 * n)
    views: List[memoryview] = []
    for size in sizes:
        views.append(src[off : off + size])
        off += _align(size)
    return pickle.loads(views[0], buffers=views[1:])


def dumps(value: Any) -> bytes:
    """One-shot serialize to a self-contained frame (for RPC inlining)."""
    return pack(*serialize(value))


def loads(data: bytes | memoryview) -> Any:
    return deserialize(memoryview(data))
