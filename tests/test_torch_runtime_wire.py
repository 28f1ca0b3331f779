"""The port's wire format and object store held to the JAX package's, with
no cluster: the same values give the same frame bytes, each package
reads the other's frames and sealed objects in one shared-memory
segment, and the ID layouts agree. Then the port's own part: torch
tensors round-trip through frames and the store with shape, dtype and
values, out of band.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu._private import ids as jax_ids  # noqa: E402
from ray_tpu._private import serialization as jax_ser  # noqa: E402
from ray_tpu._private.object_store import ObjectStore as JaxStore  # noqa: E402
from ray_tpu_torch._private import ids  # noqa: E402
from ray_tpu_torch._private import serialization as ser  # noqa: E402
from ray_tpu_torch._private.object_store import ObjectStore  # noqa: E402


def _values():
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((33, 17)).astype(np.float32),
              rng.standard_normal(1000).astype(np.float64),
              rng.integers(-2**31, 2**31 - 1, (5, 6, 7), dtype=np.int32),
              rng.integers(-2**62, 2**62, 123, dtype=np.int64),
              rng.integers(0, 255, 4096, dtype=np.uint8),
              rng.standard_normal((8, 8)).astype(np.float16)]
    nested = {"a": [arrays[0], (arrays[2], {"k": arrays[4]})],
              "b": {"x": 1, "y": 2.5, "z": None, "s": "text"}}
    return {
        **{f"array_{a.dtype}": a for a in arrays},
        "nested": nested,
        "bytes_small": rng.bytes(64),
        "bytes_large": rng.bytes(3 << 20),
        "array_large": rng.standard_normal(1 << 20).astype(np.float32),
        "scalar_int": 12345678901234,
        "list_mixed": [1, "two", 3.0, b"four", (5, 6)],
    }


VALUES = _values()


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("name", sorted(VALUES))
def test_frames_are_byte_identical_and_cross_readable(name):
    value = VALUES[name]
    port = ser.serialize_value(value).to_bytes()
    ref = jax_ser.serialize_value(value).to_bytes()
    assert port == ref
    assert _equal(ser.deserialize(memoryview(ref)), value)
    assert _equal(jax_ser.deserialize(memoryview(port)), value)
    assert ser.dumps(value) == jax_ser.dumps(value)


def test_id_layouts_agree():
    assert ids.ID_SIZE == jax_ids.ID_SIZE
    rng = np.random.default_rng(3)
    for cls in ("JobID", "NodeID", "WorkerID", "ActorID",
                "PlacementGroupID", "TaskID", "ObjectID"):
        pc, jc = getattr(ids, cls), getattr(jax_ids, cls)
        raw = rng.bytes(ids.ID_SIZE)
        assert pc(raw).hex() == jc(raw).hex()
        assert pc.from_hex(jc(raw).hex()).binary() == raw
        assert pc.nil().binary() == jc.nil().binary()
    job = ids.JobID.from_int(9)
    assert job.binary() == jax_ids.JobID.from_int(9).binary()
    task = ids.TaskID.for_driver(job)
    jtask = jax_ids.TaskID.for_driver(jax_ids.JobID.from_int(9))
    assert task.binary() == jtask.binary()
    child = ids.TaskID.of(job, task, 5)
    assert child.binary() == jax_ids.TaskID.of(
        jax_ids.JobID.from_int(9), jtask, 5).binary()
    assert (ids.ObjectID.for_task_return(child, 2).binary()
            == jax_ids.ObjectID.for_task_return(
                jax_ids.TaskID(child.binary()), 2).binary())
    assert (ids.ObjectID.for_put(task, 3).binary()
            == jax_ids.ObjectID.for_put(jtask, 3).binary())
    assert (ids.ActorID.of(job, task, 1).binary()
            == jax_ids.ActorID.of(jax_ids.JobID.from_int(9), jtask,
                                  1).binary())


@pytest.fixture
def shared_segment():
    """One shm segment, created by the port's store and attached by the
    JAX package's."""
    name = f"/ray_tpu_torch_test_{os.getpid()}_{os.urandom(4).hex()}"
    port = ObjectStore.create(name, capacity=64 << 20, table_size=1024)
    ref = JaxStore.attach(name)
    try:
        yield port, ref
    finally:
        ref.close()
        port.destroy()


def test_stores_read_each_others_sealed_objects(shared_segment):
    port, ref = shared_segment
    for i, (name, value) in enumerate(sorted(VALUES.items())):
        a = ids.ObjectID.from_random()
        port.put_value(a, value)
        assert _equal(ref.get(jax_ids.ObjectID(a.binary())), value), name
        b = jax_ids.ObjectID.from_random()
        ref.put_value(b, value)
        assert _equal(port.get(ids.ObjectID(b.binary())), value), name
    assert port.stats()["num_objects"] == 2 * len(VALUES)


TENSORS = {
    "bf16": lambda g: torch.randn(16, 24, generator=g).to(torch.bfloat16),
    "f16": lambda g: torch.randn(5, 7, 3, generator=g).to(torch.float16),
    "f32": lambda g: torch.randn(129, generator=g),
    "int64": lambda g: torch.randint(-2**40, 2**40, (6, 6), generator=g),
    "bf16_transposed": lambda g: torch.randn(
        12, 20, generator=g).to(torch.bfloat16).t(),
    "f32_strided": lambda g: torch.randn(10, 10, generator=g)[::3, 1::2],
    "f32_0d": lambda g: torch.tensor(3.25),
    "int64_0d": lambda g: torch.tensor(-7, dtype=torch.int64),
    "bf16_empty": lambda g: torch.empty(0, 4, dtype=torch.bfloat16),
    "f32_empty": lambda g: torch.empty(3, 0, 2),
}


def _same_tensor(got, want):
    return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
            and got.shape == want.shape and got.device.type == "cpu"
            and torch.equal(got, want))


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_tensor_round_trips(name, shared_segment):
    port, _ = shared_segment
    want = TENSORS[name](torch.Generator().manual_seed(11))
    value = {"t": want, "meta": [name, 1]}
    for got in (ser.loads(ser.dumps(value)),
                ser.deserialize(memoryview(
                    ser.serialize_value(value).to_bytes()))):
        assert _same_tensor(got["t"], want) and got["meta"] == [name, 1]
    oid = ids.ObjectID.from_random()
    port.put_value(oid, value)
    got = port.get(oid)
    assert _same_tensor(got["t"], want)


def test_parameter_and_requires_grad_round_trip():
    p = torch.nn.Parameter(torch.randn(3, 4))
    leaf = torch.randn(2, requires_grad=True)
    got_p, got_leaf = ser.loads(ser.dumps((p, leaf)))
    assert type(got_p) is torch.nn.Parameter and got_p.requires_grad
    assert torch.equal(got_p.detach(), p.detach())
    assert got_leaf.requires_grad and torch.equal(got_leaf.detach(),
                                                  leaf.detach())


def test_large_tensor_travels_out_of_band(shared_segment):
    port, _ = shared_segment
    t = torch.randn(16 << 20, generator=torch.Generator().manual_seed(0))
    assert t.nbytes == 64 << 20
    pickled, buffers = ser.serialize(t)
    assert len(buffers) == 1 and buffers[0].nbytes == t.nbytes
    assert len(pickled) < 1024
    oid = ids.ObjectID.from_random()
    big = ObjectStore.create(
        f"/ray_tpu_torch_test_{os.getpid()}_{os.urandom(4).hex()}",
        capacity=96 << 20, table_size=64)
    try:
        big.put_value(oid, t)
        got = big.get(oid)
        assert torch.equal(got, t)
        # a zero-copy view over the store's mapping, not a private copy
        base = np.frombuffer(big._view, np.uint8).ctypes.data
        assert base <= got.data_ptr() < base + big._view.nbytes
        del got
    finally:
        big.destroy()


def test_cuda_tensor_raises_where_no_gpu_is_visible():
    """A frame carrying a CUDA tensor never lands on the CPU silently."""
    raw = np.arange(4, dtype=np.float32).view(np.uint8)
    with pytest.raises(RuntimeError, match="sees no GPU"):
        ser._rebuild_tensor(raw.tobytes(), "float32", (4,), "cuda",
                            False, False)


def test_serializer_leaves_torch_unimported():
    import subprocess
    import sys
    code = ("import sys, numpy as np\n"
            "from ray_tpu_torch._private import serialization as s\n"
            "s.loads(s.dumps({'a': np.ones(3)}))\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# The paths the port deferred to later slices: `client://` drivers came
# with the operator slice, the compiled-DAG channels with S4e.

def test_client_drivers_are_deferred():
    """No longer deferred: `client://` routes to the port's
    `ClientContext`, which dials the client server; with none listening
    the connection is refused and no driver state is left behind
    (`tests/test_torch_client.py` drives a live one)."""
    import ray_tpu_torch

    with pytest.raises(OSError):
        ray_tpu_torch.init(address="client://127.0.0.1:1")
    assert not ray_tpu_torch.is_initialized()


def test_compiled_dag_channels_are_deferred():
    """No longer deferred: the stage executor is ported, and a stage
    whose channel does not exist fails at install (the compile call),
    before any method runs (`tests/test_torch_dag.py` drives it)."""
    from ray_tpu_torch._private.core_worker import CoreWorker

    stage = {"method": "f", "nargs": 1, "consts": [], "outs": [],
             "ins": [(0, "ray_tpu_torch_ch_0_missing_0")]}
    with pytest.raises(FileNotFoundError):
        CoreWorker._start_channel_graph(None, [stage])
