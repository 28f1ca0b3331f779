"""The compiled DAG and its channels, against the JAX package.

- The channel scenarios of `tests/test_channel_frames.py` on the port's
  `ray_tpu_torch.experimental.channel`, plus its own two differences:
  segment names (`ray_tpu_torch_ch_...`) and torch tensors in frames. A
  frame without a tensor is byte for byte the JAX package's.
- The compiled actor graphs of `tests/test_jobs_workflow_dag.py` (chain,
  diamond, multi-output, pipeline, timeout without desync) on the port's
  runtime, then one script of them against both packages in
  subprocesses, JSON compared.
- `torch_stage` chains fused into one `compiled_step`: a tiny GPT chain
  against the same chain of `jax_stage`s on the JAX tiny GPT (weights
  carried by `gpt_params_from_jax`), f32, within 1e-5.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import dag as dag_mod  # noqa: E402
from ray_tpu_torch.experimental.channel import (  # noqa: E402
    SEGMENT_PREFIX,
    TAG_ERR,
    TAG_OK,
    ChannelClosedError,
    FrameScratch,
    ShmChannel,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


# -- channels: the scenarios of tests/test_channel_frames.py ------------------

@pytest.fixture
def chan():
    ch = ShmChannel.create(ShmChannel.make_name(0), 1 << 16)
    yield ch
    ch.destroy()
    ch.close()


def test_frame_roundtrip_and_zero_copy_view(chan):
    scratch = FrameScratch()
    value = {"x": list(range(50)), "tag": "hello"}
    chan.write_frame(TAG_OK, 7, scratch.pack(value))
    tag, seq, view = chan.read_frame(timeout=5)
    assert (tag, seq) == (TAG_OK, 7)
    assert isinstance(view, memoryview)  # aliases the shm segment
    assert pickle.loads(view) == value
    del view
    chan.release_frame()


def test_stale_frames_skipped_without_deserializing(chan):
    class Bomb:
        """Deserializing this object is the bug being tested for."""
        def __reduce__(self):
            return (_explode, ())

    chan.write_frame(TAG_OK, 1, pickle.dumps(Bomb()))
    tag, seq, _view = chan.read_frame(timeout=5)
    assert seq == 1
    _view = None
    chan.release_frame()  # stale: dropped from the header alone
    chan.write_frame(TAG_OK, 2, pickle.dumps("fresh"))
    tag, seq, view = chan.read_frame(timeout=5)
    assert (tag, seq) == (TAG_OK, 2)
    assert pickle.loads(view) == "fresh"
    del view
    chan.release_frame()


def _explode():
    raise AssertionError("stale frame payload was deserialized")


def test_frame_scratch_reuses_buffer():
    scratch = FrameScratch(initial=16)
    v1 = scratch.pack(b"a" * 100)     # grows
    buf_id = id(scratch._buf)
    assert pickle.loads(v1) == b"a" * 100
    v2 = scratch.pack(b"b" * 80)      # reuse, no regrow
    assert id(scratch._buf) == buf_id
    assert pickle.loads(v2) == b"b" * 80


def test_oversize_frame_raises(chan):
    with pytest.raises(ValueError, match="exceeds channel capacity"):
        chan.write_frame(TAG_OK, 1, b"x" * (1 << 17))


def test_err_tag_travels(chan):
    chan.write_frame(TAG_ERR, 3, pickle.dumps("boom"))
    tag, seq, view = chan.read_frame(timeout=5)
    assert tag == TAG_ERR and pickle.loads(view) == "boom"
    del view
    chan.release_frame()


def test_depth_one_backpressure_and_fifo_wakeup(chan):
    chan.write_frame(TAG_OK, 1, b"first")
    # slot occupied: a second write must time out quickly
    with pytest.raises(TimeoutError):
        chan.write_frame(TAG_OK, 2, b"second", timeout=0.05)

    # a blocked writer wakes as soon as the reader releases
    done = []

    def release_later():
        time.sleep(0.1)
        chan.read_frame(timeout=5)
        chan.release_frame()
        done.append(True)

    t = threading.Thread(target=release_later)
    t.start()
    start = time.monotonic()
    chan.write_frame(TAG_OK, 2, b"second", timeout=5)
    assert time.monotonic() - start < 2.0
    t.join()
    assert done


def test_shutdown_wakes_blocked_reader(chan):
    errs = []

    def reader():
        try:
            chan.read_frame(timeout=30)
        except ChannelClosedError:
            errs.append("closed")

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.1)
    start = time.monotonic()
    chan.signal_shutdown()
    t.join(timeout=5)
    assert not t.is_alive()
    # the FIFO token (or the bounded select slice) delivers the flag
    # promptly — not after a long poll cap
    assert time.monotonic() - start < 2.0
    assert errs == ["closed"]


def test_cross_process_roundtrip_latency(chan):
    """Echo child: parent->child->parent round trips must be far below
    the old ~1 ms/hop polling regime (FIFO wakeups are kernel-directed;
    generous bound for busy CI boxes)."""
    back = ShmChannel.create(ShmChannel.make_name(1), 1 << 16)
    n = 300
    pid = os.fork()
    if pid == 0:  # child: echo loop
        try:
            for _ in range(n):
                tag, seq, view = chan.read_frame(timeout=30)
                payload = bytes(view)
                del view
                chan.release_frame()
                back.write_frame(tag, seq, payload, timeout=30)
        finally:
            os._exit(0)
    try:
        payload = b"z" * 128
        for i in range(50):  # warm
            chan.write_frame(TAG_OK, i, payload, timeout=30)
            back.read_frame(timeout=30)
            back.release_frame()
        t0 = time.perf_counter()
        for i in range(50, n):
            chan.write_frame(TAG_OK, i, payload, timeout=30)
            back.read_frame(timeout=30)
            back.release_frame()
        rtt = (time.perf_counter() - t0) / (n - 50)
        os.waitpid(pid, 0)
        assert rtt < 0.002, f"round trip {rtt * 1e6:.0f} µs"
    finally:
        back.destroy()
        back.close()


def test_fifo_fallback_polling_still_works(chan, monkeypatch):
    """A channel without FIFO fds degrades to the spin/sleep fallback
    and stays correct."""
    for fd in (chan._rdy_fd, chan._fre_fd):
        if fd is not None:
            os.close(fd)
    chan._rdy_fd = chan._fre_fd = None
    chan.write_frame(TAG_OK, 9, b"polled")
    tag, seq, view = chan.read_frame(timeout=5)
    assert (tag, seq, bytes(view)) == (TAG_OK, 9, b"polled")
    del view
    chan.release_frame()


# -- compiled actor graphs: the scenarios of tests/test_jobs_workflow_dag.py --

def test_compiled_actor_chain_channels():
    """VERDICT r4 item 7: a compiled linear actor chain executes over
    pre-allocated shm channels — no per-call task submission — and must
    beat the .remote() loop by a wide margin. Errors propagate; teardown
    unlinks the channels and the actors stay usable."""
    import time as time_mod

    from ray_tpu_torch import dag as dag_mod

    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, add):
            self.add = add

        def f(self, x):
            if x == "boom":
                raise ValueError("stage exploded")
            return x + self.add

    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    ray_tpu_torch.get([a.f.remote(0), b.f.remote(0), c.f.remote(0)],
                timeout=60)

    node = dag_mod.bind(
        c.f, dag_mod.bind(b.f, dag_mod.bind(a.f, dag_mod.InputNode())))
    compiled = node.experimental_compile()
    assert compiled._channels is not None, "actor chain not lowered"
    assert compiled.execute(5) == 116
    assert compiled.execute(0) == 111

    # latency: compiled channel path >> submit-per-call loop
    n, start = 0, time_mod.perf_counter()
    while time_mod.perf_counter() - start < 2.0:
        compiled.execute(n)
        n += 1
    compiled_rate = n / (time_mod.perf_counter() - start)
    n, start = 0, time_mod.perf_counter()
    while time_mod.perf_counter() - start < 2.0:
        ray_tpu_torch.get(c.f.remote(ray_tpu_torch.get(
            b.f.remote(ray_tpu_torch.get(a.f.remote(n))))), timeout=60)
        n += 1
    remote_rate = n / (time_mod.perf_counter() - start)
    assert compiled_rate > 3 * remote_rate, (compiled_rate, remote_rate)

    # stage errors surface at execute() with the original cause
    with pytest.raises(ray_tpu_torch.RayTaskError, match="stage exploded"):
        compiled.execute("boom")
    # the pipeline survives an error
    assert compiled.execute(7) == 118

    compiled.teardown()
    # actors remain plain callable actors after teardown
    assert ray_tpu_torch.get(a.f.remote(1), timeout=60) == 2


def test_compiled_diamond_graph():
    """VERDICT r5 item 3: a diamond A->(B,C)->D actor graph compiles
    onto channels — fan-out writes a channel per consumer, the fan-in
    combine reads one channel per argument — and beats the .remote()
    equivalent. Constants pass through descriptors, and the shared
    source executes once per call."""
    import time as time_mod

    from ray_tpu_torch import dag as dag_mod

    @ray_tpu_torch.remote
    class Node:
        def __init__(self):
            self.calls = 0

        def double(self, x):
            self.calls += 1
            return x * 2

        def inc(self, x):
            return x + 1

        def combine(self, a, b, c):
            return (a, b, c)

        def n_calls(self):
            return self.calls

    a, b, c, d = [Node.remote() for _ in range(4)]
    ray_tpu_torch.get([w.inc.remote(0) for w in (a, b, c, d)], timeout=60)

    src = dag_mod.bind(a.double, dag_mod.InputNode())
    left = dag_mod.bind(b.inc, src)
    right = dag_mod.bind(c.double, src)
    out = dag_mod.bind(d.combine, left, right, 99)
    compiled = out.experimental_compile()
    assert compiled._channels is not None, "diamond not lowered"
    assert compiled.execute(3) == (7, 12, 99)
    assert compiled.execute(0) == (1, 0, 99)
    # the shared source ran once per execute, not once per consumer
    assert ray_tpu_torch.get(a.n_calls.remote(), timeout=60) == 2

    n, start = 0, time_mod.perf_counter()
    while time_mod.perf_counter() - start < 2.0:
        compiled.execute(n)
        n += 1
    compiled_rate = n / (time_mod.perf_counter() - start)
    n, start = 0, time_mod.perf_counter()
    while time_mod.perf_counter() - start < 2.0:
        s = a.double.remote(n)
        ray_tpu_torch.get(d.combine.remote(
            b.inc.remote(s), c.double.remote(s), 99), timeout=60)
        n += 1
    remote_rate = n / (time_mod.perf_counter() - start)
    assert compiled_rate > 3 * remote_rate, (compiled_rate, remote_rate)
    compiled.teardown()


def test_compiled_multi_output_and_multi_input():
    """MultiOutputNode returns every leaf; InputNode(i) binds distinct
    execute() arguments to different stages (fan-in from the driver)."""
    from ray_tpu_torch import dag as dag_mod

    @ray_tpu_torch.remote
    class Calc:
        def add(self, a, b):
            return a + b

        def mul(self, a, b):
            return a * b

    x, y = Calc.remote(), Calc.remote()
    ray_tpu_torch.get([x.add.remote(0, 0), y.add.remote(0, 0)], timeout=60)

    added = dag_mod.bind(x.add, dag_mod.InputNode(0), dag_mod.InputNode(1))
    scaled = dag_mod.bind(y.mul, added, 10)
    both = dag_mod.MultiOutputNode([added, scaled])
    compiled = both.experimental_compile()
    assert compiled._channels is not None
    assert compiled.execute(3, 4) == [7, 70]
    assert compiled.execute(1, 1) == [2, 20]
    compiled.teardown()


def test_compiled_pipeline_parallel_actors():
    """A 2-stage pipeline-parallel actor graph on channels (the aDAG
    flagship use): each stage actor owns a layer's weights; the chain
    computes tanh(tanh(x @ W1) @ W2) and matches the local reference."""
    import numpy as np

    from ray_tpu_torch import dag as dag_mod

    @ray_tpu_torch.remote
    class Layer:
        def __init__(self, seed):
            rng = np.random.RandomState(seed)
            self.w = rng.randn(8, 8).astype(np.float32) * 0.3

        def forward(self, x):
            return np.tanh(x @ self.w)

        def weights(self):
            return self.w

    s1, s2 = Layer.remote(0), Layer.remote(1)
    w1, w2 = ray_tpu_torch.get([s1.weights.remote(), s2.weights.remote()],
                         timeout=60)

    graph = dag_mod.bind(
        s2.forward, dag_mod.bind(s1.forward, dag_mod.InputNode()))
    compiled = graph.experimental_compile()
    assert compiled._channels is not None
    rng = np.random.RandomState(2)
    for _ in range(3):
        x = rng.randn(4, 8).astype(np.float32)
        np.testing.assert_allclose(
            compiled.execute(x), np.tanh(np.tanh(x @ w1) @ w2),
            rtol=1e-6)
    compiled.teardown()


def test_compiled_timeout_does_not_desync():
    """ADVICE r4: a timed-out execute() must not leave the ring
    desynchronized — the seq tag makes the next call discard the stale
    frame instead of returning the previous result."""
    import time as time_mod

    from ray_tpu_torch import dag as dag_mod

    @ray_tpu_torch.remote
    class Slow:
        def f(self, x):
            delay, v = x
            if delay:
                time_mod.sleep(delay)
            return ("out", v)

    s = Slow.remote()
    ray_tpu_torch.get(s.f.remote((0, 0)), timeout=60)
    compiled = dag_mod.bind(
        s.f, dag_mod.InputNode()).experimental_compile()
    assert compiled.execute((0, "A")) == ("out", "A")
    with pytest.raises(TimeoutError):
        compiled.execute((2.0, "SLOW"), timeout=0.3)
    # the stale ("out", "SLOW") frame must be discarded, not returned
    assert compiled.execute((0, "B"), timeout=30) == ("out", "B")
    compiled.teardown()


# -- the port's own channel rules ----------------------------------------------

def _explode_if_loaded():
    raise AssertionError("unreachable")


@pytest.mark.parametrize("value", [
    None, 7, "hello", b"\x00\x01", [1, 2.5, "x"], ("out", "B"),
    {"x": list(range(50)), "tag": "hello"},
    np.arange(12, dtype=np.float32).reshape(3, 4),
    {"ids": np.array([3, 1, 2], np.int64), "err": ValueError("boom")},
])
def test_tensor_free_frame_is_the_jax_frame(value):
    """A value without a tensor packs to the JAX package's frame bytes,
    so either package reads the other's frames."""
    from ray_tpu.experimental.channel import FrameScratch as JaxScratch

    got = bytes(FrameScratch().pack(value))
    assert got == bytes(JaxScratch().pack(value))
    assert got == pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)


def test_segment_names_are_the_ports_own():
    """The port's segments and FIFOs are `ray_tpu_torch_ch_...`, the JAX
    package's `rtpu_ch_...`: one of each on one host never meet."""
    from ray_tpu.experimental.channel import ShmChannel as JaxChannel

    name = ShmChannel.make_name(0)
    jname = JaxChannel.make_name(0)
    assert name.startswith(SEGMENT_PREFIX + f"{os.getpid()}_")
    assert jname.startswith(f"rtpu_ch_{os.getpid()}_")
    ch = ShmChannel.create(name, 1 << 12)
    jch = JaxChannel.create(jname, 1 << 12)
    try:
        assert sorted(p for p in os.listdir("/dev/shm")
                      if p.startswith(name)) == [name, name + ".fre",
                                                 name + ".rdy"]
        ch.write_frame(TAG_OK, 1, FrameScratch().pack("port"))
        jch.write_frame(TAG_OK, 1, FrameScratch().pack("jax"))
        for c, want in ((ch, "port"), (jch, "jax")):
            tag, seq, view = c.read_frame(timeout=5)
            assert pickle.loads(view) == want
            del view
            c.release_frame()
    finally:
        for c in (ch, jch):
            c.destroy()
            c.close()
    assert not [p for p in os.listdir("/dev/shm") if p.startswith(name)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.bool])
def test_tensor_frames_roundtrip(chan, dtype):
    """Tensors travel by the runtime's wire rules, in band: any dtype
    (bf16 included), non-contiguous views and parameters keep their
    shape, dtype, values and kind."""
    g = torch.Generator().manual_seed(0)
    base = (torch.randn(4, 6, generator=g) * 10).to(dtype)
    value = {"t": base, "view": base.t(), "empty": base[:0],
             "param": torch.nn.Parameter(base.float()), "n": 3}
    chan.write_frame(TAG_OK, 1, FrameScratch().pack(value))
    tag, seq, view = chan.read_frame(timeout=5)
    got = pickle.loads(view)
    del view
    chan.release_frame()
    assert got["n"] == 3
    for key in ("t", "view", "empty"):
        assert got[key].dtype == dtype and got[key].shape == value[key].shape
        assert torch.equal(got[key], value[key])
    assert isinstance(got["param"], torch.nn.Parameter)
    assert torch.equal(got["param"], value["param"])
    # the reader owns its tensor: the slot's next frame does not change it
    chan.write_frame(TAG_OK, 2, FrameScratch().pack({"t": base * 0}))
    chan.read_frame(timeout=5)
    chan.release_frame()
    assert torch.equal(got["t"], base)


def test_large_tensor_frame_roundtrip():
    """A tensor over pickle's frame size reaches the scratch as the
    `PickleBuffer` itself, not as bytes, and still packs and reads
    back."""
    big = torch.arange(1 << 18, dtype=torch.float32).reshape(512, 512)
    view = FrameScratch().pack({"big": big.to(torch.bfloat16), "n": 1})
    assert view.nbytes > big.numel() * 2
    ch = ShmChannel.create(ShmChannel.make_name(0), 1 << 20)
    try:
        ch.write_frame(TAG_OK, 1, view)
        tag, seq, got_view = ch.read_frame(timeout=5)
        got = pickle.loads(got_view)
        del got_view
        ch.release_frame()
    finally:
        ch.destroy()
        ch.close()
    assert got["n"] == 1 and torch.equal(got["big"], big.to(torch.bfloat16))


def test_large_buffer_frames_against_the_jax_package():
    """F9: a value holding a buffer over pickle's frame size (a numpy
    array of 1 MiB) reaches the scratch's `write` as a `PickleBuffer`.
    The JAX package's `FrameScratch` takes its `len()` and raises, so
    its compiled graphs cannot carry such a value; the port's packs the
    bytes `pickle.dumps` gives."""
    from ray_tpu.experimental.channel import FrameScratch as JaxScratch

    value = {"a": np.arange(1 << 18, dtype=np.float32), "k": 3}
    with pytest.raises(TypeError, match="PickleBuffer"):
        JaxScratch().pack(value)
    got = bytes(FrameScratch().pack(value))
    assert got == pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    back = pickle.loads(got)
    assert back["k"] == 3 and np.array_equal(back["a"], value["a"])


class _CudaTensorFrame:
    """Pickles as a CUDA tensor's wire form (no card needed to write
    it): what a GPU stage's frame holds."""

    def __reduce__(self):
        from ray_tpu_torch._private.serialization import _rebuild_tensor

        return (_rebuild_tensor, (pickle.PickleBuffer(bytearray(8)),
                                  "float32", (2,), "cuda", False, False))


def test_cuda_tensor_frame_on_a_reader_without_gpu_raises(chan):
    """A CUDA tensor's frame read where no GPU is visible raises the
    runtime's own error instead of landing on the CPU."""
    chan.write_frame(TAG_OK, 1, FrameScratch().pack(_CudaTensorFrame()))
    tag, seq, view = chan.read_frame(timeout=5)
    try:
        with pytest.raises(RuntimeError, match="sees no GPU"):
            pickle.loads(view)
    finally:
        del view
        chan.release_frame()


def test_compiled_actor_graph_carries_tensors():
    """An actor graph whose stages exchange torch tensors: the frames
    carry them through the channels to the driver."""

    @ray_tpu_torch.remote
    class Scale:
        def __init__(self, k):
            self.k = k

        def f(self, x):
            import torch as t

            return t.as_tensor(x) * self.k

        def stats(self, x):
            return {"sum": x.sum(), "dtype": str(x.dtype), "x": x}

    a, b = Scale.remote(2.0), Scale.remote(1.0)
    ray_tpu_torch.get([a.f.remote(1.0), b.f.remote(1.0)], timeout=60)
    compiled = dag_mod.bind(
        b.stats, dag_mod.bind(a.f, dag_mod.InputNode())).experimental_compile()
    assert compiled._channels is not None
    try:
        for seed in range(3):
            x = torch.randn(5, 3, generator=torch.Generator().manual_seed(seed))
            got = compiled.execute(x)
            assert torch.equal(got["x"], x * 2.0)
            assert got["dtype"] == "torch.float32"
            torch.testing.assert_close(got["sum"], (x * 2.0).sum())
    finally:
        compiled.teardown()


def test_channel_graph_executor_pumps_a_stage():
    """`CoreWorker._start_channel_graph` on its own: it attaches the
    stage's channels at install, runs the method once per input frame,
    and its thread ends when the channels shut down."""
    from ray_tpu_torch._private.core_worker import CoreWorker

    class Holder:
        class _actor_instance:
            @staticmethod
            def double(x):
                return x * 2

    cin = ShmChannel.create(ShmChannel.make_name(0), 1 << 12)
    cout = ShmChannel.create(ShmChannel.make_name(1), 1 << 12)
    stage = {"method": "double", "nargs": 1, "ins": [(0, cin._name)],
             "consts": [], "outs": [cout._name]}
    before = {t.ident for t in threading.enumerate()}
    try:
        assert CoreWorker._start_channel_graph(Holder(), [stage]) == "started"
        (pump,) = [t for t in threading.enumerate()
                   if t.ident not in before and t.name == "dag-graph"]
        for seq in (1, 2):
            cin.write_frame(TAG_OK, seq, FrameScratch().pack(seq * 10))
            tag, s, view = cout.read_frame(timeout=10)
            assert (tag, s, pickle.loads(view)) == (TAG_OK, seq, seq * 20)
            del view
            cout.release_frame()
    finally:
        for c in (cin, cout):
            c.signal_shutdown()
        for c in (cin, cout):
            c.destroy()
            c.close()
    pump.join(timeout=10)
    assert not pump.is_alive()


# -- torch_stage: a chain fused into one compiled_step ------------------------

def test_compiled_torch_chain_fuses():
    """The port of `test_compiled_jax_chain_fuses`: two `torch_stage`s
    fuse into one `compiled_step` (eager on the CPU) and the lazy path
    still runs them as remote tasks."""

    def scale(x):
        return x * 2.0

    def shift(x):
        return x + 1.0

    s1 = dag_mod.torch_stage(scale)
    s2 = dag_mod.torch_stage(shift)
    graph = dag_mod.bind(s2, dag_mod.bind(s1, dag_mod.InputNode()))
    compiled = graph.experimental_compile()
    assert compiled._fused is not None and compiled._channels is None
    x = torch.ones(8)
    out = compiled.execute(x)
    torch.testing.assert_close(out, torch.full((8,), 3.0))
    assert torch.equal(x, torch.ones(8))  # the root input is not donated
    # results held across executes stay distinct
    again = compiled.execute(torch.zeros(8))
    torch.testing.assert_close(out, torch.full((8,), 3.0))
    torch.testing.assert_close(again, torch.full((8,), 1.0))
    stats = compiled._fused.stats.as_dict()
    compiled.teardown()
    assert compiled._fused is None
    assert stats["misses"] >= 1
    assert float(ray_tpu_torch.get(graph.execute(1.0), timeout=60)) == 3.0


def test_fused_chain_copies_tensor_outputs():
    """`execute` returns copies of the chain's tensor outputs (a graph's
    outputs are static tensors that the next replay overwrites), in the
    output's structure."""
    keep = []

    def stage(x):
        out = x + 1
        keep.append(out)
        return {"y": out, "pair": (out * 2, "tag")}

    compiled = dag_mod.bind(dag_mod.torch_stage(stage),
                            dag_mod.InputNode()).experimental_compile()
    try:
        got = compiled.execute(torch.arange(4.0))
        assert got["pair"][1] == "tag"
        assert got["y"].data_ptr() != keep[-1].data_ptr()
        torch.testing.assert_close(got["y"], torch.arange(4.0) + 1)
        torch.testing.assert_close(got["pair"][0], (torch.arange(4.0) + 1) * 2)
    finally:
        compiled.teardown()


def test_fused_tiny_gpt_chain_matches_jax_chain():
    """The forward, the last position's logits and the greedy ids as
    three `torch_stage`s over the port's tiny GPT against the same three
    `jax_stage`s over the JAX tiny GPT on the same weights, f32."""
    from ray_tpu import dag as jdag
    from ray_tpu.models import gpt as jgpt
    from ray_tpu.ops import flash_attention as jflash
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.ops.flash_attention import flash_attention

    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    jnet = jgpt.GPT(jcfg, attention_fn=partial(jflash, causal=True))
    ids = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 24)).astype(np.int32)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    params = convert.gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables)),
        cfg, device="cpu", dtype=torch.float32)
    net = tgpt.GPT.from_params(cfg, params, attention_fn=partial(
        flash_attention, causal=True))

    def t_forward(x):
        with torch.no_grad():
            return net(x)

    def t_last(logits):
        return logits[:, -1, :]

    def t_greedy(last):
        return torch.argmax(last, dim=-1), last

    def j_forward(x):
        return jnet.apply(variables, x)

    def j_last(logits):
        return logits[:, -1, :]

    def j_greedy(last):
        return jnp.argmax(last, axis=-1), last

    def chain(mod, stage, fns):
        node = mod.InputNode()
        for fn in fns:
            node = mod.bind(stage(fn), node)
        return node.experimental_compile()

    port = chain(dag_mod, dag_mod.torch_stage, (t_forward, t_last, t_greedy))
    ref = chain(jdag, jdag.jax_stage, (j_forward, j_last, j_greedy))
    assert port._fused is not None and ref._jitted is not None
    try:
        for rows in (ids, ids[::-1].copy()):
            got_ids, got_last = port.execute(torch.from_numpy(rows).long())
            want_ids, want_last = ref.execute(jnp.asarray(rows))
            np.testing.assert_allclose(got_last.numpy(),
                                       np.asarray(want_last),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got_ids.numpy(),
                                          np.asarray(want_ids))
    finally:
        port.teardown()


# One script of compiled actor graphs, run once against each package in
# its own process: the port must give the JAX package's results.
TWO_PACKAGE_SCRIPT = r'''
import importlib, json, sys, time
import numpy as np
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
dag = importlib.import_module(pkg + ".dag")
gpus = {"num_gpus": 0} if pkg == "ray_tpu_torch" else {"num_tpus": 0}
rt.init(num_cpus=4, object_store_memory=128 << 20, **gpus)


@rt.remote
class Node:
    def __init__(self, k):
        self.k = k
        self.calls = 0

    def add(self, x):
        self.calls += 1
        if x == "boom":
            raise ValueError("stage exploded")
        return x + self.k

    def double(self, x):
        return x * 2

    def combine(self, a, b, c):
        return [a, b, c]

    def mul(self, a, b):
        return a * b

    def sum2(self, a, b):
        return a + b

    def n_calls(self):
        return self.calls

    def slow(self, x):
        delay, v = x
        if delay:
            time.sleep(delay)
        return ["out", v]

    def layer(self, x):
        rng = np.random.RandomState(self.k)
        w = rng.randn(8, 8).astype(np.float32) * 0.3
        return np.tanh(x @ w)


out = {}
try:
    a, b, c, d = [Node.remote(k) for k in (1, 10, 100, 1000)]
    rt.get([n.add.remote(0) for n in (a, b, c, d)], timeout=60)
    chain = dag.bind(c.add, dag.bind(b.add, dag.bind(a.add,
                                                     dag.InputNode())))
    cd = chain.experimental_compile()
    out["chain"] = [cd.execute(x) for x in (5, 0, 7)]
    try:
        cd.execute("boom")
        out["chain_error"] = None
    except rt.RayTaskError as e:
        out["chain_error"] = [type(e).__name__, "stage exploded" in str(e)]
    out["chain_after_error"] = cd.execute(1)
    cd.teardown()
    out["after_teardown"] = rt.get(a.add.remote(1), timeout=60)

    src = dag.bind(a.double, dag.InputNode())
    diamond = dag.bind(d.combine, dag.bind(b.add, src),
                       dag.bind(c.double, src), 99).experimental_compile()
    out["diamond"] = [diamond.execute(x) for x in (3, 0, 11)]
    diamond.teardown()

    added = dag.bind(a.sum2, dag.InputNode(0), dag.InputNode(1))
    both = dag.MultiOutputNode([added, dag.bind(b.mul, added, 10)])
    multi = both.experimental_compile()
    out["multi"] = [multi.execute(3, 4), multi.execute(1, 1)]
    multi.teardown()

    pipe = dag.bind(b.layer, dag.bind(a.layer, dag.InputNode()))
    pc = pipe.experimental_compile()
    x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    out["pipeline"] = np.round(pc.execute(x), 5).tolist()
    pc.teardown()

    sc = dag.bind(d.slow, dag.InputNode()).experimental_compile()
    out["timeout"] = [sc.execute((0, "A"))]
    try:
        sc.execute((2.0, "SLOW"), timeout=0.3)
        out["timeout"].append("no timeout")
    except TimeoutError:
        out["timeout"].append("TimeoutError")
    out["timeout"].append(sc.execute((0, "B"), timeout=30))
    sc.teardown()
    out["lazy"] = rt.get(chain.execute(2), timeout=60)
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def test_one_graph_script_gives_equal_results_on_both_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", TWO_PACKAGE_SCRIPT, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    want = results["ray_tpu"]
    assert want["chain"] == [116, 111, 118]
    assert want["chain_error"] == ["RayTaskError", True]
    assert want["timeout"] == [["out", "A"], "TimeoutError", ["out", "B"]]
    assert results["ray_tpu_torch"] == want
