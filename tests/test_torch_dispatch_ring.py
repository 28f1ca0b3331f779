"""The native request ring of the port (`ray_tpu_torch/native/
request_ring.cc`, bound in `ray_tpu_torch/serve/dispatch.py`): the
scenarios of `tests/test_dispatch_ring.py` against the port's build and
its own segment names, under the port's lock-order checker.

- ring semantics: mint/deadline/pow-2 choice happen natively; the
  rejection codes (FULL / DEADLINE / TOO_BIG / NO_REPLICA) map to
  shed-vs-fallback in Python; generation-checked `done` drops stale
  completions;
- thread + process races: producers hammer `rr_enqueue` against
  batch-draining consumers while a churn thread bumps the snapshot
  version / marks replicas dead / fires stale dones — no torn frames,
  every successful enqueue drains exactly once, and the inflight
  counters balance to zero at quiesce;
- Router satellites: stable replica keying across `mark_dead`
  compaction, in-flight counts preserved across version bumps, the
  `serve_router_empty_waits_total` counter, and per-site seeded pow-2
  picks under an armed FaultPlan;
- a JAX deployment and a port deployment of one name never share a
  segment, a router FIFO or a response ring.

The library is built from the checkout with g++ (`native.build`); a
build that fails fails these tests.
"""

import os
import random
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu_torch._private import lockdep
from ray_tpu_torch.serve import dispatch as _dispatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def lockdep_gate():
    """The port's lockdep, record-only here; a cycle fails at teardown."""
    already = lockdep.enabled()
    if not already:
        lockdep.install(raise_on_cycle=False)
    try:
        yield
    finally:
        reports = lockdep.cycle_reports()
        if not already:
            lockdep.uninstall()
        assert not reports, (
            "lockdep: lock-order cycle(s) detected:\n\n"
            + "\n\n".join(reports))


@pytest.fixture(scope="module")
def native_lib():
    from ray_tpu_torch.native import library_path, load_request_ring
    load_request_ring()
    assert _dispatch._load() is not None
    return library_path("request_ring")


def _fresh_segment() -> str:
    return f"/{_dispatch.SEGMENT_PREFIX}t{os.getpid():x}{os.urandom(3).hex()}"


@pytest.fixture
def ring(native_lib):
    seg = _fresh_segment()
    r = _dispatch.DispatchRing(seg, table_cap=4, slots=256, slot_bytes=256)
    yield r
    r.close(unlink=True)


def _inflight_sum(r: _dispatch.DispatchRing) -> int:
    _ver, rows = r.snapshot()
    return sum(row[2] for row in rows)


# ---------------------------------------------------------------------------
# ring semantics
# ---------------------------------------------------------------------------

class TestRingSemantics:
    def test_no_replica_rejected(self, ring):
        with pytest.raises(_dispatch.DispatchRejected) as e:
            ring.enqueue(b"x")
        assert e.value.code == _dispatch.ERR_NO_REPLICA
        assert ring.stats()["no_replica"] >= 1

    def test_expired_deadline_shed_natively(self, ring):
        ring.publish(1, [7])
        with pytest.raises(_dispatch.DispatchRejected) as e:
            ring.enqueue(b"x", deadline_ns=1)  # long past
        assert e.value.code == _dispatch.ERR_DEADLINE
        assert ring.stats()["deadline_shed"] >= 1

    def test_oversized_payload_rejected(self, ring):
        ring.publish(1, [7])
        with pytest.raises(_dispatch.DispatchRejected) as e:
            ring.enqueue(b"x" * (ring.slot_bytes + 1))
        assert e.value.code == _dispatch.ERR_TOO_BIG

    def test_frame_roundtrip_and_inflight(self, ring):
        ring.publish(1, [7])
        trace, rid, gen = ring.enqueue(b"hello", client=0xabc)
        assert rid == 7
        assert trace != 0
        # natively-minted trace ids stitch into the recorder wire format
        tid = _dispatch.format_trace(trace)
        assert len(tid) == 16 and int(tid, 16) == trace
        assert _inflight_sum(ring) == 1
        frames = ring.drain(ring.ring_of(7))
        assert len(frames) == 1
        f = frames[0]
        assert (f.trace, f.rid, f.gen) == (trace, rid, gen)
        assert f.client == 0xabc
        assert f.tag == _dispatch.TAG_REQUEST
        assert f.payload == b"hello"
        assert ring.done(rid, gen)
        assert _inflight_sum(ring) == 0

    def test_stale_generation_done_dropped(self, ring):
        ring.publish(1, [7])
        _trace, rid, gen = ring.enqueue(b"x")
        # wrong generation: the completion belongs to a previous tenant
        # of the slot — it must NOT decrement the current counter
        assert not ring.done(rid, gen + 1)
        assert ring.stats()["done_stale"] >= 1
        assert _inflight_sum(ring) == 1
        assert ring.done(rid, gen)
        assert _inflight_sum(ring) == 0

    def test_retire_and_readd_bumps_generation(self, ring):
        # the ABA shape the packed gen<<32|inflight word exists for:
        # replica 7 leaves, its slot is re-issued to 7 again (scale
        # down/up) — a completion from the FIRST tenancy must not touch
        # the second's counter
        ring.publish(1, [7])
        _t, rid, old_gen = ring.enqueue(b"x")
        ring.drain(ring.ring_of(7))
        ring.publish(2, [8])        # 7 retired: gen bump + inflight zeroed
        ring.publish(3, [7, 8])     # 7 re-added under a fresh generation
        assert not ring.done(rid, old_gen)
        assert _inflight_sum(ring) == 0

    def test_full_ring_rejected(self, ring):
        ring.publish(1, [7])
        for _ in range(ring.slots):
            ring.enqueue(b"x")
        with pytest.raises(_dispatch.DispatchRejected) as e:
            ring.enqueue(b"x")
        assert e.value.code == _dispatch.ERR_FULL
        assert ring.stats()["full_rejects"] >= 1

    def test_pow2_choice_balances(self, ring):
        ring.publish(1, [11, 22, 33, 44])
        for _ in range(200):
            ring.enqueue(b"x")
        pend = [ring.pending(r) for r in range(4)]
        assert sum(pend) == 200
        # two-choice against live inflight counters: no ring starves
        assert min(pend) >= 20, pend

    def test_metrics_text_renders_counters(self, ring):
        ring.publish(1, [7])
        ring.enqueue(b"x")
        ring.drain(ring.ring_of(7))
        text = ring.metrics_text("demo")
        assert 'serve_dispatch_enqueued_total{domain="demo"} 1' in text
        assert 'serve_dispatch_drained_total{domain="demo"} 1' in text


# ---------------------------------------------------------------------------
# thread + process races under snapshot churn
# ---------------------------------------------------------------------------

_IDS = (11, 22, 33, 44)


def _uniform(n: int) -> bytes:
    return bytes([n % 251]) * (n % 96 + 1)


def _is_torn(payload: bytes) -> bool:
    return payload != payload[:1] * len(payload)


@pytest.mark.usefixtures("native_lib")
class TestRaces:
    def test_threads_race_enqueue_drain_under_churn(self):
        seg = _fresh_segment()
        ring = _dispatch.DispatchRing(seg, table_cap=4, slots=256,
                                      slot_bytes=256)
        ring.publish(1, list(_IDS))
        stop_churn = threading.Event()
        producers_done = threading.Event()
        enq_ok = []          # per-producer success counts
        drained = [0, 0]
        torn = [0]
        errors = []

        def producer(n):
            ok = 0
            for i in range(500):
                try:
                    ring.enqueue(_uniform(n * 1000 + i))
                    ok += 1
                except _dispatch.DispatchRejected:
                    pass      # FULL under churn is expected shed
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    break
            enq_ok.append(ok)

        def consumer(slot, rings):
            # own attachment: drain buffers are per-object
            mine = _dispatch.DispatchRing(seg, create=False)
            try:
                while True:
                    got = 0
                    for r in rings:
                        for f in mine.drain(r, 64):
                            got += 1
                            if _is_torn(f.payload):
                                torn[0] += 1
                            mine.done(f.rid, f.gen)
                    drained[slot] += got
                    if got == 0:
                        if producers_done.is_set() and \
                                all(mine.pending(r) == 0 for r in rings):
                            return
                        time.sleep(0.001)
            finally:
                mine.close()

        def churn():
            mine = _dispatch.DispatchRing(seg, create=False)
            rng = random.Random(19)
            ver = 2
            try:
                while not stop_churn.is_set():
                    keep = rng.sample(_IDS, rng.randint(1, 4))
                    mine.publish(ver, keep)
                    ver += 1
                    mine.mark_dead(rng.choice(_IDS))
                    mine.done(rng.choice(_IDS), 0)   # stale: must drop
                    mine.snapshot()
                    time.sleep(0.002)
                mine.publish(ver, list(_IDS))        # restore for quiesce
            finally:
                mine.close()

        threads = ([threading.Thread(target=producer, args=(n,))
                    for n in range(6)]
                   + [threading.Thread(target=consumer, args=(0, (0, 1))),
                      threading.Thread(target=consumer, args=(1, (2, 3)))])
        ct = threading.Thread(target=churn)
        ct.start()
        for t in threads:
            t.start()
        for t in threads[:6]:
            t.join(60)
        stop_churn.set()
        ct.join(10)
        producers_done.set()
        for t in threads[6:]:
            t.join(60)
        try:
            assert not errors, errors
            assert torn[0] == 0
            # zero leaked frames: every successful enqueue drained once
            assert sum(drained) == sum(enq_ok)
            assert sum(enq_ok) > 0
            assert _inflight_sum(ring) == 0
        finally:
            ring.close(unlink=True)

    def test_processes_race_enqueue_against_local_drain(self):
        seg = _fresh_segment()
        ring = _dispatch.DispatchRing(seg, table_cap=4, slots=256,
                                      slot_bytes=256)
        ring.publish(1, list(_IDS))
        child_src = (
            "import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from ray_tpu_torch.serve import dispatch as d\n"
            f"ring = d.DispatchRing({seg!r}, create=False)\n"
            "ok = 0\n"
            "for i in range(2000):\n"
            "    try:\n"
            "        ring.enqueue(bytes([i % 251]) * 64)\n"
            "        ok += 1\n"
            "    except d.DispatchRejected:\n"
            "        pass\n"
            "print('CHILD', ok)\n"
        )
        procs = [subprocess.Popen(
            [sys.executable, "-c", child_src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for _ in range(2)]

        stop = threading.Event()
        drained = [0]
        torn = [0]

        def consumer():
            mine = _dispatch.DispatchRing(seg, create=False)
            try:
                while True:
                    got = 0
                    for r in range(4):
                        for f in mine.drain(r, 64):
                            got += 1
                            if _is_torn(f.payload):
                                torn[0] += 1
                            mine.done(f.rid, f.gen)
                    drained[0] += got
                    if got == 0:
                        if stop.is_set() and \
                                all(mine.pending(r) == 0 for r in range(4)):
                            return
                        time.sleep(0.001)
            finally:
                mine.close()

        def churn():
            rng = random.Random(7)
            ver = 2
            while not stop.is_set():
                ring.publish(ver, rng.sample(_IDS, rng.randint(2, 4)))
                ver += 1
                time.sleep(0.005)
            ring.publish(ver, list(_IDS))

        ct1 = threading.Thread(target=consumer)
        ct2 = threading.Thread(target=churn)
        ct1.start()
        ct2.start()
        child_ok = 0
        try:
            for p in procs:
                out, err = p.communicate(timeout=120)
                assert p.returncode == 0, err[-2000:]
                child_ok += int(out.split()[-1])
        finally:
            stop.set()
            ct2.join(10)
            ct1.join(60)
        try:
            assert torn[0] == 0
            assert drained[0] == child_ok
            assert child_ok > 0
            assert _inflight_sum(ring) == 0
        finally:
            ring.close(unlink=True)


# ---------------------------------------------------------------------------
# Router satellites: stable keying, empty-wait wakeup, seeded picks
# ---------------------------------------------------------------------------

class _FakeActor:
    """Enough surface for dispatch.replica_key: a stable actor id."""

    def __init__(self, tag: int):
        self._actor_id = bytes([tag]) * 8


class _FakeController:
    """Duck-typed controller: `.get_replicas.remote(name)` returns the
    payload itself; ray_tpu_torch.get is patched to pass it through."""

    def __init__(self, replicas):
        self.version = 1
        self.replicas = list(replicas)
        outer = self

        class _Method:
            @staticmethod
            def remote(_name):
                return {"version": outer.version,
                        "replicas": list(outer.replicas)}

        self.get_replicas = _Method()


@pytest.fixture
def passthrough_get(monkeypatch):
    import ray_tpu_torch
    monkeypatch.setattr(ray_tpu_torch, "get",
                        lambda ref, timeout=None: ref)


def _mk_router(ctrl, name):
    from ray_tpu_torch.serve.handle import Router
    r = Router(ctrl, name)
    return r


class TestRouterKeying:
    def test_done_after_compaction_hits_the_right_replica(
            self, passthrough_get):
        # Regression for the positional-index aliasing: with the old
        # list keying, mark_dead compacted the list and a done(idx)
        # from a request dispatched BEFORE the compaction decremented
        # whichever replica slid into that slot. Stable keys: the late
        # completion hits its own replica or (replica gone) nothing.
        a, b, c = _FakeActor(1), _FakeActor(2), _FakeActor(3)
        ka, kb, kc = (_dispatch.replica_key(x) for x in (a, b, c))
        ctrl = _FakeController([a, b, c])
        r = _mk_router(ctrl, f"dr-{os.urandom(3).hex()}")
        try:
            for _ in range(3):
                r.choose()
            before = dict(r._inflight)
            assert sum(before.values()) == 3
            r.mark_dead(ka)
            # late completion for the dead replica: decrements NOBODY
            r.done(ka)
            assert r._inflight.get(kb) == before[kb]
            assert r._inflight.get(kc) == before[kc]
            # survivor completions land on their own counter
            r._inflight[kb] = 2
            r.done(kb)
            assert r._inflight[kb] == 1
            assert r._inflight[kc] == before[kc]
        finally:
            r._wake.close(unlink=True)

    def test_counts_preserved_across_version_bump(self, passthrough_get):
        a, b, c = _FakeActor(1), _FakeActor(2), _FakeActor(3)
        ka, kb, _kc = (_dispatch.replica_key(x) for x in (a, b, c))
        ctrl = _FakeController([a, b])
        r = _mk_router(ctrl, f"dr-{os.urandom(3).hex()}")
        try:
            r._refresh(force=True)
            r._inflight[ka] = 4
            r._inflight[kb] = 2
            ctrl.version = 2
            ctrl.replicas = [b, c]   # a departs, c arrives
            r._last_refresh = 0.0
            r._refresh(force=True)
            assert ka not in r._inflight          # departed: count drops
            assert r._inflight[kb] == 2           # survivor: preserved
            assert r._inflight[_dispatch.replica_key(c)] == 0
        finally:
            r._wake.close(unlink=True)

    def test_empty_wait_counts_once_and_wakes_on_publish(
            self, passthrough_get):
        from ray_tpu_torch.serve.handle import ROUTER_EMPTY_WAITS
        name = f"dr-{os.urandom(3).hex()}"
        ctrl = _FakeController([])
        r = _mk_router(ctrl, name)
        before = ROUTER_EMPTY_WAITS._values.get((name,), 0.0)
        out = []

        def run():
            out.append(r.choose())

        t = threading.Thread(target=run)
        t.start()
        try:
            time.sleep(0.6)  # several wait slices while the view is empty
            assert not out
            # replica arrives; the controller posts the wake FIFO on the
            # version bump (dispatch-agnostic: plain mkfifo token)
            ctrl.version = 2
            ctrl.replicas = [_FakeActor(9)]
            r._last_refresh = 0.0
            _dispatch._Wakeup(_dispatch.router_wake_path(name)).post()
            t.join(10)
            assert not t.is_alive()
            assert out and out[0][1] is ctrl.replicas[0]
            after = ROUTER_EMPTY_WAITS._values.get((name,), 0.0)
            # one empty EPISODE == one count, however many slices it took
            assert after - before == 1.0
        finally:
            r._wake.close(unlink=True)

    def test_pow2_picks_replay_under_armed_fault_plan(
            self, passthrough_get):
        from ray_tpu_torch._private import fault_injection as _fi
        actors = [_FakeActor(i + 1) for i in range(5)]

        def pick_sequence():
            plan = _fi.install(_fi.FaultPlan("seed=7"))
            assert plan.rng_for("serve.router") is not None
            ctrl = _FakeController(actors)
            r = _mk_router(ctrl, f"dr-{os.urandom(3).hex()}")
            try:
                seq = []
                for _ in range(24):
                    key, _actor = r.choose()
                    r.done(key)   # keep the inflight view flat
                    seq.append(key)
                return seq
            finally:
                r._wake.close(unlink=True)
                _fi.uninstall()

        assert pick_sequence() == pick_sequence()


# ---------------------------------------------------------------------------
# recorder stitching for natively-minted trace ids
# ---------------------------------------------------------------------------

class TestAdoptContext:
    def test_adopted_context_shape(self):
        from ray_tpu_torch.util import request_recorder as _rr
        tid = _dispatch.format_trace(0xdeadbeef)
        ctx = _rr.adopt_context(tid, "echo", job="jobA")
        assert ctx["req_id"] == "00000000deadbeef"
        assert ctx["deployment"] == "echo"
        assert ctx["job"] == "jobA"
        assert "sampled" in ctx

    def test_domain_segment_is_stable_shm_name(self):
        s1 = _dispatch.domain_segment("echo")
        s2 = _dispatch.domain_segment("echo")
        assert s1 == s2
        assert s1.startswith("/ray_tpu_torch_ds.") and "/" not in s1[1:]
        assert _dispatch.domain_segment("other") != s1

    def test_segment_names_cover_the_cluster(self, monkeypatch):
        """Two clusters on one host (two GCS addresses) get different
        domains and router FIFOs for one deployment name; every process
        of one cluster gets the same, however its GCS host is spelled."""
        from types import SimpleNamespace

        from ray_tpu_torch._private import object_ref

        def names(gcs_addr):
            monkeypatch.setattr(object_ref, "_global_core_worker",
                                SimpleNamespace(gcs_addr=gcs_addr))
            return (_dispatch.domain_segment("llm"),
                    _dispatch.router_wake_path("llm"))

        a, b = names("127.0.0.1:6001"), names("127.0.0.1:6002")
        assert a[0] != b[0] and a[1] != b[1]
        for spelled in ("localhost:6001", "127.0.0.1:6001", "0.0.0.0:6001"):
            assert names(spelled) == a
            assert _dispatch.cluster_key() == "127.0.0.1:6001"
        monkeypatch.setattr(object_ref, "_global_core_worker", None)
        assert _dispatch.cluster_key() == ""


# ---------------------------------------------------------------------------
# the two packages' segments stay apart
# ---------------------------------------------------------------------------

def test_jax_and_port_deployments_of_one_name_use_different_segments(
        native_lib):
    """A JAX `"llm"` deployment and a port `"llm"` deployment on one host
    map to different domain segments, router FIFOs and response rings,
    and a frame enqueued into one never drains from the other."""
    from ray_tpu.serve import dispatch as jax_dispatch

    name = f"llm-{os.urandom(3).hex()}"
    assert jax_dispatch.domain_segment(name) != \
        _dispatch.domain_segment(name)
    assert jax_dispatch.router_wake_path(name) != \
        _dispatch.router_wake_path(name)
    assert jax_dispatch.client_segment(0xabc) != \
        _dispatch.client_segment(0xabc)
    assert jax_dispatch.domain_segment(name).startswith("/rtds.")
    assert _dispatch.client_segment(0xabc).startswith(
        "/" + _dispatch.SEGMENT_PREFIX)
    assert jax_dispatch._load() is not None
    mine = _dispatch.DispatchRing(_dispatch.domain_segment(name),
                                  table_cap=2, slots=64, slot_bytes=64)
    theirs = jax_dispatch.DispatchRing(jax_dispatch.domain_segment(name),
                                       table_cap=2, slots=64, slot_bytes=64)
    try:
        mine.publish(1, [7])
        theirs.publish(1, [7])
        mine.enqueue(b"port")
        theirs.enqueue(b"jax")
        got_mine = mine.drain(mine.ring_of(7))
        got_theirs = theirs.drain(theirs.ring_of(7))
        assert [f.payload for f in got_mine] == [b"port"]
        assert [f.payload for f in got_theirs] == [b"jax"]
        assert mine.stats()["enqueued"] == theirs.stats()["enqueued"] == 1
    finally:
        mine.close(unlink=True)
        theirs.close(unlink=True)


def test_request_slots_hold_a_long_prompt_frame(native_lib):
    """A repair of the port: the controller's request slots hold a
    serve.llm frame of a 900-token prompt (GPT-2's longest smoke prompt;
    up to 2048 tokens), which the JAX controller's 1 KiB slots reject
    (ERR_TOO_BIG: that request silently takes the Python path)."""
    from ray_tpu.serve import dispatch as jax_dispatch

    frame = _dispatch.encode_llm_request(list(range(1, 901)), 32, "job")
    assert frame == jax_dispatch.encode_llm_request(
        list(range(1, 901)), 32, "job")
    assert len(_dispatch.encode_llm_request([1] * 2048, 1, "j")) == \
        _dispatch.REQUEST_SLOT_BYTES
    mine = _dispatch.DispatchRing(_fresh_segment(), table_cap=2, slots=64,
                                  slot_bytes=_dispatch.REQUEST_SLOT_BYTES)
    theirs = jax_dispatch.DispatchRing(
        f"/rtds.t{os.getpid():x}{os.urandom(3).hex()}", table_cap=2,
        slots=64, slot_bytes=1024)  # the JAX controller's geometry
    try:
        mine.publish(1, [7])
        theirs.publish(1, [7])
        mine.enqueue(frame)
        (got,) = mine.drain(mine.ring_of(7))
        assert _dispatch.decode_llm_request(got.payload) == (
            list(range(1, 901)), 32, "job")
        with pytest.raises(jax_dispatch.DispatchRejected) as e:
            theirs.enqueue(frame)
        assert e.value.code == jax_dispatch.ERR_TOO_BIG
    finally:
        mine.close(unlink=True)
        theirs.close(unlink=True)
