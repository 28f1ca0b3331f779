"""The spans inside the engine's step and the train runner
(`ray_tpu_torch.util.tracing`): ranges on a running `torch.profiler`
session's timeline, JSONL records under `RAY_TPU_TRACE=1`, neither with
both off; and the runner's records, whose device time comes from timing
events read one call late."""

import json

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
from ray_tpu_torch.train import TrainStepRunner
from ray_tpu_torch.util import step_profiler as tsp
from ray_tpu_torch.util import tracing

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]
NEW = [4, 3, 5]
ENGINE_SPANS = {"llm.step", "llm.admit", "llm.prefill", "llm.decode",
                "llm.decode.inputs", "llm.decode.sync", "llm.decode.post",
                "compiled_step.lookup", "compiled_step.replay"}
TRAIN_SPANS = {"train.step", "train.prep", "compiled_step.lookup",
               "compiled_step.replay", "train.record"}
# each span's possible parents
ENGINE_NESTING = {
    "llm.admit": {"llm.step"}, "llm.prefill": {"llm.step"},
    "llm.decode": {"llm.step"}, "llm.decode.inputs": {"llm.decode"},
    "llm.decode.sync": {"llm.decode"}, "llm.decode.post": {"llm.decode"},
    "compiled_step.lookup": {"llm.prefill", "llm.decode"},
    "compiled_step.replay": {"llm.prefill", "llm.decode"}}
TRAIN_NESTING = {name: {"train.step"}
                 for name in TRAIN_SPANS - {"train.step"}}


def _engine():
    return LLMEngine(model="gpt", device="cpu", engine_config=EngineConfig(
        block_size=4, batch_buckets=(1, 2, 4), prefill_buckets=(8, 16),
        prefix_cache=0))


def _serve(eng):
    reqs = [eng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
    eng.run_until_idle(timeout=120)
    tokens = [r.result(timeout=30) for r in reqs]
    assert [len(t) for t in tokens] == NEW
    return tokens


def _runner():
    return TrainStepRunner(lambda c, b: (c + b.sum(), b.sum()),
                           device="cpu")


def _train(runner, calls=3):
    carry = torch.zeros(())
    for i in range(calls):
        carry, _ = runner.run(carry, torch.ones(4) * i)
    return carry


def _annotations(body, tmp_path, **kw):
    """The user_annotation events of a CPU profiler session around
    `body()`."""
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _parents(events):
    """{span name: names of the spans that enclose it most closely} on
    each thread."""
    out = {}
    for e in events:
        around = [p for p in events if p is not e and p["tid"] == e["tid"]
                  and p["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        if around:
            inner = min(around, key=lambda p: p["dur"])
            out.setdefault(e["name"], set()).add(inner["name"])
    return out


def test_engine_spans_are_profiler_ranges_on_the_stepping_thread(tmp_path):
    eng = _engine()
    try:
        events = _annotations(lambda: _serve(eng), tmp_path)
    finally:
        assert eng.shutdown() == 0
    ours = [e for e in events if e["name"] in ENGINE_SPANS]
    assert {e["name"] for e in ours} == ENGINE_SPANS
    assert len({e["tid"] for e in ours}) == 1
    parents = _parents(ours)
    assert "llm.step" not in parents
    for name, allowed in ENGINE_NESTING.items():
        assert parents[name] <= allowed, (name, parents[name])
    counts = {n: sum(e["name"] == n for e in ours) for n in ENGINE_SPANS}
    # one of each a step, none a sequence: the decodes of 3 sequences
    assert counts["llm.decode.inputs"] == counts["llm.decode.sync"] == \
        counts["llm.decode.post"] == counts["llm.decode"]
    assert counts["llm.admit"] == counts["llm.step"]
    assert counts["llm.prefill"] == len(PROMPTS)
    assert counts["compiled_step.replay"] == \
        counts["llm.prefill"] + counts["llm.decode"]
    assert not any(n.startswith("llm.prefill") for n in
                   ENGINE_SPANS - {"llm.prefill"})


def test_the_pump_threads_spans_reach_a_session_of_every_thread(tmp_path):
    """A session started on another thread with `profile_all_threads`
    records the pump thread's spans there: the check of a running
    session is process-wide, not the calling thread's."""
    eng = _engine()
    pump = {}

    def body():
        eng.start()
        pump["tid"] = eng._thread.native_id
        reqs = [eng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
        assert [len(r.result(timeout=60)) for r in reqs] == NEW
        eng.stop()

    try:
        events = _annotations(body, tmp_path,
                              experimental_config=_ExperimentalConfig(
                                  profile_all_threads=True))
    finally:
        assert eng.shutdown() == 0
    ours = [e for e in events if e["name"] in ENGINE_SPANS]
    assert {e["name"] for e in ours} == ENGINE_SPANS
    assert {e["tid"] for e in ours} == {pump["tid"]}
    for name, allowed in ENGINE_NESTING.items():
        assert _parents(ours)[name] <= allowed, name


def test_runner_spans_are_profiler_ranges(tmp_path):
    runner = _runner()
    events = _annotations(lambda: _train(runner), tmp_path)
    ours = [e for e in events if e["name"] in TRAIN_SPANS]
    counts = {n: sum(e["name"] == n for e in ours) for n in TRAIN_SPANS}
    assert counts == {n: 3 for n in TRAIN_SPANS}
    parents = _parents(ours)
    assert "train.step" not in parents
    for name, allowed in TRAIN_NESTING.items():
        assert parents[name] == allowed, (name, parents[name])


class _Raises:
    def __init__(self, *a, **kw):
        raise AssertionError("a profiler range was opened")


def test_no_range_without_a_profiler(monkeypatch):
    monkeypatch.delenv("RAY_TPU_TRACE", raising=False)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Raises)
    assert not tracing.profiling() and not tracing.enabled()
    eng = _engine()
    try:
        tokens = _serve(eng)
    finally:
        assert eng.shutdown() == 0
    assert len(tokens) == len(PROMPTS)
    assert float(_train(_runner())) == 4 * (0 + 1 + 2)
    with tracing.span("llm.step") as s:
        assert s == {}


def test_the_same_names_reach_the_jsonl_shard(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE", "1")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(tmp_path))
    tracing._reset_writer()
    try:
        eng = _engine()
        try:
            _serve(eng)
        finally:
            assert eng.shutdown() == 0
        _train(_runner())
    finally:
        monkeypatch.delenv("RAY_TPU_TRACE")
        tracing._reset_writer()
    spans = tracing.collect(str(tmp_path))
    names = {s["name"] for s in spans}
    assert ENGINE_SPANS | TRAIN_SPANS <= names
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        want = ENGINE_NESTING.get(s["name"], set()) | \
            TRAIN_NESTING.get(s["name"], set())
        if want:
            assert by_id[s["parent_id"]]["name"] in want, s


class _Event:
    """A timing event's stand-in: `elapsed_time` is the ms its pair
    was given, readable once `synchronize` ran."""

    log = []

    def __init__(self, ms):
        self.ms, self.synced = ms, False

    def record(self, stream):
        _Event.log.append(("record", self.ms, stream))

    def synchronize(self):
        self.synced = True
        _Event.log.append(("sync", self.ms))

    def elapsed_time(self, end):
        assert end.synced
        return end.ms


def test_runner_reads_each_calls_events_after_the_next_launch(monkeypatch):
    """On the card each call records a pair of timing events around its
    compiled call and the recorder reads them after the NEXT call has
    launched (no host synchronize in between); the last call's are read
    with the records. One record a call, with the same fields."""
    tsp.clear()
    log = _Event.log = []
    ms = iter([7.0, 8.0, 9.0])

    def step(carry, batch):
        log.append(("launch", float(batch[0])))
        return carry + batch.sum(), batch.sum()

    runner = TrainStepRunner(step, device="cpu", tokens_per_step=4,
                             flops_per_step=1e6, peak_flops=1e12)
    monkeypatch.setattr(
        runner, "_timing_events",
        lambda: (lambda m: (_Event(0.0), _Event(m), "stream"))(next(ms)))
    carry = torch.zeros(())
    for i in range(3):
        carry, _ = runner.run(carry, torch.ones(4) * i)
    assert tsp.ring().total_recorded == 3
    assert log == [
        ("record", 0.0, "stream"), ("launch", 0.0), ("record", 7.0, "stream"),
        ("record", 0.0, "stream"), ("launch", 1.0), ("record", 8.0, "stream"),
        ("sync", 7.0),
        ("record", 0.0, "stream"), ("launch", 2.0), ("record", 9.0, "stream"),
        ("sync", 8.0)]
    rows = runner.step_stats()
    assert log[-1] == ("sync", 9.0)
    assert [r["device_execute_ms"] for r in rows] == [7.0, 8.0, 9.0]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(set(r) == {"step", "ts", "total_ms", "tokens", "flops",
                          "mfu", "steps_per_call", "host_dispatch_ms",
                          "device_execute_ms", "data_wait_ms",
                          "collective_ms", "checkpoint_ms"}
               and r["tokens"] == 4 and r["mfu"] is not None
               for r in rows)
    assert float(carry) == 12.0
    tsp.clear()


def test_unresolved_device_times_reach_the_step_shard(tmp_path,
                                                      monkeypatch):
    """A record with events is written to the steps shard once its
    device time is read, with that time."""
    monkeypatch.setenv("RAY_TPU_TRACE", "1")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(tmp_path))
    tsp.clear()
    tsp._reset_shard_writer()
    try:
        tsp.record_step(1, 5.0, device_events=(_Event(0.0), _Event(3.5)))
        assert tsp.collect(str(tmp_path)) == []
        text = tsp.metrics_text()
        assert 'train_step_time_ms{phase="device_execute"} 3.5' in text
        (rec,) = tsp.collect(str(tmp_path))
        assert rec["device_execute_ms"] == 3.5
    finally:
        tsp.clear()
        tsp._reset_shard_writer()
