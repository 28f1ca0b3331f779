"""The split of the device's idle time by the program's spans
(`portbench/spans.py`) and its readers, on a synthetic chrome trace:
kernels, graph launches and nested `user_annotation` ranges on the
launching thread."""

import pytest

from portbench import profiler, spans, spec


def _k(name, ts, dur, corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def _rt(name, ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 5, "tid": tid, "args": {"correlation": corr}}


def _ann(name, start, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start, "tid": tid, "args": {}}


def _window():
    """Markers end at 100 and start at 3000; kernels at 1000-1200,
    1800-2100 and 2950-2980. Gaps: 100-1000, 1200-1800, 2100-2950,
    2980-3000 (2370 us)."""
    return [_k("spin_kernel", 0, 100), _k("spin_kernel", 3000, 100),
            _rt("cudaGraphLaunch", 760, 1), _k("gemm", 1000, 200, 1),
            _rt("cudaLaunchKernel", 1790, 2),
            _k("elementwise_kernel", 1800, 300, 2),
            _rt("cudaLaunchKernel", 2940, 3), _k("copy", 2950, 30, 3)]


def _engine_trace(with_spans=True):
    ev = _window()
    if with_spans:
        ev += [_ann("llm.step", 150, 2900), _ann("llm.admit", 160, 300),
               # opens with its first child: the child is the innermost
               _ann("llm.decode", 400, 2000),
               _ann("llm.decode.inputs", 400, 700),
               _ann("compiled_step.lookup", 700, 750),
               _ann("compiled_step.replay", 750, 1000),
               _ann("llm.decode.sync", 1000, 1500),
               _ann("llm.decode.post", 1500, 2000),
               # PyTorch's own range: passed over
               _ann("Optimizer.step#AdamW.step", 1600, 1700),
               # another thread's span: not the launching thread's
               _ann("llm.step", 100, 3000, tid=2)]
    return profiler.Trace(ev)


IDLE_US = 900 + 600 + 850 + 20


def test_each_gap_goes_to_the_innermost_span():
    t = _engine_trace()
    assert sum(length for _, length in t.gaps()) == IDLE_US
    by = spans.idle_by_span(t)
    assert by == pytest.approx({
        # 100-150, 2900-2950, 2980-3000: no span
        spans.OUTSIDE: 50 + 50 + 20,
        # 150-160, 300-400, 2100-2900: the step outside its children
        "llm.step": 10 + 100 + 800,
        "llm.admit": 140,
        "llm.decode.inputs": 300,
        "compiled_step.lookup": 50,
        "compiled_step.replay": 250,
        "llm.decode.sync": 300,
        # 1500-1800, PyTorch's range inside it included
        "llm.decode.post": 300})
    # the first gap crosses seven span boundaries and is split by overlap;
    # the groups sum to the trace's idle time
    assert sum(by.values()) == pytest.approx(IDLE_US)


def test_a_gap_in_no_span_goes_outside():
    t = _engine_trace(with_spans=False)
    assert spans.idle_by_span(t) == pytest.approx({spans.OUTSIDE: IDLE_US})


def _train_trace(with_spans=True):
    ev = _window()
    if with_spans:
        ev += [_ann("train.step", 150, 1900), _ann("train.prep", 150, 200),
               _ann("compiled_step.lookup", 200, 250),
               _ann("compiled_step.replay", 250, 760),
               _ann("train.record", 760, 1900),
               _ann("train.step", 2000, 2960),
               _ann("train.record", 2100, 2960)]
    return profiler.Trace(ev)


def test_train_readers_split_the_idle_time_of_a_step():
    t = _train_trace()
    inside = spec.reader("idle_runner_ms.train")({"trace": t})
    outside = spec.reader("idle_outside_ms.train")({"trace": t})
    # under a train.step: 150-1000, 1200-1800, 2100-2950; per step of 2
    assert inside == pytest.approx((850 + 600 + 850) / 1e3 / 2)
    assert outside == pytest.approx((50 + 20) / 1e3 / 2)
    # the two sum to the idle time of a step
    idle_ms = spec.reader("device_idle.train")({"trace": t}) / 100 \
        * t.window_s * 1e3
    assert (inside + outside) * 2 == pytest.approx(idle_ms)
    assert spec.reader("runner_span_ms.train")({"trace": t}) == \
        pytest.approx((1750 + 960) / 2 / 1e3)


@pytest.mark.parametrize("name", [
    "idle_runner_ms.train", "idle_outside_ms.train",
    "runner_span_ms.train"])
def test_a_program_without_the_spans_reads_nothing(name):
    assert spec.reader(name)({"trace": _train_trace(False)}) is None
    assert spec.reader(name)({"trace": None}) is None
