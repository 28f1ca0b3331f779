"""The trace reader and the readers of device metrics, on a synthetic
chrome trace (the card's profiler cannot run here)."""

import pytest

from portbench import peaks, profiler, spec


def _k(name, ts, dur, corr=None, grid=(1, 1, 1)):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr, "grid": list(grid)}}


def _rt(name, ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 5, "tid": tid, "args": {"correlation": corr}}


def _events():
    ev = [_k("spin_kernel", 0, 100), _k("spin_kernel", 2000, 100)]
    # a prefill replay (corr 1): two flash kernels and a GEMM
    ev += [_rt("cudaGraphLaunch", 150, 1),
           _k("fwd_sm90<bf16>", 200, 50, 1), _k("nvjet_gemm", 260, 40, 1),
           _k("fwd_sm90<bf16>", 300, 50, 1)]
    # two decode replays of one pattern, one of another (corr 2, 3, 4)
    for corr, t0, grid in ((2, 500, 32), (3, 900, 32), (4, 1300, 8)):
        ev += [_rt("cudaGraphLaunch", t0 - 20, corr),
               _k("gather", t0, 100, corr, (grid, 1, 1)),
               _k("elementwise_kernel", t0 + 100, 100, corr)]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": 1600, "dur": 300, "tid": 1, "args": {}})
    return ev


def test_trace_window_busy_and_replays():
    t = profiler.Trace(_events())
    assert t.complete and t.markers == 2
    assert t.window_us == 1900
    assert t.busy_us == 140 + 200 * 3
    assert len(t.replays) == 4
    assert t.seconds_where(profiler.is_flash_fwd) == pytest.approx(100e-6)
    assert t.class_seconds()["flash attention"] == pytest.approx(100e-6)
    gaps = dict(t.idle_gaps())
    # the gap after the last replay (1500-2000) is what aten::copy_ covered
    # at its middle
    assert gaps["aten::copy_"] == pytest.approx(500e-6)


def test_a_trace_without_an_end_marker_is_incomplete():
    assert not profiler.Trace(_events()[1:]).complete


def test_device_readers():
    t = profiler.Trace(_events())
    shape = spec.family("gpt").shape(
        spec.config_file(spec.HERE / "configs" / "gpt2_124m.json"))
    assert spec.reader("decode_device_ms")({"trace": t}) == \
        pytest.approx(0.2)
    assert spec.reader("device_idle.serve")({"trace": t}) == \
        pytest.approx(100 * (1 - 740 / 1900))
    sent = [{"cached": 0, "stamps": [s], "spec": {"tokens": [0] * n}}
            for s, n in ((0.5, 300), (1.5, 100), (2.5, 700))]
    value = spec.reader("flash_fwd_roofline.serve")(
        {"trace": t, "sent": sent, "trace_t0": 1.0, "shape": shape})
    bound = peaks.attention_bound(1, 100, 12, 12, 64, "bfloat16", True)[0]
    assert value == pytest.approx(100 * 12 * bound / 100e-6)
