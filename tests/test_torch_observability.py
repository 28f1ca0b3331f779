"""The port engine's observability, held to the JAX engine's.

The JAX engine and the port engine serve the same prompts on the same
weights (the tiny f32 GPT and Llama, `models.convert`), with the same
`EngineConfig` (prefix cache on; speculation off and K=2). Checked:
the `/metrics` text (`_metrics_text`) line for line but for the timing
lines, the `metrics()` keys (`kv_arena_id` included: None on both sides
without a store) and counters, the request recorder's engine
records and their phase split, the timed-out and shut-down records, the
`llm.prefill` / `llm.prefill_chunk` spans, the step profiler's MFU, the
health watchdog's deadman rule and the pump thread's probe. Everything
runs in f32 on the CPU (device="cpu", asked for explicitly).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu._private import health as jhealth  # noqa: E402
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine  # noqa: E402
from ray_tpu.util import metrics as jmetrics  # noqa: E402
from ray_tpu.util import request_recorder as jrr  # noqa: E402
from ray_tpu.util import step_profiler as jsp  # noqa: E402
from ray_tpu.util import tracing as jtracing  # noqa: E402
from ray_tpu_torch._private import health as thealth  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine  # noqa: E402
from ray_tpu_torch.util import metrics as tmetrics  # noqa: E402
from ray_tpu_torch.util import request_recorder as trr  # noqa: E402
from ray_tpu_torch.util import step_profiler as tsp  # noqa: E402
from ray_tpu_torch.util import tracing as ttracing  # noqa: E402

SHARED = [3, 1, 4, 1, 5, 9, 2, 6]  # two full pages at block_size 4
PROMPTS = [SHARED + [5, 3], SHARED + [8, 9, 7], [7], [2, 7, 1, 8, 2, 8]]
NEW = [6, 4, 5, 7]
CONFIG = dict(block_size=4, batch_buckets=(1, 2, 4),
              prefill_buckets=(8, 16), prefix_cache=1)
TIMING_LINES = ("serve_llm_prefill_ms_total ", "serve_llm_decode_ms_total ")


def _weights(model):
    """JAX variables (dense kernels scaled 8x, so the blocks and not the
    tied embedding pick each token) and the port's params from them."""
    from ray_tpu_torch.models import gpt as tgpt, llama as tllama
    if model == "gpt":
        from ray_tpu.models import gpt as jmod
        net = jmod.GPT(jmod.GPTConfig.tiny(dtype=jnp.float32))
    else:
        from ray_tpu.models import llama as jmod
        net = jmod.Llama(jmod.LlamaConfig.tiny(dtype=jnp.float32))
    variables = jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.ones((1, 8), jnp.int32))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 8.0 if any(getattr(p, "key", None) == "kernel"
                                       for p in path) else x, variables)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmod.unboxed_params(variables))
    if model == "gpt":
        params = convert.gpt_params_from_jax(
            tree, tgpt.GPTConfig.tiny(dtype=torch.float32), "cpu")
    else:
        params = convert.llama_params_from_jax(
            tree, tllama.LlamaConfig.tiny(dtype=torch.float32), "cpu")
    return variables, params


@pytest.fixture(scope="module", params=["gpt", "llama"])
def weights(request):
    return (request.param,) + _weights(request.param)


def _engines(weights, **cfg):
    model, variables, params = weights
    cfg = {**CONFIG, **cfg}
    return (JaxLLMEngine(model=model, params=variables,
                         engine_config=JaxEngineConfig(**cfg)),
            LLMEngine(model=model, params=params, device="cpu",
                      engine_config=EngineConfig(**cfg)))


def _engine_records(rr):
    return [r for r in rr.ring().recent() if r.role == "engine"]


@pytest.fixture(scope="module", params=[0, 2], ids=["plain", "spec2"])
def served(request, weights):
    """Both engines serve PROMPTS; returns per side (JAX, port) the
    metrics text, metrics(), engine records and requests."""
    out = []
    for eng, rr in zip(_engines(weights, spec_k=request.param),
                       (jrr, trr)):
        rr.clear()
        reqs = [eng.submit(p, n, tenant="none")
                for p, n in zip(PROMPTS, NEW)]
        eng.run_until_idle(timeout=120)
        eng.quiesce()
        out.append(dict(text=eng._metrics_text(), metrics=eng.metrics(),
                        records=_engine_records(rr), reqs=reqs,
                        tokens=[r.result(timeout=30) for r in reqs]))
        assert eng.shutdown() == 0
    assert out[0]["tokens"] == out[1]["tokens"]
    return out


def test_metrics_text_matches_jax(served):
    jax_lines, port_lines = (
        [ln for ln in side["text"].splitlines()
         if not ln.startswith(TIMING_LINES)] for side in served)
    assert port_lines == jax_lines
    assert any(ln.startswith("serve_llm_compiled_step_calls_total")
               for ln in port_lines)


def test_metrics_keys_and_counters_match_jax(served):
    """Same keys (the repairs: `requests_failed` in the counters, the
    per-bucket table named `compiled_step_calls`, `kv_arena_id`) and the
    same values, timings aside."""
    want, got = (side["metrics"] for side in served)
    assert set(got) == set(want)
    assert got["kv_arena_id"] is want["kv_arena_id"] is None
    assert got["requests_failed"] == want["requests_failed"] == 0
    assert got["compiled_step_calls"] == want["compiled_step_calls"]
    for key in set(got) - {"prefill_ms", "decode_ms"}:
        assert got[key] == want[key], key


def test_engine_records_match_jax(served):
    """One engine record per request, agreeing with the JAX engine's in
    tokens and outcome, with the phases tiling the end-to-end time (the
    JAX contract of tests/test_request_recorder.py)."""
    def rows(side):
        return sorted((r.tokens_in, r.tokens_out, r.outcome,
                       r.attrs.get("finish_reason")) for r in side["records"])

    assert rows(served[1]) == rows(served[0])
    assert len(served[1]["records"]) == len(PROMPTS)
    for rec in served[1]["records"]:
        assert rec.ttft_ms is not None and rec.ttft_ms > 0
        assert rec.tpot_ms is not None
        ratio = rec.phase_sum_ms() / rec.total_ms
        assert 0.95 <= ratio <= 1.05, rec.as_dict()


def test_request_stamps_match_jax(served):
    """The recorder stamps of the JAX `Request` exist on the port's and
    are set where the JAX engine sets them."""
    stamps = ("submit_ts", "submit_wall", "finish_ts", "first_consider_ts",
              "admit_ts", "first_token_ts", "last_token_ts")
    for jreq, treq in zip(served[0]["reqs"], served[1]["reqs"]):
        assert hasattr(treq, "ctx") and hasattr(jreq, "ctx")
        for name in stamps:
            assert (getattr(jreq, name) is None) == \
                (getattr(treq, name) is None), name
            assert getattr(treq, name) is not None, name
        order = [getattr(treq, n) for n in
                 ("submit_ts", "first_consider_ts", "admit_ts",
                  "first_token_ts", "last_token_ts", "finish_ts")]
        assert order == sorted(order)
        assert treq.prefill_ms > 0 and jreq.prefill_ms > 0


def _timed_out_and_failed(eng, rr):
    rr.clear()
    shed = eng.submit([1, 2, 3], 2, timeout_s=0.001, tenant="none")
    time.sleep(0.01)
    eng.step()  # sheds the expired request before admitting it
    assert shed.error == "deadline passed before admission"
    waiting = eng.submit([4, 5], 2, tenant="none")
    assert eng.shutdown() == 0
    assert waiting.error == "engine shut down"
    return [(r.outcome, r.attrs.get("finish_reason"), r.tokens_in,
             r.tokens_out) for r in _engine_records(rr)]


def test_timed_out_and_shutdown_records_match_jax(weights):
    """A request shed at its deadline records "timed_out", one failed by
    shutdown() "failed"; shutdown() blanks the `serve_llm` callback."""
    jeng, teng = _engines(weights)
    want = _timed_out_and_failed(jeng, jrr)
    got = _timed_out_and_failed(teng, trr)
    assert got == want == [
        ("timed_out", "deadline passed before admission", 3, 0),
        ("failed", "engine shut down", 2, 0)]
    assert "serve_llm_" not in jmetrics.DEFAULT_REGISTRY.prometheus_text()
    assert "serve_llm_" not in tmetrics.DEFAULT_REGISTRY.prometheus_text()
    assert teng.metrics()["requests_timed_out"] == 1


def _spans(eng, rr, tracing, trace_dir, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE", "1")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(trace_dir))
    tracing._reset_writer()
    try:
        ctx = rr.new_context("chat", job="tenant-a")
        with rr.serving(ctx):
            eng.submit(PROMPTS[0], 2, tenant="none")
        for p in PROMPTS[1:]:
            eng.submit(p, 2, tenant="none")
        eng.run_until_idle(timeout=120)
        assert eng.shutdown() == 0
    finally:
        monkeypatch.delenv("RAY_TPU_TRACE")
        tracing._reset_writer()
    spans = [s for s in tracing.collect(str(trace_dir))
             if s["name"].startswith("llm.prefill")]
    for s in spans:
        if "req_id" in s["attrs"]:
            assert s["attrs"]["req_id"] == ctx["req_id"]
            assert s["attrs"]["flow_id"] == f"req:{ctx['req_id']}"
            s["attrs"]["req_id"] = s["attrs"]["flow_id"] = "ctx"
    return sorted((s["name"], s["kind"], sorted(s["attrs"].items()))
                  for s in spans)


def test_prefill_spans_match_jax(weights, tmp_path, monkeypatch):
    """`llm.prefill` (one-shot bucket) and `llm.prefill_chunk` (the
    prefix-cache hit's suffix) spans, collected from a trace directory,
    carry the JAX engine's attributes; the request context's id rides
    as `req_id` and `flow_id`."""
    jeng, teng = _engines(weights)
    want = _spans(jeng, jrr, jtracing, tmp_path / "jax", monkeypatch)
    got = _spans(teng, trr, ttracing, tmp_path / "port", monkeypatch)
    assert got == want
    names = {name for name, _, _ in got}
    assert names == {"llm.prefill", "llm.prefill_chunk"}
    assert any(("req_id", "ctx") in attrs for _, _, attrs in got)


def test_record_step_matches_jax():
    """The step profiler's record (and its MFU) equals the JAX
    recorder's on the same numbers, with an explicit peak and with one
    set process-wide."""
    kw = dict(tokens=4096, flops=3.1e12, prefill_ms=1.5, decode_ms=7.25,
              running=3)
    for peak in (989e12, None):
        for sp in (jsp, tsp):
            sp.set_peak_flops(459e12 if peak is None else None)
        recs = [sp.record_step(11, 12.5, peak=peak, **kw)
                for sp in (jsp, tsp)]
        want, got = (r.as_dict() for r in recs)
        want.pop("ts"), got.pop("ts")
        assert got == want and got["mfu"] is not None
        assert got["attrs"]["running"] == 3
    for sp in (jsp, tsp):
        sp.set_peak_flops(None)
    assert tsp.peak_flops() is None  # no card here


def test_watchdog_flags_a_stalled_probe_and_its_recovery(tmp_path,
                                                         monkeypatch):
    """The deadman rule, driven synchronously on both packages: a frozen
    beat counter with a backlog is stalled once, an idle one never, and
    the next beat recovers it."""
    monkeypatch.setenv("RAY_TPU_EVENT_DIR", str(tmp_path))
    results = []
    for health in (jhealth, thealth):
        stuck = health.watch_loop("obs_test_stuck", backlog_fn=lambda: 2)
        idle = health.watch_loop("obs_test_idle", backlog_fn=lambda: 0)
        wd = health.Watchdog(source=f"OBS_TEST_{len(results)}",
                             interval_s=1.0, stall_s=1.0)
        try:
            for p in (stuck, idle):
                p.beat()
            def check(now):  # this test's probes only
                return [n for n in wd.check_once(now=now)
                        if n.startswith("obs_test")]

            steps = [check(100.0), check(100.5), check(101.5),
                     check(103.0)]
            stalled = stuck.stalled
            text = health.metrics_text()
            stuck.beat()
            steps.append(check(103.5))
            results.append((steps, stalled, stuck.stalled,
                            stuck.stalls_total, idle.stalls_total,
                            'health_loop_stalled{loop="obs_test_stuck"} 1'
                            in text))
        finally:
            health.unwatch_loop("obs_test_stuck")
            health.unwatch_loop("obs_test_idle")
    assert results[1] == results[0] == (
        [[], [], ["obs_test_stuck"], [], []], True, False, 1, 0, True)
    from ray_tpu_torch.util import events
    labels = [e["label"] for e in events.list_events(
        source="OBS_TEST_1", path=str(tmp_path))]
    assert labels == ["health.stalled", "health.recovered"]


def test_pump_probe_registered_by_start_and_removed_by_stop(weights):
    _, teng = _engines(weights)
    teng.start()
    try:
        name = teng._probe_name()
        assert name.startswith("llm_engine_pump_")
        assert name in [p.name for p in thealth.probes()]
        req = teng.submit([5, 6, 7], 3)
        assert len(req.result(timeout=60)) == 3
        assert teng._pump_probe.count > 0
        assert teng._pump_probe.stalls_total == 0
        assert f'health_loop_beats_total{{loop="{name}"}}' in \
            tmetrics.DEFAULT_REGISTRY.prometheus_text()
    finally:
        teng.stop()
    assert name not in [p.name for p in thealth.probes()]
    assert teng.shutdown() == 0
