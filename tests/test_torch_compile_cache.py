"""ray_tpu_torch.parallel.compile_cache held to the JAX package's.

The port's `compiled_step` keys a CUDA graph per abstract signature on
the card and the eager function on the CPU; on the CPU the same sequence
of calls must give the JAX cache's hits, misses and retraces, raise
`RetraceError` at the same call, expose the same `cache_stats()` keys
and the same metric names. The cases of `tests/test_compile_cache.py`
(hit/miss counters, the retrace guard, dtype and Python-scalar keys, the
global stats) are mirrored here, without `fold_steps` (the train plane's,
not ported yet), plus eviction, which the port adds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ray_tpu.parallel import compile_cache as jcc  # noqa: E402
from ray_tpu.util import step_profiler as jsp  # noqa: E402
from ray_tpu_torch.parallel import compile_cache as tcc  # noqa: E402
from ray_tpu_torch.util import step_profiler as tsp  # noqa: E402

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "i32": (jnp.int32, torch.int32)}


def _arg(spec, side):
    """One argument from its spec, as a jax array (side 0) or a CPU
    tensor (side 1): ("t", n, dtype) is a vector of n ones, ("pair",
    kind, a, b) a tuple or list of two such, anything else a Python
    scalar."""
    if isinstance(spec, tuple) and spec[0] == "t":
        dt = _DTYPES[spec[2]][side]
        return jnp.ones(spec[1], dt) if side == 0 else torch.ones(
            spec[1], dtype=dt)
    if isinstance(spec, tuple) and spec[0] == "pair":
        return spec[1](_arg(x, side) for x in spec[2:])
    return spec


def _scaled(x, s=2):
    return x * s


def _summed(pair):
    return pair[0] + pair[1]


V4, V8 = ("t", 4, "f32"), ("t", 8, "f32")
SEQUENCES = {
    # name: (function, [call args...])
    "shape": (_scaled, [(V4,), (V4,), (V8,), (V4,), (V8,)]),
    "dtype": (_scaled, [(V4,), (("t", 4, "i32"),), (("t", 4, "i32"),)]),
    "scalar": (_scaled, [(V4, 2.0), (V4, 2.0), (V4, 3.0), (V4, 3)]),
    "structure": (_summed, [(("pair", tuple, V4, V4),),
                            (("pair", list, V4, V4),),
                            (("pair", tuple, V4, V4),)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_counters_as_jax_after_every_call(name):
    """The same calls through both caches (each private): as_dict()
    agrees after every call, and so do the values."""
    fn, calls = SEQUENCES[name]
    caches = (jcc.ExecutableCache(), tcc.ExecutableCache())
    steps = (jcc.compiled_step(fn, cache=caches[0]),
             tcc.compiled_step(fn, cache=caches[1]))
    for i, spec in enumerate(calls):
        outs = [step(*(_arg(a, side) for a in spec))
                for side, step in enumerate(steps)]
        np.testing.assert_allclose(np.asarray(outs[0]),
                                   outs[1].numpy(), rtol=1e-6)
        assert caches[0].stats.as_dict() == caches[1].stats.as_dict(), \
            (name, i)
        assert caches[0].size() == caches[1].size(), (name, i)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_retrace_error_at_the_same_call(name):
    fn, calls = SEQUENCES[name]
    raised = []
    for side, cc in enumerate((jcc, tcc)):
        step = cc.compiled_step(fn, cache=cc.ExecutableCache(),
                                on_retrace="error")
        at = None
        for i, spec in enumerate(calls):
            try:
                step(*(_arg(a, side) for a in spec))
            except cc.RetraceError as e:
                assert "new abstract signature" in str(e)
                at = i
                break
        raised.append(at)
    assert raised[0] == raised[1] is not None


def test_hit_miss_counters_and_entries():
    cache = tcc.ExecutableCache()
    step = tcc.compiled_step(_scaled, cache=cache)
    x = torch.zeros(4)
    step(x)
    assert cache.stats.as_dict() == {"hits": 0, "misses": 1,
                                     "retraces": 0}
    assert cache.size() == 1
    for _ in range(3):
        step(x)
    assert cache.stats.hits == 3 and cache.stats.misses == 1
    assert cache.size() == 1  # one entry serves every call


def test_retrace_guard_fires_on_shape_change():
    cache = tcc.ExecutableCache()
    step = tcc.compiled_step(_scaled, cache=cache)
    step(torch.zeros(4))
    assert cache.stats.retraces == 0
    step(torch.zeros(8))  # same function, new signature
    assert cache.stats.retraces == 1 and cache.stats.misses == 2
    # a strict wrapper of the same function raises instead of adding a
    # third entry
    strict = tcc.compiled_step(_scaled, cache=cache, on_retrace="error")
    with pytest.raises(tcc.RetraceError, match="new abstract signature"):
        strict(torch.zeros(16))
    assert cache.size() == 2


def test_python_scalar_is_part_of_the_key():
    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(_scaled, cache=cache)
    a = f(torch.ones(2), 2.0)
    b = f(torch.ones(2), 3.0)
    assert a.tolist() == [2.0, 2.0] and b.tolist() == [3.0, 3.0]
    assert cache.size() == 2


def test_live_argument_is_passed_through_on_the_cpu():
    """On the CPU a live argument reaches the eager function as it is:
    an in-place write lands in the caller's tensor."""
    def write(buf, x):
        buf.add_(x)
        return buf.sum()

    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(write, live_argnums=(0,), cache=cache)
    buf = torch.zeros(3)
    f(buf, torch.ones(3))
    f(buf, torch.ones(3))
    assert buf.tolist() == [2.0, 2.0, 2.0]
    assert cache.stats.as_dict() == {"hits": 1, "misses": 1,
                                     "retraces": 0}


def test_evict_releases_entries_and_signatures():
    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(_scaled, cache=cache, on_retrace="error")
    g = tcc.compiled_step(_summed, cache=cache)
    f(torch.zeros(4))
    g((torch.zeros(2), torch.zeros(2)))
    assert cache.size() == 2
    assert cache.evict(f) == 1  # by wrapper
    assert cache.size() == 1
    # its signatures went too: a new shape is a fresh miss, no retrace
    f(torch.zeros(8))
    assert cache.stats.as_dict() == {"hits": 0, "misses": 3,
                                     "retraces": 0}
    assert cache.evict(_scaled) == 1  # by the function itself
    assert cache.evict(_scaled) == 0
    assert cache.size() == 1


def test_global_cache_stats_have_the_jax_keys():
    assert set(tcc.cache_stats()) == set(jcc.cache_stats()) == {
        "hits", "misses", "retraces", "entries", "lowering_ms"}
    before = tcc.cache_stats()

    @tcc.compiled_step
    def bump(x):
        return x + 1

    bump(torch.zeros(2))
    bump(torch.zeros(2))
    after = tcc.cache_stats()
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] == before["hits"] + 1
    assert after["entries"] == before["entries"] + 1
    assert tcc.global_cache().evict(bump) == 1


def _metric_names(text):
    return sorted({line.split()[0].split("{")[0]
                   for line in text.splitlines()
                   if line and not line.startswith("#")})


def test_metrics_callback_has_the_jax_metric_names():
    from ray_tpu_torch.util import metrics as tmetrics
    names = _metric_names(tcc._metrics_text())
    assert names == _metric_names(jcc._metrics_text())
    # registered on the port's own registry
    scrape = tmetrics.DEFAULT_REGISTRY.prometheus_text()
    assert all(n in scrape for n in names)


def test_dispatch_sampling_matches_jax():
    """Both wrappers count every call into their step profiler and time
    one in RAY_TPU_DISPATCH_SAMPLE of them."""
    before = (jsp.dispatch_stats(), tsp.dispatch_stats())
    assert before[0]["sample_interval"] == before[1]["sample_interval"]
    n = 2 * before[1]["sample_interval"]
    steps = (jcc.compiled_step(_scaled, cache=jcc.ExecutableCache()),
             tcc.compiled_step(_scaled, cache=tcc.ExecutableCache()))
    for _ in range(n):
        steps[0](jnp.ones(2))
        steps[1](torch.ones(2))
    after = (jsp.dispatch_stats(), tsp.dispatch_stats())
    for b, a in zip(before, after):
        assert a["calls"] - b["calls"] == n
        assert a["sampled"] - b["sampled"] == 2
