"""ray_tpu_torch.parallel.compile_cache held to the JAX package's.

The port's `compiled_step` keys a CUDA graph per abstract signature on
the card and the eager function on the CPU; on the CPU the same sequence
of calls must give the JAX cache's hits, misses and retraces, raise
`RetraceError` at the same call, expose the same `cache_stats()` keys
and the same metric names. The cases of `tests/test_compile_cache.py`
(hit/miss counters, the retrace guard, dtype and Python-scalar keys, the
global stats) are mirrored here, plus eviction, which the port adds, and
the JAX signature (`donate_argnums`, `static_argnums` held to `jax.jit`,
`mesh`). `fold_steps` and `stack_batches` are held to the JAX ones in
tests/test_torch_train_runner.py.
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


# -- the JAX signature ----------------------------------------------------------


def _sgd(w, batch):
    """A functional step in both frameworks: (w - 0.1 * grad, loss)."""
    x, y = batch
    if isinstance(w, torch.Tensor):
        w = w.detach().requires_grad_()
        with torch.enable_grad():
            loss = ((x @ w - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, w)
        return (w - 0.1 * g).detach(), loss.detach()
    import jax
    loss, g = jax.value_and_grad(
        lambda v: jnp.mean((x @ v - y) ** 2))(w)
    return w - 0.1 * g, loss


def _data(seed, side):
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 4).astype(np.float32)
    y = x @ rng.randn(4).astype(np.float32)
    if side == 0:
        return jnp.asarray(x), jnp.asarray(y)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_donate_argnums_is_accepted_and_counts_as_jax():
    """`donate_argnums=(0,)`, as the JAX runner passes it: the same
    values and counters as the JAX cache over four carried steps. On the
    CPU donation has no effect: the first carry stays readable."""
    caches = (jcc.ExecutableCache(), tcc.ExecutableCache())
    steps = [cc.compiled_step(_sgd, donate_argnums=(0,), cache=c)
             for cc, c in zip((jcc, tcc), caches)]
    w = [jnp.zeros(4), torch.zeros(4)]
    w0 = w[1]
    for _ in range(4):
        out = [step(w[side], _data(0, side))
               for side, step in enumerate(steps)]
        w = [o[0] for o in out]
        np.testing.assert_allclose(np.asarray(out[0][1]),
                                   out[1][1].numpy(), rtol=1e-5)
        assert caches[0].stats.as_dict() == caches[1].stats.as_dict()
    np.testing.assert_allclose(np.asarray(w[0]), w[1].numpy(), rtol=1e-5)
    assert w0.tolist() == [0.0] * 4


def test_static_argnums_key_by_value_as_jax_jit():
    """A static argument is keyed by its value as a whole (hash and
    equality) and reaches the function as it is: values as
    `jax.jit(static_argnums=...)`; an equal value is a hit, a new one a
    miss and a retrace; a non-hashable one raises ValueError, as in
    `jax.jit`. (The JAX `compiled_step` passes static arguments to its
    compiled executable and raises TypeError on every call.)"""
    import jax

    def scale(x, factors):
        return x * factors[0] + factors[1]

    want = jax.jit(scale, static_argnums=(1,))
    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(scale, static_argnums=(1,), cache=cache)
    x = np.arange(4, dtype=np.float32)
    for factors in ((2.0, 1.0), (2.0, 1.0), (3.0, 0.0)):
        np.testing.assert_allclose(
            f(torch.from_numpy(x), factors).numpy(),
            np.asarray(want(jnp.asarray(x), factors)), rtol=1e-6)
    assert cache.stats.as_dict() == {"hits": 1, "misses": 2,
                                     "retraces": 1}
    assert cache.size() == 2
    with pytest.raises(ValueError, match="non-hashable static"):
        f(torch.from_numpy(x), [2.0, 1.0])
    with pytest.raises(ValueError, match="Non-hashable static"):
        want(jnp.asarray(x), [2.0, 1.0])


def test_static_argnums_keyword_form_and_positions():
    """Static arguments may sit between dynamic ones; the dynamic ones
    keep their positions for `live_argnums`/`donate_argnums`."""
    def f(a, n, b):
        return a * n + b

    cache = tcc.ExecutableCache()
    step = tcc.compiled_step(static_argnums=(1,), donate_argnums=(2,),
                             cache=cache)(f)
    out = step(torch.ones(3), 4, torch.ones(3))
    assert out.tolist() == [5.0, 5.0, 5.0]
    step(torch.ones(3), 4, torch.ones(3))
    assert cache.stats.as_dict() == {"hits": 1, "misses": 1,
                                     "retraces": 0}


def test_mesh_is_not_supported_yet():
    """`mesh=` is accepted now and keyed, as in the JAX cache: its axis
    sizes and ranks (a mesh of the same shape and ranks hits, another one
    misses without a retrace); `fold_steps` takes it too.
    `tests/test_torch_parallel.py` runs it on real meshes of ranks."""
    import types

    import numpy as np

    def mesh(axes, ranks):
        return types.SimpleNamespace(shape=axes, devices=np.asarray(ranks))

    a, a2 = mesh({"dp": 2}, [0, 1]), mesh({"dp": 2}, [0, 1])
    b = mesh({"fsdp": 2}, [0, 1])
    assert tcc._mesh_key(a) == tcc._mesh_key(a2) != tcc._mesh_key(b)
    assert tcc._mesh_key(None) is None
    cache = tcc.ExecutableCache()
    x = torch.ones(3)
    for m in (a, a2, b):
        tcc.compiled_step(_scaled, mesh=m, cache=cache)(x, 2.0)
    assert cache.stats.as_dict() == {"hits": 1, "misses": 2, "retraces": 0}
    multi = tcc.fold_steps(_sgd, 2, mesh=a, cache=cache)
    assert multi.steps_per_call == 2
    tcc.compiled_step(_scaled, mesh=None)  # None is the default


def test_autograd_mode_is_part_of_the_key():
    """A call under inference mode and one with grad enabled never share
    an entry (a graph is captured under its caller's mode); a mode change
    alone is a miss, not a retrace."""
    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(_scaled, cache=cache, on_retrace="error")
    f(torch.ones(2))
    with torch.inference_mode():
        f(torch.ones(2))
        f(torch.ones(2))
    with torch.no_grad():
        f(torch.ones(2))
    assert cache.stats.as_dict() == {"hits": 1, "misses": 3,
                                     "retraces": 0}
    assert cache.size() == 3


def test_a_miss_runs_the_function_once():
    """The first call with a signature runs the function exactly once,
    as the JAX cache's does (an in-place counter advances by one per
    call, also on the miss)."""
    def bump(counter):
        counter.add_(1)
        return counter

    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(bump, donate_argnums=(0,), cache=cache)
    c = torch.zeros(())
    for i in range(1, 4):
        c = f(c)
        assert float(c) == i


def test_generator_arguments_key_by_identity():
    """A `torch.Generator` argument is keyed by identity, not by its
    state: the same generator hits (and the CPU entry draws from it as a
    direct call would, advancing it), another generator is a new
    signature (a miss and a retrace, as a new Python constant is). On the
    card the generator is registered with the graph
    (`test_torch_cuda.py::test_graph_capture_of_dropout_raises`); a CPU
    generator there is refused before the eager run."""
    def draw(x, gen):
        return x + torch.rand(x.shape, generator=gen)

    cache = tcc.ExecutableCache()
    f = tcc.compiled_step(draw, cache=cache)
    x = torch.zeros(4)
    gen, twin = (torch.Generator().manual_seed(3) for _ in range(2))
    got = [f(x, gen) for _ in range(3)]
    want = [draw(x, twin) for _ in range(3)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not torch.equal(got[1], got[2])
    assert cache.stats.as_dict() == {"hits": 2, "misses": 1, "retraces": 0}
    f(x, torch.Generator().manual_seed(3))
    assert cache.stats.as_dict() == {"hits": 2, "misses": 2, "retraces": 1}
    with pytest.raises(ValueError, match="generator on cpu"):
        tcc._generators([x, gen], torch.device("cuda", 0))
