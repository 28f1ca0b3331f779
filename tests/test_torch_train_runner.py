"""ray_tpu_torch.train.TrainStepRunner, fold_steps and stack_batches held
to the JAX package's.

The tiny GPT (2 layers, d_model 64, f32; Flax weights carried across by
`convert`) trains for 6 steps on batches from a numpy seed through the
JAX `TrainStepRunner` (a `jax.value_and_grad` + `optax.adamw(3e-4)`
step) and through the port's (the torch step: fused CE, backward,
`AdamW(lr 3e-4, weight decay 1e-4)` over a carry of the parameters and
the optimizer state), at K=1 and K=3 steps per call: the same losses
(rtol 1e-6) and final parameters (atol 1e-5), the tolerances of
tests/test_torch_train.py::test_adamw_steps_match_optax, and the same
cache-counter deltas and step-record counts. The port at K=3 equals the
port at K=1 bit for bit (the same operators in the same order). Then
`fold_steps` and `stack_batches` against the JAX ones on the reference
tests' SGD step (tests/test_compile_cache.py), on the CPU, where each
runs eagerly through the compiled-step cache.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import gpt as jgpt  # noqa: E402
from ray_tpu.ops import flash_attention as jflash  # noqa: E402
from ray_tpu.ops import fused_cross_entropy as jfused_ce  # noqa: E402
from ray_tpu.parallel import compile_cache as jcc  # noqa: E402
from ray_tpu.train import TrainStepRunner as JaxRunner  # noqa: E402
from ray_tpu.util import step_profiler as jsp  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import gpt as tgpt  # noqa: E402
from ray_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from ray_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402
from ray_tpu_torch.parallel import compile_cache as tcc  # noqa: E402
from ray_tpu_torch.train import TrainStepRunner  # noqa: E402
from ray_tpu_torch.util import step_profiler as tsp  # noqa: E402

LR, WD = 3e-4, 1e-4
STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_global_cache():
    """The JAX runner compiles into the JAX package's process-wide cache;
    empty it (entries and counters) after this module, so that a later
    test in the same process that reads its absolute counters
    (tests/test_compile_cache.py) does not see this module's entries."""
    yield
    jcc.global_cache().clear()


@pytest.fixture(scope="module")
def jax_gpt():
    """The Flax tiny GPT in f32 as bench.py wires it, its weights and
    STEPS token batches [2, 33] from a numpy seed."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    net = jgpt.GPT(jcfg, attention_fn=partial(jflash, causal=True))
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (STEPS, 2, 33)).astype(np.int32)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(toks[0, :, :-1]))
    return dict(net=net, variables=variables, toks=toks)


def _jax_run(jax_gpt, k):
    """STEPS steps through the JAX runner at K=k: (losses, params,
    counter deltas, new step records)."""
    net, tx = jax_gpt["net"], optax.adamw(LR)

    def step(carry, toks):
        p, s = carry

        def loss_fn(v):
            hidden, wte = net.apply(v, toks[:, :-1], return_hidden=True)
            return jfused_ce(hidden, wte, toks[:, 1:])

        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(g, s, p)
        return (optax.apply_updates(p, updates), s), loss

    runner = JaxRunner(step, steps_per_call=k)
    before, records = runner.cache_stats(), jsp.ring().total_recorded
    # a copy: the runner donates its carry, and the fixture's weights
    # serve every test
    p = jax.tree_util.tree_map(jnp.copy, jax_gpt["variables"])
    carry = (p, tx.init(p))
    batches = iter(jnp.asarray(t) for t in jax_gpt["toks"])
    losses = []
    for _ in range(STEPS // k):
        carry, loss = runner.run(carry, batches)
        losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
    after = runner.cache_stats()
    deltas = {n: after[n] - before[n] for n in after}
    return losses, carry[0], deltas, jsp.ring().total_recorded - records


def _adamw_carry(net, opt):
    """The carry of the port's step: the parameters and AdamW's state,
    created here (as AdamW would at its first step) so that the first
    call's signature is that of every later call."""
    params = dict(net.named_parameters())
    for p in params.values():
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    return {"params": params,
            **{key: {n: opt.state[p][key] for n, p in params.items()}
               for key in ("exp_avg", "exp_avg_sq", "step")}}


def _port_run(jax_gpt, k):
    """The same through the port's runner on the CPU."""
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    arrays = jax.tree_util.tree_map(
        np.asarray, jgpt.unboxed_params(jax_gpt["variables"]))
    params = convert.gpt_params_from_jax(arrays, cfg, device="cpu",
                                         dtype=torch.float32)
    net = tgpt.GPT.from_params(
        cfg, params, attention_fn=partial(flash_attention, causal=True),
        trainable=True)
    opt = torch.optim.AdamW(net.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WD)

    def step(carry, toks):
        hidden, wte = net(toks[:, :-1], return_hidden=True)
        loss = fused_cross_entropy(hidden, wte, toks[:, 1:])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, loss.detach()

    runner = TrainStepRunner(step, steps_per_call=k, device="cpu")
    before, records = runner.cache_stats(), tsp.ring().total_recorded
    carry = _adamw_carry(net, opt)
    batches = iter(torch.from_numpy(t).long() for t in jax_gpt["toks"])
    losses = []
    for _ in range(STEPS // k):
        carry, loss = runner.run(carry, batches)
        losses.extend(loss.reshape(-1).tolist())
    after = runner.cache_stats()
    deltas = {n: after[n] - before[n] for n in after}
    assert carry["params"]["wte"] is net.wte  # the carry is the model's
    return (losses, {n: p.detach().clone() for n, p in
                     carry["params"].items()}, deltas,
            tsp.ring().total_recorded - records, cfg, carry)


@pytest.mark.parametrize("k", [1, 3])
def test_runner_follows_the_jax_runner(jax_gpt, k):
    want_losses, want_p, want_deltas, want_records = _jax_run(jax_gpt, k)
    losses, params, deltas, records, cfg, carry = _port_run(jax_gpt, k)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    assert losses[-1] < losses[0]
    want = convert.gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(want_p)),
        cfg, device="cpu", dtype=torch.float32)
    assert params.keys() == want.keys()
    for n, x in params.items():
        # Adam moves each weight by ~lr per step; where a gradient is
        # near zero the frameworks' ~1e-7 relative gradient differences
        # are amplified: atol 1e-5 is ~0.5 % of six steps' movement
        np.testing.assert_allclose(x.numpy(), want[n].numpy(), atol=1e-5,
                                   rtol=0, err_msg=n)
    # the same cache traffic and one step record per call in both
    assert deltas == want_deltas == {
        "hits": STEPS // k - 1, "misses": 1, "retraces": 0}
    assert records == want_records == STEPS // k
    # AdamW's step counters advanced once per step, the miss included
    assert all(float(s) == STEPS for s in carry["step"].values())


def test_runner_k3_equals_k1_exactly(jax_gpt):
    one, three = _port_run(jax_gpt, 1), _port_run(jax_gpt, 3)
    assert one[0] == three[0]
    for n, x in one[1].items():
        assert torch.equal(x, three[1][n]), n


def test_runner_step_records(jax_gpt):
    """Each run writes one StepStats record with the K-step accounting:
    steps_per_call, tokens and flops per call, the running step number,
    and the MFU from the given peak."""
    tsp.clear()
    calls = []

    def step(carry, batch):
        calls.append(batch.shape)
        return carry + batch.sum(), batch.sum()

    runner = TrainStepRunner(step, steps_per_call=2, tokens_per_step=64,
                             flops_per_step=1e6, peak_flops=1e12,
                             device="cpu")
    carry = torch.zeros(())
    batches = [torch.ones(3) * i for i in range(4)]
    carry, aux = runner.run(carry, iter(batches))
    carry, aux = runner.run(carry, batches[2:])  # a list works too
    assert float(carry) == 3 * (0 + 1 + 2 + 3)
    assert aux.tolist() == [6.0, 9.0]
    # already stacked: used as it is
    carry, aux = runner.run(carry, tcc.stack_batches(batches[:2]))
    assert aux.tolist() == [0.0, 3.0]
    rows = runner.step_stats()
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all(r["steps_per_call"] == 2 and r["tokens"] == 128
               and r["flops"] == 2e6 and r["mfu"] is not None
               for r in rows)
    assert calls == [(3,)] * 6


def test_runner_without_the_recorder_is_the_bare_call():
    tsp.clear()
    tsp.set_enabled(False)
    try:
        runner = TrainStepRunner(lambda c, b: (c + b, b), device="cpu")
        carry, aux = runner.run(torch.zeros(2), torch.ones(2))
        assert carry.tolist() == [1.0, 1.0]
        assert runner.step_stats() == []
    finally:
        tsp.set_enabled(True)
    tsp.clear()


def test_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStepRunner(lambda c, b: (c, b))
    with pytest.raises(ValueError, match="steps_per_call"):
        TrainStepRunner(lambda c, b: (c, b), steps_per_call=0, device="cpu")


# -- fold_steps and stack_batches against the JAX ones --------------------------


def _sgd_step_jax(w, batch):
    x, y = batch

    def loss_fn(w):
        return jnp.mean((x @ w - y) ** 2)
    loss, g = jax.value_and_grad(loss_fn)(w)
    return w - 0.1 * g, loss


def _sgd_step(w, batch):
    """tests/test_compile_cache.py's `_sgd_step` in torch."""
    x, y = batch
    w = w.detach().requires_grad_()
    with torch.enable_grad():
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, w)
    return (w - 0.1 * g).detach(), loss.detach()


def _make_data(seed, n=32, d=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    return x, (x @ rng.randn(d).astype(np.float32)).astype(np.float32)


def test_stack_batches_matches_jax():
    x, y = _make_data(1)
    batches = [(x[i * 8:(i + 1) * 8], {"y": y[i * 8:(i + 1) * 8]})
               for i in range(4)]
    want = jcc.stack_batches(
        [jax.tree_util.tree_map(jnp.asarray, b) for b in batches])
    got = tcc.stack_batches(
        [(torch.from_numpy(b[0]), {"y": torch.from_numpy(b[1]["y"])})
         for b in batches], device="cpu")
    assert type(got) is tuple and set(got[1]) == {"y"}
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1]["y"].numpy(),
                                  np.asarray(want[1]["y"]))
    assert got[0].shape == (4, 8, 4)
    with pytest.raises(ValueError, match="at least one batch"):
        tcc.stack_batches([])


def test_fold_steps_matches_jax_and_k_single_steps():
    """One K=4 call walks the same trajectory as the JAX `fold_steps`
    and as four single steps, and is one cache entry: the next call is
    a hit, with the JAX cache's counters."""
    k = 4
    x, y = _make_data(2)
    batches = [(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
               for i in range(k)]
    caches = (jcc.ExecutableCache(), tcc.ExecutableCache())
    jmulti = jcc.fold_steps(_sgd_step_jax, k, cache=caches[0])
    tmulti = tcc.fold_steps(_sgd_step, k, cache=caches[1], device="cpu")
    assert tmulti.steps_per_call == jmulti.steps_per_call == k
    assert tmulti.__wrapped__.__name__ == "fold_steps(_sgd_stepx4)"
    jw, jl = jmulti(jnp.zeros(4), jcc.stack_batches(
        [tuple(map(jnp.asarray, b)) for b in batches]))
    stacked = tcc.stack_batches(
        [tuple(map(torch.from_numpy, b)) for b in batches])
    tw, tl = tmulti(torch.zeros(4), stacked)
    assert tl.shape == (k,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    # four single steps, the same operators in the same order
    w, single = torch.zeros(4), []
    for b in batches:
        w, loss = _sgd_step(w, tuple(map(torch.from_numpy, b)))
        single.append(float(loss))
    assert tl.tolist() == single and torch.equal(tw, w)
    jmulti(jw, jcc.stack_batches(
        [tuple(map(jnp.asarray, b)) for b in batches]))
    tmulti(tw, stacked)
    assert caches[0].stats.as_dict() == caches[1].stats.as_dict() == {
        "hits": 1, "misses": 1, "retraces": 0}


def test_fold_steps_rejects_zero_steps():
    for cc in (jcc, tcc):
        with pytest.raises(ValueError, match="steps_per_call"):
            cc.fold_steps(_sgd_step, 0)
