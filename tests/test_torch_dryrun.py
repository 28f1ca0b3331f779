"""`ray_tpu_torch.dryrun` against `__graft_entry__.py`'s dry run, on the
CPU.

`dryrun_multichip(n, device="cpu")` runs the port's five steps on n gloo
CPU ranks (one process each) at the JAX dry run's shapes and strategies,
from the JAX package's inits carried across (`weights`); each step holds
itself to a one-rank value (module docstring of `dryrun`). Here, at n = 4
and n = 8 (`__graft_entry__`'s own call: fsdp=2 tp=2 sp=2, one head a tp
rank, the gather path):

* the GPT step's loss at fsdp=2 tp=2 sp=2 against the JAX GSPMD program's
  on the 8 virtual CPU devices of `conftest.py` (rtol 1e-5); at fsdp=2
  tp=2 and the multislice step's against the JAX forward (the tokens are
  all ones, so a row's loss does not depend on the batch);
* the pipeline step's loss (rtol 1e-5) and every stage's gradient (atol
  1e-5, rtol 1e-4) against `ray_tpu.parallel.pipeline.
  pipeline_train_step` on 4 devices;
* the ep step's loss against the JAX MoE-GPT's forward (rtol 1e-5);
* the checkpoint restored bit for bit onto tp=2 x dp=n/2;
* `device="cuda"` raises without a card per rank.

Only the JAX values the asserts need are computed here: the JAX dry run
itself takes ~40 s on this host.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
import ray_tpu.models as jm  # noqa: E402
from ray_tpu.models.gpt import cross_entropy_loss  # noqa: E402
from ray_tpu.models.moe_gpt import total_aux_loss  # noqa: E402
from ray_tpu.parallel import logical_axis_rules  # noqa: E402
from ray_tpu.parallel.mesh import build_mesh  # noqa: E402
from ray_tpu.parallel.pipeline import pipeline_train_step  # noqa: E402
from ray_tpu_torch import dryrun  # noqa: E402

SIZES = (4, 8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _gpt():
    return jm.GPT(jm.GPTConfig.tiny(dtype=jnp.float32, remat=False))


def _moe():
    return jm.MoEGPT(jm.MoEGPTConfig.tiny(dtype=jnp.float32, remat=False))


@pytest.fixture(scope="module")
def trees():
    """The JAX dry run's inits (PRNGKey(0)), as numpy trees."""
    ones = jnp.ones((2, 16), jnp.int32)
    return {"gpt": _np_tree(_gpt().init(jax.random.PRNGKey(0),
                                        ones)["params"]),
            "moe": _np_tree(_moe().init(jax.random.PRNGKey(0),
                                        ones)["params"])}


@pytest.fixture(scope="module")
def runs(trees):
    return {n: dryrun.dryrun_multichip(n, device="cpu", weights=trees)
            for n in SIZES}


def _jax_lm_loss(params, seq):
    """The tiny GPT's loss on all-ones tokens [1, seq + 1] on one device."""
    toks = jnp.ones((1, seq + 1), jnp.int32)
    return float(cross_entropy_loss(
        _gpt().apply({"params": params}, toks[:, :-1]), toks[:, 1:]))


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_multichip_runs_every_step(runs, n):
    got = runs[n]
    strategy = __graft_entry__._pick_strategy(n)
    assert (got["world"], got["device"]) == (n, "cpu")
    gpt = got["gpt"]
    assert gpt["mesh"] == strategy.mesh_axes(n)
    assert gpt["batch_local"] == (2, 16)
    # fsdp=2 tp=2 sp=2 leaves a tp rank 1 of the 2 heads: the gather
    assert (gpt["heads_per_rank"], gpt["sp_path"]) == \
        (1, "gather" if n == 8 else "local")
    # the CPU runs the kernels' plain versions: nothing is launched
    assert (gpt["fwd_launches"], gpt["bwd_launches"]) == (0, 0)
    assert got["ckpt"] == {"leaves": 28, "mesh": {"dp": n // 2, "tp": 2},
                           "bitwise": True}
    ep = got["ep"]
    assert ep["mesh"] == ({"ep": 4} if n == 4 else {"dp": 2, "ep": 4})
    # 4 experts over ep=4: one a rank
    assert ep["local_experts"] == (1, 64, 256)
    assert (got["pp"]["stages"], got["pp"]["microbatches"]) == (4, 8)
    assert got["multislice"]["mesh"] == {"dcn": 2, "fsdp": n // 2}
    for step in ("gpt", "ep", "multislice"):
        assert np.isfinite(got[step]["loss"])


def test_gpt_step_matches_jax_gspmd(runs, trees):
    """n = 8: the loss before the update of the JAX dry run's step at
    fsdp=2 tp=2 sp=2, GSPMD on 8 devices."""
    strategy = __graft_entry__._pick_strategy(8)
    mesh = strategy.build_mesh(jax.devices()[:8])
    toks = jnp.ones((2 * strategy.dp * strategy.fsdp, 33), jnp.int32)
    model = _gpt()

    def loss_fn(p):
        return cross_entropy_loss(model.apply({"params": p}, toks[:, :-1]),
                                  toks[:, 1:])

    with mesh, nn.logical_axis_rules(logical_axis_rules(strategy)):
        want = float(jax.jit(loss_fn)(trees["gpt"]))
    np.testing.assert_allclose(runs[8]["gpt"]["loss"], want, rtol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_gpt_and_multislice_losses_match_jax(runs, trees, n):
    want = _jax_lm_loss(trees["gpt"], 16)
    np.testing.assert_allclose(runs[n]["multislice"]["loss"], want,
                               rtol=1e-5)
    np.testing.assert_allclose(runs[n]["multislice"]["ref_loss"], want,
                               rtol=1e-5)
    if n == 4:
        np.testing.assert_allclose(runs[n]["gpt"]["loss"], want, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_pipeline():
    ws, x, y = (jnp.asarray(a) for a in dryrun.pipeline_inputs(4))
    mesh = build_mesh({"pp": 4}, devices=jax.devices()[:4])

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"])

    def loss_fn(out, tgt):
        return jnp.mean(jnp.square(out - tgt))

    val, grads = jax.jit(lambda ps: pipeline_train_step(
        stage_fn, loss_fn, ps, x, y, mesh, num_microbatches=8))({"w": ws})
    return float(val), np.asarray(grads["w"])


@pytest.mark.parametrize("n", SIZES)
def test_pp_step_matches_jax_pipeline(runs, jax_pipeline, n):
    got = runs[n]["pp"]
    want_loss, want_grads = jax_pipeline
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    np.testing.assert_allclose(got["grads"], want_grads, atol=1e-5,
                               rtol=1e-4)
    assert float(np.abs(got["grads"]).sum()) > 0


@pytest.mark.parametrize("n", SIZES)
def test_ep_step_matches_jax_forward(runs, trees, n):
    """The ep step's loss (token NLL and router losses) against the JAX
    MoE-GPT's on the same all-ones tokens (2 dp, 17)."""
    toks = jnp.ones((2 * (n // 4), 17), jnp.int32)
    logits, aux = _moe().apply({"params": trees["moe"]}, toks[:, :-1],
                               mutable=["moe_aux_loss"])
    want = float(cross_entropy_loss(logits, toks[:, 1:])
                 + total_aux_loss(aux))
    np.testing.assert_allclose(runs[n]["ep"]["ref_loss"], want, rtol=1e-5)
    np.testing.assert_allclose(runs[n]["ep"]["loss"], want, rtol=1e-5)


def test_cuda_needs_a_card_per_rank(monkeypatch):
    # this host has no card: the entry point refuses CUDA outright
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(1, device="cuda")
    # two visible cards for four ranks: refused before any rank starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards"):
        dryrun.dryrun_multichip(4, device="cuda")
