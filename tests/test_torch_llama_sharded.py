"""Llama's sharded step against the JAX package's GSPMD step.

The port side runs in a gloo gang of 4 CPU ranks
(`_torch_parallel_ranks.py`, gang "llama"), the JAX side here on 4 of the
8 virtual CPU devices, with the same init carried across by `convert`.
The tiny Llama (4 query heads, 2 kv heads, f32, no remat) takes two AdamW
steps (`torch.optim.AdamW` against `optax.adamw(1e-3)`) at three
strategies, loss by loss at rtol 1e-5:

* fsdp=2 tp=2, the axes of `tests/test_models.py::
  test_llama_sharded_train_step` on 4 devices: the `embed` shards
  gathered at use, the fused qkv and `[gate; up]` gathered and sliced to
  each rank's heads and columns;
* tp=2 sp=2: Ulysses over each tp rank's 2 query heads, its one kv head
  repeated first (sp does not divide it), RoPE at the rank's positions;
* tp=4: one query head a rank, each kv head read by two ranks.

The sharded forward's hidden states, gathered, equal the unsharded
port's at f32 atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import _torch_parallel_ranks as ranks  # noqa: E402
from ray_tpu.models import Llama, LlamaConfig  # noqa: E402
from ray_tpu.models.gpt import cross_entropy_loss  # noqa: E402
from ray_tpu.parallel import ShardingStrategy, logical_axis_rules  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX side: the init's tree and, per strategy, the two GSPMD
    AdamW steps' losses; the gang's results): the gang starts once the
    init is made and works while the JAX steps run."""
    cfg = LlamaConfig.tiny(dtype=jnp.float32, remat=False)
    model = Llama(cfg)
    tokens = jnp.asarray(ranks.llama_tokens())
    params = model.init(jax.random.PRNGKey(0), tokens[:, :-1])
    wait = ranks.start_gang("llama", 4, tmp_path_factory.mktemp("llama"),
                            {"llama_tree": _np_tree(params["params"])})
    tx = optax.adamw(ranks.LLAMA_LR)

    def step(params, opt_state, tokens):
        def loss_fn(p):
            logits = model.apply(p, tokens[:, :-1])
            return cross_entropy_loss(logits, tokens[:, 1:])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = {}
    for name, axes in ranks.LLAMA_STRATEGIES.items():
        strategy = ShardingStrategy(**axes)
        mesh = strategy.build_mesh(jax.devices()[:4])
        with mesh, nn.logical_axis_rules(logical_axis_rules(strategy)):
            jstep = jax.jit(step)
            p1, opt_state, loss1 = jstep(params, tx.init(params), tokens)
            _, _, loss2 = jstep(p1, opt_state, tokens)
        losses[name] = [float(loss1), float(loss2)]
    return dict(losses=losses), wait()


@pytest.fixture(scope="module")
def llama_jax(both):
    return both[0]


@pytest.fixture(scope="module")
def llama_gang(both):
    return both[1]


# (query heads, kv heads) a rank holds at each strategy, and its rows of
# the fused qkv weight [(4 + 2 * 2) * 16, 64] (fsdp splits its columns)
LAYOUT = {"fsdp2_tp2": ((2, 1), (64, 32)), "tp2_sp2": ((2, 1), (64, 64)),
          "tp4": ((1, 1), (32, 64))}


@pytest.mark.parametrize("strategy", sorted(ranks.LLAMA_STRATEGIES))
def test_llama_sharded_steps_match_jax_gspmd(llama_gang, llama_jax,
                                             strategy):
    got = llama_gang["sc_llama_sharded"][strategy]
    axes = ranks.LLAMA_STRATEGIES[strategy]
    assert got["mesh"] == {a: n for a, n in axes.items()}
    assert (got["heads"], got["local_qkv"]) == LAYOUT[strategy]
    np.testing.assert_allclose(got["losses"], llama_jax["losses"][strategy],
                               rtol=1e-5)
    assert got["losses"][1] < got["losses"][0]


@pytest.mark.parametrize("strategy", sorted(ranks.LLAMA_STRATEGIES))
def test_llama_sharded_hidden_matches_unsharded(llama_gang, strategy):
    got = llama_gang["sc_llama_sharded"]
    np.testing.assert_allclose(got[strategy]["hidden"], got["plain"],
                               atol=1e-5, rtol=1e-5)
