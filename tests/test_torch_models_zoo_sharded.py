"""The other model families' sharded steps against the JAX package.

The port side runs in a gloo gang of 4 CPU ranks
(`_torch_parallel_ranks.py`, gang "zoo"), the JAX side here on the 8
virtual CPU devices:

* BERT at dp=2 tp=2 (`bert.sharded_hidden`: each block's own non-causal
  attention on the rank's heads, the vocab-parallel embedding): the
  gathered hidden states equal the unsharded port's and the JAX sharded
  encoder's of `tests/test_models.py::test_bert_shards_like_the_decoders`
  (same tokens, same init), in f32 at atol 1e-5 and in bf16 at that
  test's 5e-2; the sharded MLM loss equals the JAX `mlm_loss` (rtol
  1e-5, f32).
* MoE-GPT at dp=2 x ep=2 (4 ranks, the expert leaves split over ep):
  the two AdamW steps of `test_moe_gpt_expert_sharded_train_step`
  (`ShardingStrategy(dp=2, ep=4)` there), loss by loss (rtol 1e-5). The
  JAX model is GSPMD-global: the capacity and each token's slot count
  the whole batch, so the port routes globally too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import _torch_parallel_ranks as ranks  # noqa: E402
from ray_tpu.models import BertConfig, BertEncoder  # noqa: E402
from ray_tpu.models import bert as jbert  # noqa: E402
from ray_tpu.models import MoEGPT, MoEGPTConfig  # noqa: E402
from ray_tpu.models.gpt import cross_entropy_loss  # noqa: E402
from ray_tpu.models.moe_gpt import total_aux_loss  # noqa: E402
from ray_tpu.parallel import ShardingStrategy, logical_axis_rules  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


@pytest.fixture(scope="module")
def bert_jax():
    """`test_bert_shards_like_the_decoders`: the init (bf16 activations,
    f32 params), the unsharded output and the dp=2 tp=2 output; and the
    same in f32 with the MLM loss."""
    tokens = jnp.asarray(ranks.bert_tokens())
    out = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        enc = BertEncoder(BertConfig.tiny(remat=False, dtype=dtype))
        params = enc.init(jax.random.PRNGKey(0), tokens)
        ref, _ = enc.apply(params, tokens)
        strategy = ShardingStrategy(dp=2, tp=2)
        mesh = strategy.build_mesh(jax.devices()[:4])
        with mesh, nn.logical_axis_rules(logical_axis_rules(strategy)):
            sharded, _ = jax.jit(lambda p, t: enc.apply(p, t))(params,
                                                               tokens)
        out[name] = dict(params=params, ref=np.asarray(ref, np.float32),
                         sharded=np.asarray(sharded, np.float32),
                         loss=float(jbert.mlm_loss(
                             enc, params, tokens,
                             jnp.asarray(ranks.bert_mlm_targets()))))
    return out


@pytest.fixture(scope="module")
def moe_jax():
    """`test_moe_gpt_expert_sharded_train_step`: its init, tokens and
    two losses under ShardingStrategy(dp=2, ep=4)."""
    strategy = ShardingStrategy(dp=2, ep=4)
    cfg = MoEGPTConfig.tiny(dtype=jnp.float32, remat=False)
    model = MoEGPT(cfg)
    mesh = strategy.build_mesh()
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                cfg.vocab_size)
    with mesh, nn.logical_axis_rules(logical_axis_rules(strategy)):
        variables = model.init(jax.random.PRNGKey(0), tokens)
        params = variables["params"]
        tx = optax.adamw(ranks.MOE_LR)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, tokens):
            def loss_fn(p):
                logits, aux_vars = model.apply(
                    {"params": p}, tokens[:, :-1],
                    mutable=["moe_aux_loss"])
                return (cross_entropy_loss(logits, tokens[:, 1:])
                        + total_aux_loss(aux_vars))
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        tree = _np_tree(params)
        p1, opt_state, loss1 = step(params, opt_state, tokens)
        _, _, loss2 = step(p1, opt_state, tokens)
    return dict(tree=tree, tokens=np.asarray(tokens, np.int32),
                losses=[float(loss1), float(loss2)])


@pytest.fixture(scope="module")
def zoo(bert_jax, moe_jax, tmp_path_factory):
    return ranks.run_gang(
        "zoo", 4, tmp_path_factory.mktemp("zoo"),
        {"bert_tree": _np_tree(bert_jax["f32"]["params"]["params"]),
         "moe_tree": moe_jax["tree"], "moe_tokens": moe_jax["tokens"]})


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-5), ("bf16", 5e-2)])
def test_bert_dp2_tp2_matches_unsharded_and_jax(zoo, bert_jax, dtype, atol):
    got = zoo["sc_bert_sharded"][dtype]
    want = bert_jax[dtype]
    assert got["heads"] == 1 and got["local_wte"] == (512 // 2, 64)
    for a, b in ((got["hidden"], got["plain"]), (got["hidden"],
                                                 want["sharded"]),
                 (got["plain"], want["ref"])):
        np.testing.assert_allclose(a, b, atol=atol, rtol=atol)


def test_bert_sharded_mlm_loss_matches_jax(zoo, bert_jax):
    np.testing.assert_allclose(zoo["sc_bert_sharded"]["f32"]["loss"],
                               bert_jax["f32"]["loss"], rtol=1e-5)


def test_moe_gpt_dp2_ep2_steps_match_jax(zoo, moe_jax):
    got = zoo["sc_moe_gpt_sharded"]
    assert got["mesh"] == {"dp": 2, "ep": 2}
    # 4 experts, 2 a rank
    assert got["local_experts"] == (2, 64, 256)
    assert got["placements"] == "(Replicate(), Shard(dim=0))"
    np.testing.assert_allclose(got["losses"], moe_jax["losses"], rtol=1e-5)
    assert got["losses"][1] < got["losses"][0]
