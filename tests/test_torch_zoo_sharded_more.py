"""More sharded steps of the model families against the JAX package:
MoE-GPT over tp and sp, dropout in the sharded forwards, ViT and ResNet,
ViT over sp and the decoders' gather path.

The port side runs in a gloo gang of 4 CPU ranks
(`_torch_parallel_ranks.py`, gang "zoo_more"), the JAX side here on 4 of
the 8 virtual CPU devices, each model's init carried across by `convert`;
every model in f32 without remat, every AdamW step `torch.optim.AdamW`
against `optax.adamw(lr)`:

* MoE-GPT tiny at tp=2 ep=2 (the experts' hidden width split over tp, a
  tp all-reduce of their outputs), at dp=2 sp=2 (Ulysses attention;
  each token's slot in its expert's buffer from the global (b, t) order,
  the earlier sp blocks of its row included) and at tp=2 sp=2 (one head
  a tp rank, which sp does not divide: the gather path): two steps' losses
  against the JAX GSPMD steps at the same strategy (rtol 1e-5), and the
  layers' aux loss summed over the data and sp axes against the JAX
  value.
* Dropout (p = 0.1, `deterministic=False`): GPT's sharded forward at tp=2
  sp=2 and BERT's at dp=2 tp=2 equal the unsharded forwards from a
  generator in the same state (f32 atol 1e-5): each rank draws the global
  mask and keeps its block. The blocks make up the unsharded draw bit for
  bit, and its keep rate is within 4 sigma of 1 - p. GPT's sharded
  gradients with remat equal those without (the recompute keeps the
  forward's masks).
* ViT tiny at dp=2 tp=2 (its class head vocab-parallel) and a small ResNet
  (two stages, width 8) at dp=2 fsdp=2 (its kernels' output channels split
  over fsdp, BatchNorm on the global batch's statistics): two steps'
  losses against the JAX GSPMD steps (rtol 1e-5); ResNet's running
  statistics after the first step are the same on every rank and equal
  the JAX batch_stats update (atol 1e-6, as `test_torch_models_zoo.py`
  holds one step's statistics). ViT's forward runs at dp=2 sp=2.
* ViT tiny (17 tokens, which sp = 2 or 4 does not divide: padded to 18
  or 20 rows, the pad keys masked) at dp=2 sp=2, tp=2 sp=2 and sp=4
  (Ulysses), and with 2 heads at sp=4 (the gather): two steps' losses
  against the JAX GSPMD steps at the same axes (rtol 1e-5); at dropout
  0.1 and dp=2 sp=2 two sharded steps against two unsharded ones from a
  generator in the same state (rtol 1e-5).
* The gather path in the decoders, where sp does not divide a rank's
  query heads (the sequence of its heads gathered over sp): the tiny
  GPT (2 heads, as the multichip dry run runs it) at tp=2 sp=2 and a
  2-query-head, 1-kv-head Llama at sp=4: two steps' losses against the
  JAX GSPMD steps (rtol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import _torch_parallel_ranks as ranks  # noqa: E402
import ray_tpu.models as jm  # noqa: E402
from ray_tpu.models.gpt import cross_entropy_loss  # noqa: E402
from ray_tpu.models.moe_gpt import total_aux_loss  # noqa: E402
from ray_tpu.parallel import ShardingStrategy, logical_axis_rules  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _gspmd_steps(axes, loss_fn, params, lr, aux0=None):
    """Two optax AdamW steps of `loss_fn(p, aux) -> (loss, aux)` jitted
    under the strategy `axes` on 4 devices: (losses, the aux after the
    first step)."""
    strategy = ShardingStrategy(**axes)
    mesh = strategy.build_mesh(jax.devices()[:4])
    tx = optax.adamw(lr)

    def step(p, s, a):
        (loss, a), g = jax.value_and_grad(loss_fn, has_aux=True)(p, a)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss, a

    with mesh, nn.logical_axis_rules(logical_axis_rules(strategy)):
        jstep = jax.jit(step)
        p, s, loss1, a1 = jstep(params, tx.init(params), aux0)
        _, _, loss2, _ = jstep(p, s, a1)
    return [float(loss1), float(loss2)], a1


def _class_nll(logits, labels, classes):
    onehot = jax.nn.one_hot(labels, classes)
    return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX side's values, the gang's results): the inits first, then
    the gang starts and the JAX GSPMD steps run while it works."""
    moe_cfg = jm.MoEGPTConfig.tiny(dtype=jnp.float32, remat=False)
    moe = jm.MoEGPT(moe_cfg)
    toks = jnp.asarray(ranks.moe_sp_tokens())
    moe_params = moe.init(jax.random.PRNGKey(0), toks[:, :-1])["params"]
    gpt_toks = jnp.asarray(ranks.gpt_tokens()[:, :-1])
    gpt_tree = _np_tree(jm.GPT(jm.GPTConfig(
        **ranks.GPT_CFG, dtype=jnp.float32, remat=False)).init(
        jax.random.PRNGKey(0), gpt_toks)["params"])
    bert_tree = _np_tree(jm.BertEncoder(jm.BertConfig.tiny(
        dtype=jnp.float32, remat=False)).init(
        jax.random.PRNGKey(0), jnp.asarray(ranks.bert_tokens()))["params"])
    vcfg = jm.ViTConfig.tiny(dtype=jnp.float32, remat=False)
    vit = jm.ViT(vcfg)
    imgs, labels = (jnp.asarray(a) for a in ranks.vit_batch())
    vparams = vit.init(jax.random.PRNGKey(1), imgs)["params"]
    rcfg = jm.ResNetConfig(dtype=jnp.float32, **ranks.RESNET_CFG)
    net = jm.ResNet(rcfg)
    rimgs, rlabels = (jnp.asarray(a) for a in ranks.resnet_batch())
    variables = jax.jit(net.init, static_argnames="train")(
        jax.random.PRNGKey(0), rimgs, train=False)
    vrcfg = jm.ViTConfig(dtype=jnp.float32, remat=False,
                         **ranks.VIT_GATHER_CFG)
    vgather = jm.ViT(vrcfg)
    vgather_params = vgather.init(jax.random.PRNGKey(2), imgs)["params"]
    gather_toks = jnp.asarray(ranks.gpt_tokens())
    ggather = jm.GPT(jm.GPTConfig.tiny(dtype=jnp.float32, remat=False))
    ggather_params = ggather.init(jax.random.PRNGKey(3),
                              gather_toks[:, :-1])["params"]
    llama_toks = jnp.asarray(ranks.llama_tokens())
    lgather = jm.Llama(jm.LlamaConfig(dtype=jnp.float32, remat=False,
                                    **ranks.GATHER_LLAMA_CFG))
    lgather_params = lgather.init(jax.random.PRNGKey(4),
                              llama_toks[:, :-1])["params"]
    wait = ranks.start_gang(
        "zoo_more", 4, tmp_path_factory.mktemp("zoo_more"),
        {"moe_tree": _np_tree(moe_params), "gpt_tree": gpt_tree,
         "bert_tree": bert_tree, "vit_tree": _np_tree(vparams),
         "resnet_vars": _np_tree(variables),
         "vit_gather_tree": _np_tree(vgather_params),
         "gpt_gather_tree": _np_tree(ggather_params),
         "llama_gather_tree": _np_tree(lgather_params)})

    out = {}

    # MoE-GPT: the aux loss at init and the GSPMD steps per strategy
    def moe_loss(p, _):
        logits, aux = moe.apply({"params": p}, toks[:, :-1],
                                mutable=["moe_aux_loss"])
        return (cross_entropy_loss(logits, toks[:, 1:])
                + total_aux_loss(aux)), None

    _, aux = moe.apply({"params": moe_params}, toks[:, :-1],
                       mutable=["moe_aux_loss"])
    out["moe"] = dict(aux=float(total_aux_loss(aux)), losses={
        name: _gspmd_steps(axes, moe_loss, moe_params, ranks.MOE_LR)[0]
        for name, axes in ranks.MOE_STRATEGIES.items()})

    # ViT at dp=2 tp=2
    def vit_loss(p, _):
        return _class_nll(vit.apply({"params": p}, imgs), labels,
                          vcfg.num_classes), None

    out["vit"] = dict(losses=_gspmd_steps(dict(dp=2, tp=2), vit_loss,
                                          vparams, ranks.VIT_LR)[0])

    # ViT over sp (GSPMD pads the 17 tokens), and the gather path's models
    def vgather_loss(p, _):
        return _class_nll(vgather.apply({"params": p}, imgs), labels,
                          vrcfg.num_classes), None

    def lm_loss(model, toks):
        def loss(p, _):
            return cross_entropy_loss(model.apply({"params": p},
                                                  toks[:, :-1]),
                                      toks[:, 1:]), None
        return loss

    out["vit_sp"] = {
        name: _gspmd_steps(axes, vit_loss, vparams, ranks.VIT_LR)[0]
        for name, axes in ranks.VIT_SP_STRATEGIES.items()}
    out["vit_sp"]["gather_sp4"] = _gspmd_steps(
        dict(sp=4), vgather_loss, vgather_params, ranks.VIT_LR)[0]
    out["gather"] = {
        "gpt_tp2_sp2": _gspmd_steps(dict(tp=2, sp=2),
                                    lm_loss(ggather, gather_toks),
                                    ggather_params, ranks.GPT_LR)[0],
        "llama_sp4": _gspmd_steps(dict(sp=4), lm_loss(lgather, llama_toks),
                                  lgather_params, ranks.GPT_LR)[0]}

    # ResNet at dp=2 fsdp=2, its batch_stats carried
    def resnet_loss(p, stats):
        logits, upd = net.apply({"params": p, "batch_stats": stats}, rimgs,
                                train=True, mutable=["batch_stats"])
        return _class_nll(logits, rlabels, rcfg.num_classes), \
            upd["batch_stats"]

    losses, stats = _gspmd_steps(dict(dp=2, fsdp=2), resnet_loss,
                                 variables["params"], ranks.RESNET_LR,
                                 variables["batch_stats"])
    out["resnet"] = dict(losses=losses, stats=_np_tree(stats))
    return out, wait()


@pytest.fixture(scope="module")
def jax_side(both):
    return both[0]


@pytest.fixture(scope="module")
def gang(both):
    return both[1]


# each strategy's mesh and a rank's experts_up [experts, d, 4d]
MOE_LAYOUT = {"tp2_ep2": ({"tp": 2, "ep": 2}, (2, 64, 128)),
              "dp2_sp2": ({"dp": 2, "sp": 2}, (4, 64, 256)),
              "tp2_sp2": ({"tp": 2, "sp": 2}, (4, 64, 128))}


@pytest.mark.parametrize("strategy", sorted(ranks.MOE_STRATEGIES))
def test_moe_gpt_tp_sp_steps_and_aux_match_jax(gang, jax_side, strategy):
    got = gang["sc_moe_tp_sp"][strategy]
    mesh, experts = MOE_LAYOUT[strategy]
    assert got["mesh"] == mesh and got["local_experts"] == experts
    np.testing.assert_allclose(got["aux"], jax_side["moe"]["aux"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"],
                               jax_side["moe"]["losses"][strategy],
                               rtol=1e-5)
    assert got["losses"][1] < got["losses"][0]


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_sharded_dropout_equals_unsharded(gang, model):
    got = gang["sc_dropout_sharded"][model]
    np.testing.assert_allclose(got["hidden"], got["plain"], atol=1e-5,
                               rtol=1e-5)
    if model == "gpt":
        # dropout is on: the deterministic forward differs
        assert np.abs(got["deterministic"] - got["hidden"]).max() > 1e-2
        # remat's recompute of a block reuses its mask
        assert got["remat_err"] <= 1e-6


def test_sharded_dropout_draws_the_global_mask(gang):
    got = gang["sc_dropout_sharded"]["gpt"]
    assert got["mesh"] == {"tp": 2, "sp": 2}
    np.testing.assert_array_equal(got["mask"], got["whole"])
    n, keep = got["whole"].size, 1.0 - ranks.DROPOUT
    sigma = np.sqrt(keep * (1 - keep) / n)
    assert abs(got["whole"].mean() - keep) <= 4 * sigma


def test_vit_dp2_tp2_steps_match_jax(gang, jax_side):
    got = gang["sc_vit_sharded"]
    assert got["mesh"] == {"dp": 2, "tp": 2}
    # 10 classes, 5 a tp rank
    assert got["local_head"] == (5, 64)
    np.testing.assert_allclose(got["losses"], jax_side["vit"]["losses"],
                               rtol=1e-5)
    # sp now runs: 8 images over dp=2, 17 tokens padded to 9 rows a rank
    assert got["sp_hidden"] == ((4, 9, 64), True)


# each case's mesh and rows a rank: 17 tokens padded to 18 (sp=2) or 20
# (sp=4); the 8 images split over dp
VIT_SP_LAYOUT = {"dp2_sp2": ((4, 9, 64), False),
                 "tp2_sp2": ((8, 9, 64), False),
                 "sp4": ((8, 5, 64), False), "gather_sp4": ((8, 5, 64), True)}


@pytest.mark.parametrize("strategy", sorted(VIT_SP_LAYOUT))
def test_vit_sp_steps_match_jax(gang, jax_side, strategy):
    got = gang["sc_vit_sp"][strategy]
    assert (got["local"], got["gather"]) == VIT_SP_LAYOUT[strategy]
    np.testing.assert_allclose(got["losses"],
                               jax_side["vit_sp"][strategy], rtol=1e-5)
    assert got["losses"][1] < got["losses"][0]


def test_vit_sp_dropout_equals_unsharded(gang):
    got = gang["sc_vit_sp"]["dropout"]
    np.testing.assert_allclose(got["sharded"], got["unsharded"], rtol=1e-5)


# the gather path: (mesh, (query heads, kv heads) a rank, this rank's tokens)
GATHER_LAYOUT = {"gpt_tp2_sp2": ({"tp": 2, "sp": 2}, (1, 1), (4, 16)),
               "llama_sp4": ({"sp": 4}, (2, 1), (8, 8))}


@pytest.mark.parametrize("case", sorted(GATHER_LAYOUT))
def test_gather_path_steps_match_jax(gang, jax_side, case):
    got = gang["sc_gather_sharded"][case]
    assert got["gather"]
    assert (got["mesh"], got["heads"], got["local_tokens"]) == \
        GATHER_LAYOUT[case]
    np.testing.assert_allclose(got["losses"], jax_side["gather"][case],
                               rtol=1e-5)
    assert got["losses"][1] < got["losses"][0]


def test_resnet_dp2_fsdp2_steps_and_stats_match_jax(gang, jax_side):
    from ray_tpu_torch.models import convert, resnet

    got = gang["sc_resnet_sharded"]
    assert got["mesh"] == {"dp": 2, "fsdp": 2}
    # the stem's 8 output channels, 4 a fsdp rank
    assert got["local_stem"] == (4, 3, 3, 3)
    np.testing.assert_allclose(got["losses"], jax_side["resnet"]["losses"],
                               rtol=1e-5)
    want = convert.resnet_variables_from_jax(
        {"params": {}, "batch_stats": jax_side["resnet"]["stats"]},
        resnet.ResNetConfig(dtype=torch.float32, **ranks.RESNET_CFG),
        device="cpu")
    first = got["stats"][0]
    assert sorted(first) == sorted(want)
    for rank_stats in got["stats"][1:]:
        for name, value in rank_stats.items():
            np.testing.assert_array_equal(value, first[name])
    for name, w in want.items():
        np.testing.assert_allclose(first[name], w.numpy(), atol=1e-6,
                                   err_msg=name)
