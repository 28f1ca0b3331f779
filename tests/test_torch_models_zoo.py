"""The port's other model families against the Flax models, on the CPU.

MoE-GPT, BERT, ViT and ResNet in f32 at tiny widths, the Flax weights
carried across by `ray_tpu_torch.models.convert`, every input from a
numpy seed. For each model: the forward values, every parameter's
gradient, and two AdamW steps (torch `AdamW(lr, weight_decay=1e-4)`
against `optax.adamw(lr)`); ResNet also its `batch_stats` after a train
step and the eval-mode logits.

* MoE-GPT: the chosen experts are compared first, layer by layer (one
  flipped argmax changes a token's whole output); a failure reports the
  smallest top-1/top-2 router probability margin, so it says whether a
  near-tie was the cause. Then logits, the aux loss, gradients.
* BERT: hidden states and `mlm_loss` on the same corrupted tokens (made
  with numpy, as the port's `mask_tokens` draws from a torch.Generator),
  a batch with no masked position (0, not NaN), token types, and the
  bidirectionality check of `tests/test_models.py`.
* ResNet: ResNet-18 with the CIFAR stem at 32x32 (the JAX oracle's
  shape), and ResNet-50's stages (3, 4, 6, 3) at width 8 at 64x64 with
  the 7x7/2 stem and the max-pool (`small_images=False`), whose stride-2
  convolutions and pool pad asymmetrically ("SAME").

Tolerances: forward values atol 1e-5 relative to the largest magnitude
(2e-5 for ResNet-50, 16 blocks of f32 convolutions whose sums XLA and
torch order differently); gradients 1e-5 of each leaf's largest magnitude
(1e-4 for ResNet, where BatchNorm's backward divides by the batch
statistics' standard deviation); batch_stats atol 1e-6; after two AdamW
steps each weight within 1e-5 (Adam moves a weight ~lr a step whatever
its gradient, so this is 1 % of the movement at lr 5e-4).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu.models as jm  # noqa: E402
from ray_tpu.models import bert as jbert  # noqa: E402
from ray_tpu.models import moe_gpt as jmoe  # noqa: E402
from ray_tpu.models.gpt import cross_entropy_loss  # noqa: E402
import ray_tpu_torch.models as tm  # noqa: E402
from ray_tpu_torch.models import bert as tbert  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import moe_gpt as tmoe  # noqa: E402
from ray_tpu_torch.models import resnet as tresnet  # noqa: E402
from ray_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402

LR, WD = 5e-4, 1e-4
# the losses of two AdamW steps (relative): Adam moves a weight by ~lr
# whatever its gradient's size, so where a gradient is near zero the
# packages' ~1e-7 relative differences flip the sign of an update
STEP_RTOL = 2e-5
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-5
PARAM_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(tree))


def _rel_close(got, want, atol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0,
                               err_msg=msg)


def _grads(net):
    return {n: p.grad for n, p in net.named_parameters()}


def _close_trees(got, want, atol, rel=True):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        if got[n] is None:  # a leaf off the path (BERT's wtt without types)
            assert not w.any(), n
            continue
        if rel:
            _rel_close(got[n], w.numpy(), atol, n)
        else:
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       atol=atol, rtol=0, err_msg=n)


def _adamw(net):
    return torch.optim.AdamW(net.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WD)


def _optax_steps(loss_fn, params, steps, has_aux=False, aux0=None):
    """`steps` optax AdamW steps of `loss_fn(params[, aux]) -> loss[, aux]`:
    (losses, params, aux)."""
    tx = optax.adamw(LR)

    @jax.jit
    def step(p, s, a):
        if has_aux:
            (loss, a), g = jax.value_and_grad(loss_fn, has_aux=True)(p, a)
        else:
            loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss, a

    s, losses, aux = tx.init(params), [], aux0
    for _ in range(steps):
        params, s, loss, aux = step(params, s, aux)
        losses.append(float(loss))
    return losses, params, aux


def _torch_steps(net, loss_fn, steps):
    opt, losses = _adamw(net), []
    for _ in range(steps):
        loss = loss_fn()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return losses


# -- MoE-GPT ------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe():
    jcfg = jmoe.MoEGPTConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = tmoe.MoEGPTConfig.tiny(dtype=torch.float32, remat=False)
    net = jmoe.MoEGPT(jcfg)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    variables = jax.jit(net.init)(jax.random.PRNGKey(1),
                                  jnp.asarray(toks[:, :-1]))
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])

    def loss_fn(p):
        logits, aux = net.apply({"params": p}, x, mutable=["moe_aux_loss"])
        return cross_entropy_loss(logits, y) + jmoe.total_aux_loss(aux)

    return dict(jcfg=jcfg, tcfg=tcfg, net=net, toks=toks,
                params=variables["params"], loss_fn=loss_fn,
                tree=_np_tree(variables["params"]))


def _moe_port(moe, **kw):
    params = convert.moe_gpt_params_from_jax(moe["tree"], moe["tcfg"],
                                             device="cpu")
    return tmoe.MoEGPT.from_params(moe["tcfg"], params, **kw)


def _moe_port_loss(net, toks):
    t = torch.from_numpy(toks).long()
    hidden, wte, aux = net(t[:, :-1], return_hidden=True)
    return fused_cross_entropy(hidden, wte, t[:, 1:]) + \
        tmoe.total_aux_loss(aux)


def test_moe_gpt_routes_like_jax_then_logits_and_aux(moe):
    """The experts each layer chooses, then the logits and the summed
    aux loss (test_models.py's `test_moe_gpt_forward_and_aux_loss`)."""
    x = jnp.asarray(moe["toks"][:, :-1])
    logits, state = moe["net"].apply(
        {"params": moe["params"]}, x, mutable=["moe_aux_loss",
                                               "intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "ln_2")
    net = _moe_port(moe)
    seen = {}
    for i, blk in enumerate(net.blocks()):
        blk.ln_2.register_forward_hook(
            lambda m, a, out, i=i: seen.__setitem__(i, out))
    got, aux = net(torch.from_numpy(moe["toks"][:, :-1]).long())
    for i in range(moe["tcfg"].n_layer):
        h = np.asarray(state["intermediates"][f"h{i}"]["ln_2"]["__call__"][0])
        router = moe["tree"][f"h{i}"]["moe"]["router"]
        probs = np.asarray(jax.nn.softmax(
            jnp.asarray(h.reshape(-1, h.shape[-1])) @ router, axis=-1))
        top = np.sort(probs, axis=-1)
        margin = float((top[:, -1] - top[:, -2]).min())
        flat = seen[i].reshape(-1, h.shape[-1])
        _, _, onehot = tmoe.top1(flat, net.blocks()[i].moe.router,
                                 moe["tcfg"].num_experts)
        np.testing.assert_array_equal(
            onehot.argmax(-1).numpy(), probs.argmax(-1),
            err_msg=f"layer {i}: experts differ; smallest top-1/top-2 "
                    f"probability margin {margin:.3e}")
    assert got.shape == (2, 16, moe["tcfg"].vocab_size)
    _rel_close(got, logits, FWD_ATOL)
    want_aux = float(jmoe.total_aux_loss(state))
    np.testing.assert_allclose(float(tmoe.total_aux_loss(aux)), want_aux,
                               rtol=1e-6)
    assert 0 < want_aux < 1.0
    assert net.h0.moe.experts_up.shape[0] == moe["tcfg"].num_experts


def test_moe_gpt_grads_match_jax(moe):
    want, want_g = jax.jit(jax.value_and_grad(moe["loss_fn"]))(moe["params"])
    net = _moe_port(moe, trainable=True)
    loss = _moe_port_loss(net, moe["toks"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    _close_trees(_grads(net), convert.moe_gpt_params_from_jax(
        _np_tree(want_g), moe["tcfg"], device="cpu"), GRAD_ATOL)


def test_moe_gpt_adamw_steps_match_optax(moe):
    want, p, _ = _optax_steps(moe["loss_fn"], moe["params"], 2)
    net = _moe_port(moe, trainable=True)
    got = _torch_steps(net, lambda: _moe_port_loss(net, moe["toks"]), 2)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    _close_trees(dict(net.named_parameters()),
                 convert.moe_gpt_params_from_jax(_np_tree(p), moe["tcfg"],
                                                 device="cpu"),
                 PARAM_ATOL, rel=False)


def test_moe_gpt_capacity_overflow_passes_through():
    """C = max(1, int(1.25 T / E)) over all tokens of the call; a token
    past its expert's capacity gets a zero expert output (only the
    residual), as in the JAX layer."""
    cfg = tmoe.MoEGPTConfig.tiny(dtype=torch.float32)
    assert tmoe.capacity(cfg, 32) == 10
    onehot = torch.tensor([[1, 0]] * 3 + [[0, 1]], dtype=torch.int32)
    dispatch, combine = tmoe.slots(onehot, torch.full((4,), 0.5), 2,
                                   torch.float32)
    assert dispatch.sum(dim=(1, 2)).tolist() == [1.0, 1.0, 0.0, 1.0]
    assert float(combine[1, 0, 1]) == 0.5


# -- BERT ---------------------------------------------------------------------


def _mask_np(tokens, seed, mask_id, vocab, prob=0.15, ignore=-1):
    """BERT's 80/10/10 corruption with numpy (both packages get these)."""
    rng = np.random.default_rng(seed)
    sel = rng.random(tokens.shape) < prob
    kind = rng.random(tokens.shape)
    rand = rng.integers(0, vocab, tokens.shape)
    corrupted = np.where(sel & (kind < 0.8), mask_id,
                         np.where(sel & (kind >= 0.9), rand, tokens))
    return (corrupted.astype(np.int32),
            np.where(sel, tokens, ignore).astype(np.int32))


@pytest.fixture(scope="module")
def bert():
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = tbert.BertConfig.tiny(dtype=torch.float32, remat=False)
    enc = jbert.BertEncoder(jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size - 1, (4, 32)).astype(np.int32)
    types = rng.integers(0, 2, (4, 32)).astype(np.int32)
    corrupted, targets = _mask_np(tokens, 2, jcfg.vocab_size - 1,
                                  jcfg.vocab_size)
    variables = jax.jit(enc.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(corrupted))
    return dict(jcfg=jcfg, tcfg=tcfg, enc=enc, variables=variables,
                tree=_np_tree(variables["params"]), corrupted=corrupted,
                targets=targets, types=types)


def _bert_port(bert, **kw):
    params = convert.bert_params_from_jax(bert["tree"], bert["tcfg"],
                                          device="cpu")
    return tbert.BertEncoder.from_params(bert["tcfg"], params, **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("types", [False, True])
def test_bert_hidden_and_mlm_loss_match_jax(bert, types):
    tt = bert["types"] if types else None
    apply = jax.jit(bert["enc"].apply)
    want_h, want_w = apply(bert["variables"], jnp.asarray(bert["corrupted"]),
                           None if tt is None else jnp.asarray(tt))
    want_loss = jbert.mlm_loss(bert["enc"], bert["variables"],
                               jnp.asarray(bert["corrupted"]),
                               jnp.asarray(bert["targets"]),
                               None if tt is None else jnp.asarray(tt))
    net = _bert_port(bert)
    got_h, got_w = net(_t(bert["corrupted"]),
                       None if tt is None else _t(tt))
    _rel_close(got_h, want_h, FWD_ATOL)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    got_loss = tbert.mlm_loss(net, _t(bert["corrupted"]),
                              _t(bert["targets"]),
                              None if tt is None else _t(tt))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    assert 0 < int((bert["targets"] >= 0).sum()) < bert["targets"].size


def test_bert_mlm_loss_without_masked_positions_is_zero(bert):
    """A batch with no masked position: 0 in both packages, not NaN."""
    none = np.full_like(bert["targets"], -1)
    want = float(jbert.mlm_loss(bert["enc"], bert["variables"],
                                jnp.asarray(bert["corrupted"]),
                                jnp.asarray(none)))
    net = _bert_port(bert, trainable=True)
    got = tbert.mlm_loss(net, _t(bert["corrupted"]), _t(none))
    got.backward()
    assert float(got.detach()) == want == 0.0
    # every parameter on the path (wtt is not: no token types) has a
    # finite, zero gradient
    grads = {n: p.grad for n, p in net.named_parameters() if n != "wtt"}
    assert all(g is not None and not g.any() for g in grads.values())


def test_bert_encoder_is_bidirectional(bert):
    """`test_bert_encoder_is_bidirectional`: a later token changes an
    earlier position's hidden state, in both packages, by the same
    amount."""
    toks = np.random.default_rng(0).integers(
        0, bert["jcfg"].vocab_size, (1, 16)).astype(np.int32)
    toks2 = toks.copy()
    toks2[0, 12] = (toks[0, 12] + 1) % bert["jcfg"].vocab_size
    apply = jax.jit(bert["enc"].apply)
    jd = np.asarray(apply(bert["variables"], jnp.asarray(toks))[0]
                    - apply(bert["variables"], jnp.asarray(toks2))[0])
    net = _bert_port(bert)
    td = (net(_t(toks))[0] - net(_t(toks2))[0]).numpy()
    assert float(np.abs(td[0, 3]).max()) > 0
    np.testing.assert_allclose(td, jd, atol=1e-5)


def test_bert_grads_and_adamw_steps_match_jax(bert):
    enc, x, y = bert["enc"], jnp.asarray(bert["corrupted"]), \
        jnp.asarray(bert["targets"])

    def loss_fn(p):
        return jbert.mlm_loss(enc, {"params": p}, x, y)

    params = bert["variables"]["params"]
    _, want_g = jax.jit(jax.value_and_grad(loss_fn))(params)
    net = _bert_port(bert, trainable=True)
    loss = tbert.mlm_loss(net, _t(bert["corrupted"]), _t(bert["targets"]))
    loss.backward()
    _close_trees(_grads(net), convert.bert_params_from_jax(
        _np_tree(want_g), bert["tcfg"], device="cpu"), GRAD_ATOL)
    want, p, _ = _optax_steps(loss_fn, params, 2)
    net = _bert_port(bert, trainable=True)
    got = _torch_steps(net, lambda: tbert.mlm_loss(
        net, _t(bert["corrupted"]), _t(bert["targets"])), 2)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    _close_trees(dict(net.named_parameters()), convert.bert_params_from_jax(
        _np_tree(p), bert["tcfg"], device="cpu"), PARAM_ATOL, rel=False)


def test_mask_tokens_corrupts_80_10_10():
    tokens = torch.arange(200_000) % 500 + 1
    gen = torch.Generator().manual_seed(0)
    corrupted, targets = tbert.mask_tokens(
        tokens, gen, mask_token_id=0, vocab_size=512)
    sel = targets >= 0
    assert abs(float(sel.float().mean()) - 0.15) < 0.005
    assert torch.equal(targets[sel], tokens[sel])
    masked = float((corrupted[sel] == 0).float().mean())
    kept = float((corrupted[sel] == tokens[sel]).float().mean())
    assert abs(masked - 0.8) < 0.01 and abs(kept - 0.1) < 0.01
    assert torch.equal(corrupted[~sel], tokens[~sel])


# -- ViT ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit():
    jcfg = jm.ViTConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = tm.ViTConfig.tiny(dtype=torch.float32, remat=False)
    model = jm.ViT(jcfg)
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3])
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(imgs))

    def loss_fn(p):
        lg = model.apply({"params": p}, jnp.asarray(imgs))
        onehot = jax.nn.one_hot(labels, jcfg.num_classes)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(lg), -1))

    return dict(jcfg=jcfg, tcfg=tcfg, model=model, imgs=imgs, labels=labels,
                variables=variables, loss_fn=loss_fn,
                tree=_np_tree(variables["params"]))


def _vit_port(vit, **kw):
    params = convert.vit_params_from_jax(vit["tree"], vit["tcfg"],
                                         device="cpu")
    return tm.ViT.from_params(vit["tcfg"], params, **kw)


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits, _t(labels))


def test_vit_logits_grads_and_adamw_match_jax(vit):
    want = jax.jit(vit["model"].apply)(vit["variables"],
                                       jnp.asarray(vit["imgs"]))
    net = _vit_port(vit, trainable=True)
    imgs = torch.from_numpy(vit["imgs"])
    logits = net(imgs)
    assert logits.shape == (4, vit["tcfg"].num_classes)
    assert logits.dtype == torch.float32
    _rel_close(logits, want, FWD_ATOL)
    params = vit["variables"]["params"]
    want_loss, want_g = jax.jit(jax.value_and_grad(vit["loss_fn"]))(params)
    loss = _ce(logits, vit["labels"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    _close_trees(_grads(net), convert.vit_params_from_jax(
        _np_tree(want_g), vit["tcfg"], device="cpu"), GRAD_ATOL)
    want, p, _ = _optax_steps(vit["loss_fn"], params, 2)
    net = _vit_port(vit, trainable=True)
    got = _torch_steps(net, lambda: _ce(net(imgs), vit["labels"]), 2)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    # the key bias's gradient is zero in exact arithmetic (softmax does not
    # see it), so its Adam updates follow the sign of rounding noise: up
    # to lr a step in either package
    _close_trees(dict(net.named_parameters()), convert.vit_params_from_jax(
        _np_tree(p), vit["tcfg"], device="cpu"), 4 * LR, rel=False)


def test_vit_patches_flatten_row_major_after_the_cls_token(vit):
    """Patch (i, j) of the H'xW' grid is token 1 + i W' + j: one patch of
    the image changed changes that token alone before the first block."""
    net = _vit_port(vit)
    seen = []
    net.encoder0.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]))
    imgs = torch.from_numpy(vit["imgs"][:1]).clone()
    net(imgs)
    imgs[0, 8:16, 16:24] += 1.0  # patch (1, 2) of the 4x4 grid
    net(imgs)
    diff = (seen[1] - seen[0]).abs().amax(dim=-1)[0]
    assert diff.nonzero().flatten().tolist() == [1 + 1 * 4 + 2]


# -- ResNet -------------------------------------------------------------------


# (config, image size, tolerances). Through 8 and 16 bottleneck blocks
# this model is ill-conditioned in f32: in train mode BatchNorm normalises
# by the batch's f32 fast variance E[x^2] - E[x]^2, and the JAX model's own
# f32 gradients differ from the same model's with f64 convolutions and
# BatchNorm by up to 0.8 % in norm on a leaf (6 % on one element); the two
# packages' f32 results differ by as much, in eval mode too (no
# normalisation by the batch, so the activations grow through the
# residual stream). So the whole models are held to tolerances of that
# size: `fwd` relative to the largest logit, `grad` per leaf in norm,
# `stats` relative to each statistic's largest magnitude, `steps` the
# losses of two AdamW steps (relative; the first step takes the loss from
# 2.3 to 0.2). The single-block tests below hold one stride-2
# bottleneck and the stem with its max-pool to 1e-5.
RESNETS = {
    # the JAX oracle's config and shape (tests/test_models.py)
    "resnet18_small": (dict(stage_sizes=(2, 2, 2, 2), num_classes=10,
                            small_images=True), 32,
                       dict(fwd=1e-4, grad=5e-2, stats=1e-4, steps=2e-3)),
    # ResNet-50's stages, its 7x7/2 stem and max-pool, at width 8
    "resnet50_stem": (dict(stage_sizes=(3, 4, 6, 3), num_classes=10,
                           width=8, small_images=False), 64,
                      dict(fwd=2e-3, grad=5e-2, stats=2e-3, steps=2e-3)),
}


@pytest.fixture(scope="module", params=sorted(RESNETS))
def resnet(request):
    kw, size, tol = RESNETS[request.param]
    jcfg = jm.ResNetConfig(dtype=jnp.float32, **kw)
    tcfg = tm.ResNetConfig(dtype=torch.float32, **kw)
    model = jm.ResNet(jcfg)
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3])
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(imgs), train=False)

    def loss_fn(params, batch_stats, train=True):
        logits, upd = model.apply(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(imgs), train=train, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(labels, jcfg.num_classes)
        loss = -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))
        return loss, (logits, upd["batch_stats"])

    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, model=model,
                imgs=imgs, labels=labels, variables=variables,
                loss_fn=loss_fn, tol=tol)


def _resnet_port(rn, **kw):
    variables = convert.resnet_variables_from_jax(
        _np_tree(rn["variables"]), rn["tcfg"], device="cpu")
    return tm.ResNet.from_params(rn["tcfg"], variables, **kw)


def _stats(net):
    return {n: b for n, b in net.named_buffers()}


def _resnet_jax_step(rn, train):
    params = rn["variables"]["params"]
    stats = rn["variables"]["batch_stats"]
    fn = jax.jit(jax.value_and_grad(rn["loss_fn"], has_aux=True),
                 static_argnums=2)
    (loss, (logits, new_stats)), grads = fn(params, stats, train)
    return float(loss), logits, new_stats, convert.resnet_variables_from_jax(
        {"params": _np_tree(grads)}, rn["tcfg"], device="cpu")


def _close_norm(got, want, tol):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        w = w.numpy()
        err = np.linalg.norm(got[n].numpy() - w) / np.linalg.norm(w)
        assert err <= tol, (n, err)


def test_resnet_eval_mode_logits_and_grads_match_jax(resnet):
    """BatchNorm on the running statistics: logits and every gradient;
    the statistics stay."""
    tol = resnet["tol"]
    loss, logits, _, want_g = _resnet_jax_step(resnet, train=False)
    net = _resnet_port(resnet, trainable=True)
    got = net(torch.from_numpy(resnet["imgs"]), train=False)
    _rel_close(got, logits, tol["fwd"])
    got_loss = _ce(got, resnet["labels"])
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), loss, rtol=1e-5)
    _close_norm(_grads(net), want_g, tol["grad"])
    assert all(torch.equal(b, torch.zeros_like(b) if n.endswith(".mean")
                           else torch.ones_like(b))
               for n, b in _stats(net).items())


def test_resnet_train_step_matches_jax(resnet):
    """Train mode: logits, loss, every gradient and the batch_stats after
    one step (tolerances above), then eval-mode logits from the updated
    statistics."""
    tol = resnet["tol"]
    loss, logits, jax_stats, want_g = _resnet_jax_step(resnet, train=True)
    net = _resnet_port(resnet, trainable=True)
    imgs = torch.from_numpy(resnet["imgs"])
    got = net(imgs, train=True)
    _rel_close(got, logits, tol["fwd"])
    got_loss = _ce(got, resnet["labels"])
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), loss, rtol=1e-5)
    _close_norm(_grads(net), want_g, tol["grad"])
    want_stats = convert.resnet_variables_from_jax(
        {"params": {}, "batch_stats": _np_tree(jax_stats)}, resnet["tcfg"],
        device="cpu")
    got_stats = _stats(net)
    assert sorted(got_stats) == sorted(want_stats)
    for n, w in want_stats.items():
        _rel_close(got_stats[n], w.numpy(), tol["stats"], n)
        # every statistic moved off its init (mean 0, var 1)
        assert not torch.equal(got_stats[n], torch.zeros_like(w)
                               if n.endswith(".mean") else
                               torch.ones_like(w)), n
    # eval mode reads the updated running statistics
    want_eval = resnet["model"].apply(
        {"params": resnet["variables"]["params"], "batch_stats": jax_stats},
        jnp.asarray(resnet["imgs"]), train=False)
    with torch.no_grad():
        got_eval = net(imgs, train=False)
    _rel_close(got_eval, want_eval, tol["fwd"])


def test_resnet_adamw_steps_match_optax(resnet):
    """Two AdamW steps in train mode, the batch_stats carried along: the
    losses and the parameters after them. Adam moves a weight by ~lr a
    step whatever its gradient's size, so a weight whose gradient is
    within the f32 noise above moves by up to lr a step in either
    package: atol 4 lr. The statistics after the steps follow those
    weights (they differ by up to 6 % on ResNet-50's), so they are only
    checked finite and moved here; the train-step test holds one step's
    statistics."""
    tol = resnet["tol"]

    def loss_fn(p, stats):
        loss, (_, stats) = resnet["loss_fn"](p, stats)
        return loss, stats

    want, p, stats = _optax_steps(
        loss_fn, resnet["variables"]["params"], 2, has_aux=True,
        aux0=resnet["variables"]["batch_stats"])
    net = _resnet_port(resnet, trainable=True)
    imgs = torch.from_numpy(resnet["imgs"])
    got = _torch_steps(net, lambda: _ce(net(imgs, train=True),
                                        resnet["labels"]), 2)
    np.testing.assert_allclose(got, want, rtol=tol["steps"])
    want_p = convert.resnet_variables_from_jax(
        {"params": _np_tree(p), "batch_stats": _np_tree(stats)},
        resnet["tcfg"], device="cpu")
    got_p = dict(net.named_parameters())
    got_s = _stats(net)
    for n, w in want_p.items():
        if n in got_s:
            assert torch.isfinite(got_s[n]).all(), n
            assert not torch.equal(got_s[n], torch.zeros_like(w)
                                   if n.endswith(".mean") else
                                   torch.ones_like(w)), n
        else:
            np.testing.assert_allclose(got_p[n].detach().numpy(), w.numpy(),
                                       atol=4 * LR, rtol=0, err_msg=n)


@pytest.mark.parametrize("case", ["bottleneck_stride2", "stem_pool"])
def test_resnet_stride2_pieces_match_jax(case):
    """One stride-2 bottleneck (its 3x3/2 conv pads (0, 1) at an even
    size, its 1x1/2 projection) on a [4, 16, 16, 16] input, and the
    7x7/2 stem with BatchNorm and the 3x3/2 max-pool (a ResNet without
    stages) at 64x64: outputs, every gradient (the input's too for the
    block) and the batch_stats after a train-mode call, within 1e-5."""
    from ray_tpu.models import resnet as jresnet

    rng = np.random.default_rng(6)
    jcfg = jm.ResNetConfig(dtype=jnp.float32, num_classes=10, width=16,
                           stage_sizes=())
    tcfg = tm.ResNetConfig(dtype=torch.float32, num_classes=10, width=16,
                           stage_sizes=())
    if case == "bottleneck_stride2":
        x = rng.standard_normal((4, 16, 16, 16)).astype(np.float32)
        jmod = jresnet.Bottleneck(jcfg, 8, 2)
        tmod = tresnet.Bottleneck(tcfg, 16, 8, 2)
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    else:
        x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
        jmod, tmod = jm.ResNet(jcfg), tm.ResNet(tcfg)
        tx = torch.from_numpy(x)
    variables = jax.jit(jmod.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    w = np.random.default_rng(7).standard_normal(
        jax.eval_shape(lambda: jmod.apply(variables, jnp.asarray(x),
                                          train=True,
                                          mutable=["batch_stats"])[0]).shape
    ).astype(np.float32)

    def loss_fn(p, xx):
        out, upd = jmod.apply({"params": p,
                               "batch_stats": variables["batch_stats"]},
                              xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                                jnp.asarray(x))
    tmod.load_state_dict(convert.resnet_variables_from_jax(
        _np_tree(variables), tcfg, device="cpu"))
    got = tmod(tx, train=True)
    if got.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    _rel_close(got, want, FWD_ATOL)
    (got * torch.from_numpy(w)).sum().backward()
    _close_trees(_grads(tmod), convert.resnet_variables_from_jax(
        {"params": _np_tree(gp)}, tcfg, device="cpu"), GRAD_ATOL)
    if case == "bottleneck_stride2":
        _rel_close(tx.grad.permute(0, 2, 3, 1), gx, GRAD_ATOL)
    want_s = convert.resnet_variables_from_jax(
        {"params": {}, "batch_stats": _np_tree(stats)}, tcfg, device="cpu")
    _close_trees(_stats(tmod), want_s, 1e-6, rel=False)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (32, 3, 1, (1, 1)), (7, 1, 1, (0, 0)), (7, 3, 2, (1, 1))])
def test_same_padding_is_flax_s(size, kernel, stride, want):
    """Flax "SAME": (floor(p / 2), ceil(p / 2)) of the total padding p,
    against the padding `lax.padtype_to_pads` gives."""
    assert tresnet.same_padding(size, kernel, stride) == want
    assert tuple(jax.lax.padtype_to_pads((size,), (kernel,), (stride,),
                                         "SAME")[0]) == want


def test_full_width_param_counts_match_jax():
    """At published widths (counted on the meta device): ResNet-50,
    ViT-B/16, BERT-base and MoE-GPT have the JAX models' counts."""
    cases = [
        (jm.ResNet(jm.ResNetConfig.resnet50()), (1, 224, 224, 3), tm.ResNet,
         tm.ResNetConfig.resnet50()),
        (jm.ViT(jm.ViTConfig.base_16()), (1, 224, 224, 3), tm.ViT,
         tm.ViTConfig.base_16()),
        (jbert.BertEncoder(jbert.BertConfig.bert_base()), (1, 8),
         tm.BertEncoder, tm.BertConfig.bert_base()),
        (jmoe.MoEGPT(jmoe.MoEGPTConfig()), (1, 8), tm.MoEGPT,
         tm.MoEGPTConfig()),
    ]
    for jnet, shape, tcls, tcfg in cases:
        dtype = jnp.int32 if len(shape) == 2 else jnp.float32
        kw = {"train": False} if tcls is tm.ResNet else {}
        shapes = jax.eval_shape(lambda: jnet.init(
            jax.random.PRNGKey(0), jnp.ones(shape, dtype), **kw))
        want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            fnn.meta.unbox(shapes["params"])))
        with torch.device("meta"):
            net = tcls(tcfg)
        assert sum(p.numel() for p in net.parameters()) == want, tcls


def test_port_models_hold_fresh_weights_of_the_jax_shapes():
    """`init_params`/`init_variables` give the converted tree's names and
    shapes (f32 masters), and the norm and BatchNorm leaves their
    constants."""
    gen = torch.Generator().manual_seed(0)
    cfg = tm.ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8)
    fresh = tresnet.init_variables(cfg, gen, device="cpu",
                                   dtype=torch.float32)
    jnet = jm.ResNet(dataclasses.replace(
        jm.ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8),
        dtype=jnp.float32))
    jv = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)), train=False))
    want = convert.resnet_variables_from_jax(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               fnn.meta.unbox(jv)), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert bool((fresh["stem_bn.var"] == 1).all())
    std = float(fresh["stage1_block0.conv2.weight"].std())
    assert abs(std - (2 / (16 * 9)) ** 0.5) < 0.02


@pytest.mark.parametrize("family", ["bert", "vit"])
def test_dropout_draws_from_the_generator_and_survives_remat(family):
    """`dropout > 0` with `deterministic=False` (BERT's and ViT's blocks,
    after `mlp_down` as in Flax): the output changes, the same generator
    seed gives the same output, and with remat each block's mask is drawn
    before its checkpointed call, so the recompute reuses it (remat on
    and off agree, gradients too). p=0 is the deterministic model."""
    def build(remat, dropout=0.5):
        if family == "bert":
            cfg = tm.BertConfig.tiny(dtype=torch.float32, remat=remat,
                                     dropout=dropout)
            params = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
            net = tm.BertEncoder.from_params(cfg, params, trainable=True)
            x = torch.from_numpy(np.random.default_rng(0).integers(
                0, 512, (2, 16)))
            return net, x, lambda out: out[0]
        cfg = tm.ViTConfig.tiny(dtype=torch.float32, remat=remat,
                                dropout=dropout)
        from ray_tpu_torch.models import vit as tvit
        params = tvit.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        net = tm.ViT.from_params(cfg, params, trainable=True)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 32, 32, 3)).astype(np.float32))
        return net, x, lambda out: out

    outs = {}
    for remat in (False, True):
        net, x, pick = build(remat)
        y = pick(net(x, deterministic=False,
                     generator=torch.Generator().manual_seed(3)))
        y.square().sum().backward()
        outs[remat] = (y.detach(), {n: p.grad for n, p in
                                    net.named_parameters()
                                    if p.grad is not None})
        with torch.no_grad():
            assert not torch.allclose(y, pick(net(x)))
    torch.testing.assert_close(outs[True][0], outs[False][0])
    for n, g in outs[False][1].items():
        torch.testing.assert_close(outs[True][1][n], g, msg=n)
    net0, x, pick = build(False, dropout=0.0)
    with torch.no_grad():
        torch.testing.assert_close(
            pick(net0(x, deterministic=False,
                      generator=torch.Generator().manual_seed(3))),
            pick(net0(x)))
