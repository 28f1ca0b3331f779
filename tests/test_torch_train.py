"""ray_tpu_torch training against the JAX package.

The losses (`fused_cross_entropy`, `cross_entropy_loss`,
`chunked_cross_entropy`), the tiny GPT's loss and every parameter
gradient (remat on and off; Flax weights carried across by `convert`),
and three AdamW steps (lr 3e-4, weight decay 1e-4) against optax, all in
f32 at small sizes with inputs from numpy seeds. Gradients are compared at
atol 1e-5 relative to each gradient's max, as tests/test_ops.py holds the
Pallas backward to the dense one. Also the port's own training options:
dropout (identity at p=0, one mask under remat) and f32 master weights
behind the `Dense` cast.
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
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import gpt as tgpt  # noqa: E402
from ray_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from ray_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402

LR, WD = 3e-4, 1e-4


def _rel_close(got, want, atol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _head_inputs(b=2, t=40, d=32, v=256, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((v, d)).astype(np.float32) * 0.3
    y = rng.integers(0, v, (b, t)).astype(np.int32)
    y[0, :5] = -1   # ignored positions
    y[1, -3:] = -1
    return h, w, y


def _torch_grads(fn, *arrays):
    ts = [_t(a).requires_grad_() for a in arrays]
    loss = fn(*ts)
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in ts]


def test_fused_ce_matches_jax():
    h, w, y = _head_inputs()
    want, want_g = jax.value_and_grad(
        lambda a, b: jfused_ce(a, b, jnp.asarray(y)), (0, 1))(
            jnp.asarray(h), jnp.asarray(w))
    got, got_g = _torch_grads(
        lambda a, b: fused_cross_entropy(a, b, _t(y)), h, w)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    for g, wg in zip(got_g, want_g):
        _rel_close(g, wg)


def test_cross_entropy_loss_matches_jax():
    h, w, y = _head_inputs(seed=2)
    logits = h @ w.T
    want, want_g = jax.value_and_grad(jgpt.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(y))
    got, (got_g,) = _torch_grads(
        lambda a: tgpt.cross_entropy_loss(a, _t(y)), logits)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    _rel_close(got_g, want_g)


@pytest.mark.parametrize("t,chunk", [(40, 16), (32, 16)])  # tail / none
def test_chunked_cross_entropy_matches_jax(t, chunk):
    h, w, y = _head_inputs(t=t, seed=3)
    want, want_g = jax.value_and_grad(
        lambda a, b: jgpt.chunked_cross_entropy(a, b, jnp.asarray(y),
                                                chunk_size=chunk),
        (0, 1))(jnp.asarray(h), jnp.asarray(w))
    got, got_g = _torch_grads(
        lambda a, b: tgpt.chunked_cross_entropy(a, b, _t(y),
                                                chunk_size=chunk), h, w)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    for g, wg in zip(got_g, want_g):
        _rel_close(g, wg)
    # the same loss as the full logits through cross_entropy_loss
    full = tgpt.cross_entropy_loss(_t(h) @ _t(w).T, _t(y))
    np.testing.assert_allclose(got, float(full), rtol=1e-6)


# -- the tiny GPT: loss, gradients, AdamW -------------------------------------


@pytest.fixture(scope="module")
def jax_gpt():
    """The Flax tiny GPT in f32 as bench.py wires it (flash attention,
    which falls back to dense off the TPU; fused CE on the tied head),
    its weights, a token batch and its jitted value-and-grad."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    net = jgpt.GPT(jcfg, attention_fn=partial(jflash, causal=True))
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    inputs, targets = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), inputs)

    def loss_fn(p):
        hidden, wte = net.apply(p, inputs, return_hidden=True)
        return jfused_ce(hidden, wte, targets)

    return dict(net=net, variables=variables, toks=toks, loss_fn=loss_fn,
                value_and_grad=jax.jit(jax.value_and_grad(loss_fn)))


def _port_tree(tree, cfg):
    """A Flax param (or gradient) tree as the port's f32 param dict."""
    arrays = jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(tree))
    return convert.gpt_params_from_jax(arrays, cfg, device="cpu",
                                       dtype=torch.float32)


def _port_model(jax_gpt, remat=True, **cfg_kw):
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, remat=remat, **cfg_kw)
    params = _port_tree(jax_gpt["variables"], cfg)
    net = tgpt.GPT.from_params(cfg, params,
                               attention_fn=partial(flash_attention,
                                                    causal=True),
                               trainable=True)
    return cfg, net


def _port_loss(net, toks, **kw):
    t = torch.from_numpy(toks).long()
    hidden, wte = net(t[:, :-1], return_hidden=True, **kw)
    return fused_cross_entropy(hidden, wte, t[:, 1:])


@pytest.mark.parametrize("remat", [True, False])
def test_tiny_gpt_grads_match_jax(jax_gpt, remat):
    want, want_g = jax_gpt["value_and_grad"](jax_gpt["variables"])
    cfg, net = _port_model(jax_gpt, remat=remat)
    loss = _port_loss(net, jax_gpt["toks"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    want_g = _port_tree(want_g, cfg)
    got_g = {n: p.grad for n, p in net.named_parameters()}
    assert got_g.keys() == want_g.keys()
    for n, g in got_g.items():
        assert g is not None and g.dtype == torch.float32, n
        _rel_close(g.numpy(), want_g[n].numpy())


def test_adamw_steps_match_optax(jax_gpt):
    """Three steps of torch.optim.AdamW(lr 3e-4, weight decay 1e-4 — set
    explicitly: torch's default is 1e-2, optax.adamw's 1e-4) against
    optax.adamw(3e-4): the three losses and the final parameters."""
    tx = optax.adamw(LR)
    loss_fn = jax_gpt["loss_fn"]

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    p = jax_gpt["variables"]
    s = tx.init(p)
    want = []
    for _ in range(3):
        p, s, loss = step(p, s)
        want.append(float(loss))

    cfg, net = _port_model(jax_gpt)
    opt = torch.optim.AdamW(net.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WD)
    got = []
    for _ in range(3):
        loss = _port_loss(net, jax_gpt["toks"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
    final = _port_tree(p, cfg)
    for n, x in net.named_parameters():
        # Adam moves each weight by ~lr * g / |g| per step, so where a
        # gradient is near zero the frameworks' ~1e-7 relative gradient
        # differences are amplified (3 of the 32768 wte entries differ by
        # 2.7e-6): atol 1e-5 is 1 % of the three steps' movement
        np.testing.assert_allclose(x.detach().numpy(), final[n].numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)


# -- dropout ------------------------------------------------------------------


def test_dropout_keeps_and_scales():
    x = torch.ones(200_000)
    keep = tgpt.dropout_keep(x.shape, 0.25, torch.Generator().manual_seed(0),
                             "cpu")
    assert abs(float(keep.float().mean()) - 0.75) < 0.005
    y = tgpt.dropout(x, 0.25, keep)
    assert torch.equal(y[keep], torch.full_like(y[keep], 1 / 0.75))
    assert float(y[~keep].abs().max()) == 0.0


def test_dropout_is_identity_at_p0(jax_gpt):
    _, net = _port_model(jax_gpt)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    a = _port_loss(net, jax_gpt["toks"])
    b = _port_loss(net, jax_gpt["toks"], deterministic=False, generator=gen)
    assert float(a.detach()) == float(b.detach())
    assert torch.equal(gen.get_state(), state)  # nothing was drawn


def test_dropout_mask_is_the_same_under_remat(jax_gpt):
    """With dropout on, remat recomputes each block in the backward; its
    mask is drawn before the checkpointed call, so the loss and every
    gradient equal the run without remat on the same generator seed."""
    runs = []
    for remat, seed in ((True, 7), (False, 7), (False, 8)):
        _, net = _port_model(jax_gpt, remat=remat, dropout=0.1)
        loss = _port_loss(net, jax_gpt["toks"], deterministic=False,
                          generator=torch.Generator().manual_seed(seed))
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in
                                   net.named_parameters()}))
    (l_remat, g_remat), (l_plain, g_plain), (l_other, _) = runs
    assert l_remat == pytest.approx(l_plain, rel=1e-6)
    assert l_other != pytest.approx(l_plain, rel=1e-6)  # masks matter
    for n, g in g_remat.items():
        _rel_close(g.numpy(), g_plain[n].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="Generator"):
        _port_loss(net, jax_gpt["toks"], deterministic=False)


# -- master weights -----------------------------------------------------------


def test_master_weights_forward_like_serving_weights():
    """f32 master weights behind the Dense cast give the bf16 model the
    same forward, bit for bit, as the same weights stored in bf16 (the
    serving path, where the cast is a no-op). `from_params` freezes by
    default; `trainable=True` gives a model to train."""
    cfg = tgpt.GPTConfig.tiny()  # bf16 compute, f32 norms
    master = tgpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              dtype=torch.float32)
    norm = ("ln_1.", "ln_2.", "ln_f.")
    serving = {n: p if n.startswith(norm) or any(f".{m}" in n for m in norm)
               else p.to(cfg.dtype) for n, p in master.items()}
    assert serving["h0.attn_qkv.weight"].dtype == torch.bfloat16
    assert serving["h0.ln_1.scale"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)))
    frozen = tgpt.GPT.from_params(cfg, serving)
    trained = tgpt.GPT.from_params(cfg, master, trainable=True)
    assert not frozen.training and not any(
        p.requires_grad for p in frozen.parameters())
    assert trained.training and all(
        p.requires_grad for p in trained.parameters())
    with torch.no_grad():
        assert torch.equal(frozen(toks), trained(toks))
    # gradients reach the f32 master weights through the cast
    hidden, wte = trained(toks, return_hidden=True)
    fused_cross_entropy(hidden, wte, toks).backward()
    assert trained.h0.attn_qkv.weight.grad.dtype == torch.float32
    assert cfg.remat and cfg.dropout == 0.0  # the Flax defaults
