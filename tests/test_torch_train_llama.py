"""ray_tpu_torch Llama training, and GPT training past T=2048, against the
JAX package.

The tiny Llama (GQA 4:2, RoPE, RMSNorm, SwiGLU; Flax weights carried
across by `convert`) as `bench.py`'s Llama run wires it: flash attention,
`return_hidden=True` and the fused cross-entropy on the tied head. Its
loss and every parameter gradient against `jax.grad` of the Flax model
(remat on and off), three AdamW steps (lr 3e-4, weight decay 1e-4)
against optax, and the two repairs of the port's Llama: the config takes
`remat` as the Flax one does, and f32 master weights train behind the
`Dense` cast. Last, a tiny GPT at T=2176 (past the 2048 where the Pallas
kernels switch to their chunked forms) against `jax.grad`, with
`full_attention` on both sides: the chunked Pallas kernels are held to
the port's backward in interpret mode in tests/test_torch_flash_attention.py.

Everything is f32 on the CPU with inputs from numpy seeds. Losses agree
within 1e-6 relative; gradients within 1e-5 of each gradient's max, as
tests/test_torch_train.py holds the tiny GPT (the two frameworks sum in
other orders, a few f32 ulps of the largest entry).
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
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.ops import flash_attention as jflash  # noqa: E402
from ray_tpu.ops import fused_cross_entropy as jfused_ce  # noqa: E402
from ray_tpu.parallel.ring_attention import \
    full_attention as jfull  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import gpt as tgpt  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from ray_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402
from ray_tpu_torch.parallel.ring_attention import full_attention  # noqa: E402

LR, WD = 3e-4, 1e-4
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5  # of each gradient's max


def _rel_close(got, want, atol=GRAD_ATOL, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=atol, rtol=0, err_msg=name)


def _jax_case(net, toks):
    """The Flax net's variables, its fused-CE loss on `toks` and the
    jitted value-and-grad (inputs toks[:, :-1], targets toks[:, 1:])."""
    inputs, targets = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), inputs)

    def loss_fn(p):
        hidden, wte = net.apply(p, inputs, return_hidden=True)
        return jfused_ce(hidden, wte, targets)

    return dict(variables=variables, toks=toks, loss_fn=loss_fn,
                value_and_grad=jax.jit(jax.value_and_grad(loss_fn)))


def _port_loss(net, toks):
    t = torch.from_numpy(toks).long()
    hidden, wte = net(t[:, :-1], return_hidden=True)
    return fused_cross_entropy(hidden, wte, t[:, 1:])


def _check_grads(case, cfg, to_port, net):
    want, want_g = case["value_and_grad"](case["variables"])
    loss = _port_loss(net, case["toks"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    want_g = to_port(want_g, cfg)
    got_g = {n: p.grad for n, p in net.named_parameters()}
    assert got_g.keys() == want_g.keys()
    for n, g in got_g.items():
        assert g is not None and g.dtype == torch.float32, n
        _rel_close(g.numpy(), want_g[n].numpy(), name=n)


# -- the tiny Llama -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_llama():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    net = jllama.Llama(jcfg, attention_fn=partial(jflash, causal=True))
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 41)).astype(np.int32)
    return _jax_case(net, toks)


def _llama_tree(tree, cfg):
    """A Flax Llama param (or gradient) tree as the port's f32 dict."""
    arrays = jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(tree))
    return convert.llama_params_from_jax(arrays, cfg, device="cpu",
                                         dtype=torch.float32)


def _port_llama(case, remat=True):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, remat=remat)
    net = tllama.Llama.from_params(
        cfg, _llama_tree(case["variables"], cfg),
        attention_fn=partial(flash_attention, causal=True), trainable=True)
    return cfg, net


@pytest.mark.parametrize("remat", [True, False])
def test_tiny_llama_grads_match_jax(jax_llama, remat):
    cfg, net = _port_llama(jax_llama, remat=remat)
    _check_grads(jax_llama, cfg, _llama_tree, net)


def test_remat_recomputes_the_blocks(jax_llama):
    """With remat each block's activations are recomputed in the
    backward: the autograd graph keeps no block-internal tensors, only
    the checkpointed inputs (fewer saved tensors than without)."""
    counts = {}
    for remat in (True, False):
        _, net = _port_llama(jax_llama, remat=remat)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x) or x, lambda x: x):
            _port_loss(net, jax_llama["toks"])
        counts[remat] = len(saved)
    assert counts[True] < counts[False] / 2, counts


def test_llama_adamw_steps_match_optax(jax_llama):
    """Three steps of torch.optim.AdamW(lr 3e-4, betas 0.9/0.999, eps
    1e-8, weight decay 1e-4) against optax.adamw(3e-4): the losses and
    the final parameters (atol 1e-5: Adam moves a weight ~lr per step, so
    where a gradient is near zero the frameworks' ~1e-7 relative gradient
    differences show; 1e-5 is 1 % of the three steps' movement)."""
    tx = optax.adamw(LR)
    loss_fn = jax_llama["loss_fn"]

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    p = jax_llama["variables"]
    s = tx.init(p)
    want = []
    for _ in range(3):
        p, s, loss = step(p, s)
        want.append(float(loss))

    cfg, net = _port_llama(jax_llama)
    opt = torch.optim.AdamW(net.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WD)
    got = []
    for _ in range(3):
        loss = _port_loss(net, jax_llama["toks"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    final = _llama_tree(p, cfg)
    for n, x in net.named_parameters():
        np.testing.assert_allclose(x.detach().numpy(), final[n].numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)


# -- the repairs --------------------------------------------------------------


def test_llama_config_takes_remat_as_flax_does():
    """`bench.py`'s own constructor call for the Llama run."""
    cfg = tllama.LlamaConfig.llama_125m(remat=False, max_seq_len=1024)
    jcfg = jllama.LlamaConfig.llama_125m(remat=False, max_seq_len=1024)
    assert not cfg.remat and cfg.max_seq_len == 1024
    assert tllama.LlamaConfig().remat == jllama.LlamaConfig().remat is True
    for field in ("n_layer", "n_head", "n_kv_head", "d_model", "ffn_dim",
                  "vocab_size"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_llama_master_weights_train_behind_the_cast():
    """f32 master weights (bf16 compute) run forward and backward; the
    forward equals, bit for bit, the same weights stored in bf16 (the
    serving path, where the Dense cast is a no-op), and the gradients
    reach the f32 weights."""
    cfg = tllama.LlamaConfig.tiny()  # bf16 compute, f32 norms
    master = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu", dtype=torch.float32)
    serving = {n: p if "norm" in n else p.to(cfg.dtype)
               for n, p in master.items()}
    assert serving["layer0.attn_qkv.weight"].dtype == torch.bfloat16
    assert serving["layer0.attn_norm.scale"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 17)))
    frozen = tllama.Llama.from_params(cfg, serving)
    trained = tllama.Llama.from_params(cfg, master, trainable=True)
    assert trained.wte.dtype == torch.float32
    assert trained.layer0.attn_qkv.bias is None  # bias-free, as in Flax
    with torch.no_grad():
        assert torch.equal(frozen(toks), trained(toks))
    hidden, wte = trained(toks[:, :-1], return_hidden=True)
    assert hidden.dtype == wte.dtype == torch.bfloat16
    loss = fused_cross_entropy(hidden, wte, toks[:, 1:])
    loss.backward()
    assert torch.isfinite(loss)
    for n, p in trained.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n


# -- GPT past T = 2048 --------------------------------------------------------

LONG_T = 2176  # > 2048: the Pallas kernels' chunked regime


@pytest.fixture(scope="module")
def jax_long_gpt():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq_len=LONG_T)
    net = jgpt.GPT(jcfg, attention_fn=partial(jfull, causal=True))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (1, LONG_T + 1)).astype(np.int32)
    return _jax_case(net, toks)


def _gpt_tree(tree, cfg):
    arrays = jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(tree))
    return convert.gpt_params_from_jax(arrays, cfg, device="cpu",
                                       dtype=torch.float32)


def test_gpt_past_2048_grads_match_jax(jax_long_gpt):
    """B=1, T=2176, 2 layers, d_model 64 (a 2176-row `wpe`), remat off as
    in `bench.py`'s long-context run."""
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq_len=LONG_T,
                              remat=False)
    assert cfg.n_layer == 2 and cfg.d_model == 64
    net = tgpt.GPT.from_params(
        cfg, _gpt_tree(jax_long_gpt["variables"], cfg),
        attention_fn=partial(full_attention, causal=True), trainable=True)
    assert net.wpe.shape == (LONG_T, cfg.d_model)
    _check_grads(jax_long_gpt, cfg, _gpt_tree, net)
