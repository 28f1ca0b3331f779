"""ray_tpu_torch models against the Flax models.

For the `tiny` GPT and Llama configs in f32, with the Flax weights
carried across by `ray_tpu_torch.models.convert`: the forward logits,
`prefill_step`, `decode_step` and `chunk_step` (logits and K/V) must
match the JAX functions at atol 1e-5, on one page arena made with numpy.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import gpt as jgpt  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import gpt as tgpt  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402

ATOL = 1e-5


def _family(name):
    if name == "gpt":
        jmod, tmod = jgpt, tgpt
        jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
        tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
        jnet, tcls = jgpt.GPT(jcfg), tgpt.GPT
        to_port = convert.gpt_params_from_jax
        kvh = tcfg.n_head
    else:
        jmod, tmod = jllama, tllama
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
        tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
        jnet, tcls = jllama.Llama(jcfg), tllama.Llama
        to_port = convert.llama_params_from_jax
        kvh = tcfg.n_kv_head
    # the JAX side runs jitted: one compile beats eager op-by-op dispatch
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                   jnp.ones((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jmod.unboxed_params(variables))
    params = to_port(tree, tcfg, device="cpu")
    return types.SimpleNamespace(
        name=name, jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg, jnet=jnet,
        variables=variables, tree=tree, params=params, kvh=kvh,
        hd=tcfg.d_model // tcfg.n_head,
        tnet=tcls.from_params(tcfg, params),
        tnet_flash=tcls.from_params(tcfg, params,
                                    attention_fn=flash_attention))


@pytest.fixture(scope="module", params=["gpt", "llama"])
def fam(request):
    return _family(request.param)


def _jit(fn):
    return jax.jit(fn, static_argnums=1)  # (variables, cfg, ...)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape,
                                                dtype=np.int32)


def test_forward_logits_match(fam):
    toks = _tokens((2, 16), 1, fam.tcfg.vocab_size)
    apply = jax.jit(fam.jnet.apply, static_argnames="return_hidden")
    want = apply(fam.variables, jnp.asarray(toks))
    got = fam.tnet(torch.from_numpy(toks).long())
    _close(got, want)
    hid, _ = fam.tnet(torch.from_numpy(toks).long(), return_hidden=True)
    want_h, _ = apply(fam.variables, jnp.asarray(toks), return_hidden=True)
    _close(hid, want_h)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_prefill_step_matches(fam, attention):
    toks = _tokens((2, 16), 2, fam.tcfg.vocab_size)
    true_len = np.asarray([16, 9], np.int32)
    want = _jit(fam.jmod.prefill_step)(fam.variables, fam.jcfg,
                                       jnp.asarray(toks),
                                       jnp.asarray(true_len))
    net = fam.tnet if attention == "full" else fam.tnet_flash
    with torch.inference_mode():
        got = fam.tmod.prefill_step(net, fam.tcfg,
                                    torch.from_numpy(toks).long(),
                                    torch.from_numpy(true_len).long())
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def _arena(fam, n_pages=12, block=4, seed=3):
    rng = np.random.default_rng(seed)
    shape = (n_pages, fam.tcfg.n_layer, block, fam.kvh, fam.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    table = rng.permutation(n_pages)[:8].reshape(2, 4).astype(np.int32)
    return k, v, table


def test_decode_step_matches(fam):
    k_pages, v_pages, table = _arena(fam)
    toks = _tokens((2,), 4, fam.tcfg.vocab_size)
    positions = np.asarray([5, 11], np.int32)
    want = _jit(fam.jmod.decode_step)(
        fam.variables, fam.jcfg, jnp.asarray(toks), jnp.asarray(positions),
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(table))
    got = fam.tmod.decode_step(
        fam.tnet, fam.tcfg, torch.from_numpy(toks).long(),
        torch.from_numpy(positions).long(), torch.from_numpy(k_pages),
        torch.from_numpy(v_pages), torch.from_numpy(table).long())
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_chunk_step_matches(fam):
    k_pages, v_pages, table = _arena(fam, seed=5)
    toks = _tokens((2, 4), 6, fam.tcfg.vocab_size)
    start = np.asarray([3, 8], np.int32)
    want = _jit(fam.jmod.chunk_step)(
        fam.variables, fam.jcfg, jnp.asarray(toks), jnp.asarray(start),
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(table))
    got = fam.tmod.chunk_step(
        fam.tnet, fam.tcfg, torch.from_numpy(toks).long(),
        torch.from_numpy(start).long(), torch.from_numpy(k_pages),
        torch.from_numpy(v_pages), torch.from_numpy(table).long())
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_param_count_and_flops_match(fam):
    assert tgpt.count_params(fam.params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(fam.tree))
    assert fam.tmod.flops_per_token(fam.tcfg, 64) == \
        fam.jmod.flops_per_token(fam.jcfg, 64)


def test_init_params_shapes_and_scales(fam):
    """Fresh weights have the Flax tree's shapes (transposed Dense
    kernels) and its init scales; norm params stay f32."""
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(fam.tcfg, dtype=torch.bfloat16)
    fresh = fam.tmod.init_params(cfg, gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in fam.params.items()}
    assert fresh["wte"].dtype == torch.bfloat16
    assert abs(float(fresh["wte"].float().std()) - 0.02) < 1e-3
    norm = "h0.ln_1.scale" if fam.name == "gpt" else "layer0.attn_norm.scale"
    assert fresh[norm].dtype == torch.float32
    assert bool((fresh[norm] == 1).all())
    if fam.name == "gpt":
        assert abs(float(fresh["wpe"].float().std()) - 0.01) < 1e-3
        assert float(fresh["h0.attn_qkv.bias"].abs().max()) == 0.0


def test_full_width_param_count():
    """GPT-2 125M at its published widths (counted on the meta device,
    nothing allocated) has the JAX formula's parameter count."""
    with torch.device("meta"):
        net = tgpt.GPT(tgpt.GPTConfig.gpt2_125m())
    assert tgpt.count_params(net) == 124_475_904


def test_rope_tables_match():
    cos, sin = tllama.rope_tables(64, 16, 10000.0)
    jcos, jsin = jllama.rope_tables(64, 16, 10000.0)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
