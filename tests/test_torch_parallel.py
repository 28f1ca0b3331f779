"""The port's `parallel/` against the JAX package, on the CPU.

Every case of `tests/test_parallel.py` (meshes, collectives, ring and
Ulysses attention, the pipeline, MoE, multislice), the tiny GPT's
sharded train step at `_pick_strategy(4)` and `_pick_strategy(8)` (the
loss against the JAX sharded step, rtol 2e-4 as `__graft_entry__.py`
holds it to one device; every parameter after one AdamW step against
JAX + optax, atol 1e-5 in f32), `_dryrun_pp`'s stack, `compiled_step`'s
keys by mesh and `convert`'s sharded carry.

The JAX side runs here on the 8 virtual CPU devices of `conftest.py`. The
port side runs in gloo process groups of CPU ranks
(`_torch_parallel_ranks.py`, which imports no JAX): one gang of 4 ranks
for every case but the 8-way GPT step, which has a gang of 8. Both sides
hold global values, which the ranks gather; the port's meshes may be
smaller than the JAX test's (the values do not depend on the mesh).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import _torch_parallel_ranks as ranks  # noqa: E402
from ray_tpu.models import GPT as JaxGPT  # noqa: E402
from ray_tpu.models import GPTConfig as JaxGPTConfig  # noqa: E402
from ray_tpu.models.gpt import cross_entropy_loss  # noqa: E402
from ray_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from ray_tpu.parallel import compile_cache as jax_cc  # noqa: E402
from ray_tpu.parallel import logical_axis_rules as jax_rules  # noqa: E402
from ray_tpu.parallel.moe import apply_moe as jax_apply_moe  # noqa: E402
from ray_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_apply as jax_pipeline_apply,
    pipeline_loss as jax_pipeline_loss,
    pipeline_train_step as jax_pipeline_train_step)
from ray_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention as jax_ring_attention,
    ulysses_attention as jax_ulysses_attention)
from ray_tpu.parallel.sharding import shard_batch as jax_shard_batch  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import gpt as port_gpt  # noqa: E402
from ray_tpu_torch.parallel import (MeshConfig, ShardingStrategy,  # noqa: E402
                                    mesh_shape_for)


def _jax_gpt_cfg():
    return JaxGPTConfig(**ranks.GPT_CFG, dtype=jnp.float32, remat=False)


@pytest.fixture(scope="module")
def gpt_tree():
    """The tiny GPT's Flax params (numpy), from PRNGKey(0)."""
    toks = ranks.gpt_tokens()
    variables = JaxGPT(_jax_gpt_cfg()).init(jax.random.PRNGKey(0),
                                            jnp.asarray(toks[:, :-1]))
    return jax.tree_util.tree_map(np.asarray,
                                  nn.unbox(variables["params"]))


@pytest.fixture(scope="module")
def w4(gpt_tree, tmp_path_factory):
    return ranks.run_gang("w4", 4, tmp_path_factory.mktemp("w4"),
                          {"gpt_tree": gpt_tree})


@pytest.fixture(scope="module")
def w8(gpt_tree, tmp_path_factory):
    return ranks.run_gang("w8", 8, tmp_path_factory.mktemp("w8"),
                          {"gpt_tree": gpt_tree})


# -- meshes and strategies (pure Python, and the gang's meshes) -------------

def test_mesh_config_inference():
    assert MeshConfig({"dp": -1, "tp": 2}).resolved(8) == {"dp": 4, "tp": 2}
    assert mesh_shape_for(8, tp=2, sp=2) == {"dp": 2, "tp": 2, "sp": 2}
    with pytest.raises(ValueError):
        MeshConfig({"dp": 3}).resolved(8)


def test_build_mesh_axes(w4):
    """The port lays ranks out as the JAX CPU mesh lays out devices."""
    got = w4["sc_mesh"]
    jmesh = jax_build_mesh({"dp": 1, "fsdp": 2, "tp": 2},
                           devices=jax.devices()[:4])
    assert got["mesh_shape"] == dict(jmesh.shape)
    assert got["mesh_dim_names"] == jmesh.axis_names
    assert got["mesh_ranks"] == [[[d.id for d in row] for row in plane]
                                 for plane in jmesh.devices]


def test_device_allreduce(w4):
    from ray_tpu.parallel import collectives as jc

    jmesh = jax_build_mesh({"dp": 4}, devices=jax.devices()[:4])
    want = np.asarray(jc.device_allreduce(jmesh, jnp.arange(4.0), axis="dp"))
    np.testing.assert_array_equal(w4["sc_device_allreduce"]["out"], want)
    assert float(want[0]) == 6.0


def test_collectives_values(w4):
    """Each in-program op over a {"dp": 2, "tp": 2} mesh of ranks 0-3
    (rank r holds r): the values `lax.psum`/`pmean`/`all_gather`/
    `psum_scatter`/`all_to_all`/`ppermute`/the JAX broadcast give, and
    all_gather's gradient (its transpose, a reduce-scatter)."""
    got = w4["sc_collectives"]
    assert got["ranks"] == [[0, 1], [2, 3]]
    for r, res in enumerate(got["per_rank"]):
        dp_i, tp_i = divmod(r, 2)
        tp_peers = [2 * dp_i, 2 * dp_i + 1]
        assert res["allreduce"] == 6.0
        assert res["mean"] == np.mean(tp_peers)
        np.testing.assert_array_equal(
            res["gather"], np.repeat(np.array(tp_peers, np.float32), 2)
            .reshape(1, 4).repeat(2, 0))
        # d/dx of sum(gather * arange(4)), summed over the 2 tp ranks
        np.testing.assert_array_equal(
            res["gather_grad"], 2 * np.array([[2 * tp_i, 2 * tp_i + 1]] * 2))
        np.testing.assert_array_equal(
            res["rs"], (2 * np.arange(4.0) + sum(tp_peers))[2 * tp_i:
                                                             2 * tp_i + 2])
        a2a = np.concatenate([np.arange(4.0).reshape(2, 2)[dp_i:dp_i + 1]
                              + 10 * (2 * j + tp_i) for j in range(2)], 1)
        np.testing.assert_array_equal(res["a2a"], a2a)
        assert res["permute"] == tp_peers[(tp_i - 1) % 2]
        assert res["bcast"] == 2 + tp_i
        assert res["index"] == tp_i


def test_strategy_data_axes():
    s = ShardingStrategy(dp=2, fsdp=2, tp=2)
    assert s.data_axes == ("dp", "fsdp")
    assert ShardingStrategy(dp=8).data_axes == ("dp",)


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(w4, causal):
    q, k, v = (jnp.asarray(a) for a in ranks.ring_inputs())
    mesh = jax_build_mesh({"dp": 2, "sp": 4})
    with mesh:
        want = jax_ring_attention(q, k, v, mesh, causal=causal,
                                  head_axis=None)
    np.testing.assert_allclose(w4["sc_ring"][causal], np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_ring_attention_grad_matches_jax(w4):
    """The ring's backward (a second ring carrying dK/dV home) against
    `jax.grad` through the JAX ring (`test_ring_attention_jit_grad`)."""
    q, k, v = (jnp.asarray(a) for a in ranks.ring_grad_inputs())
    mesh = jax_build_mesh({"sp": 8})

    def loss(q, k, v):
        return jax_ring_attention(q, k, v, mesh, causal=True, head_axis=None,
                                  batch_axes=()).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for name, g in zip("qkv", want):
        np.testing.assert_allclose(w4["sc_ring_grad"][name], np.asarray(g),
                                   atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(w4, causal):
    q, k, v = (jnp.asarray(a) for a in ranks.ulysses_inputs())
    mesh = jax_build_mesh({"sp": 4, "dp": 2})
    with mesh:
        want = jax_ulysses_attention(q, k, v, mesh, causal=causal)
    np.testing.assert_allclose(w4["sc_ulysses"][causal], np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("variant", ["ring", "ulysses", "ulysses4"])
def test_sequence_parallel_attention_gqa(w4, variant):
    """GQA through both sequence-parallel paths: ring rotates KV at its
    narrow width; Ulysses expands h_kv=2 (sp=4 does not divide it) and
    splits h_kv=4 narrow."""
    q, k, v, k4, v4 = (jnp.asarray(a) for a in ranks.gqa_inputs())
    mesh = jax_build_mesh({"dp": 2, "sp": 4})
    with mesh:
        if variant == "ring":
            want = jax_ring_attention(q, k, v, mesh, causal=True,
                                      head_axis=None)
        elif variant == "ulysses":
            want = jax_ulysses_attention(q, k, v, mesh, causal=True)
        else:
            want = jax_ulysses_attention(q, k4, v4, mesh, causal=True)
    np.testing.assert_allclose(w4["sc_gqa"][variant], np.asarray(want),
                               atol=2e-5, rtol=1e-4)


# -- pipeline ------------------------------------------------------------------

def _tanh_stage(p, h):
    return jnp.tanh(h @ p["w"])


def _mse(out, tgt):
    return jnp.mean(jnp.square(out - tgt))


def test_pipeline_matches_jax(w4):
    ws, x = ranks.pipeline_seq_inputs()
    mesh = jax_build_mesh({"pp": 4}, devices=jax.devices()[:4])
    want = jax_pipeline_apply(_tanh_stage, {"w": jnp.asarray(ws)},
                              jnp.asarray(x), mesh, num_microbatches=4)
    np.testing.assert_allclose(w4["sc_pipeline"]["seq"], np.asarray(want),
                               atol=1e-5)


def test_pipeline_grad_matches_jax(w4):
    """`test_pipeline_grad`'s sum of outputs, its gradient through the
    port's backward schedule (pp=2, the batch over dp=2) against
    `jax.grad` (pp=2)."""
    ws, x = ranks.pipeline_grad_inputs()
    mesh = jax_build_mesh({"pp": 2}, devices=jax.devices()[:2])

    def loss(params):
        return jax_pipeline_apply(_tanh_stage, params, jnp.asarray(x), mesh,
                                  num_microbatches=2).sum()

    want = jax.grad(loss)({"w": jnp.asarray(ws)})["w"]
    got = w4["sc_pipeline"]["grad"]
    assert float(np.abs(got).sum()) > 0
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", sorted(ranks.FUSED_CASES))
def test_pipeline_fused_loss_and_grads_match_jax(w4, case, remat):
    """The fused-loss train step (`test_pipeline_fused_loss_and_grads_
    match_single_device` and `__graft_entry__._dryrun_pp(4)`'s stack):
    loss rtol 1e-5, per-stage gradients atol 1e-5, against the JAX
    pipeline and the single-device stack."""
    _, s, _, _, n_mb, _ = ranks.FUSED_CASES[case]
    ws, x, y = (jnp.asarray(a) for a in ranks.fused_inputs(case))
    mesh = jax_build_mesh({"pp": s}, devices=jax.devices()[:s])
    want_loss, want = jax.jit(lambda ps: jax_pipeline_train_step(
        _tanh_stage, _mse, ps, x, y, mesh, num_microbatches=n_mb,
        remat=remat))({"w": ws})

    def ref(ps):
        h = x
        for i in range(s):
            h = jnp.tanh(h @ ps["w"][i])
        return jnp.mean(jnp.square(h - y))

    ref_loss, ref_g = jax.value_and_grad(ref)({"w": ws})
    loss, grads = w4["sc_pipeline"][f"fused:{case}:{remat}"]
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(grads, np.asarray(want["w"]), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(grads, np.asarray(ref_g["w"]), atol=1e-5,
                               rtol=1e-4)


def test_pipeline_loss_scalar_only(w4):
    ws, x, y = (jnp.asarray(a) for a in ranks.scalar_loss_inputs())
    mesh = jax_build_mesh({"pp": 2}, devices=jax.devices()[:2])
    want = jax_pipeline_loss(lambda p, h: h @ p["w"], _mse, {"w": ws}, x, y,
                             mesh, num_microbatches=4)
    shape, loss = w4["sc_pipeline"]["scalar"]
    assert shape == ()
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    b24, b416, b44 = w4["sc_pipeline"]["bubble"]
    assert b24 == pytest.approx(1 / 5)
    assert b416 < b44


# -- MoE -------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["ep", "dense"])
def test_moe_dispatch_combines(w4, path):
    """Expert-parallel dispatch over ep=2 (and the dense path without an
    ep axis) against the JAX dense dispatch; ample capacity, no token
    dropped."""
    x, router_w, expert_w = (jnp.asarray(a) for a in ranks.moe_inputs())
    mesh1 = jax_build_mesh({"dp": 8})
    want, want_aux = jax_apply_moe(x, router_w, expert_w,
                                   lambda w, t: t @ w, mesh1,
                                   capacity_factor=8.0)
    y, aux = w4["sc_moe"][path]
    assert y.shape == x.shape
    assert aux > 0
    np.testing.assert_allclose(y, np.asarray(want), atol=1e-4)
    if path == "dense":
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-5)


# -- multislice ------------------------------------------------------------------

def test_hybrid_mesh_multislice(w4):
    """dcn outermost; each ici row a contiguous block of ranks."""
    got = w4["sc_mesh"]
    assert got["hybrid_names"] == ("dcn", "fsdp")
    assert got["hybrid_shape"] == {"dcn": 2, "fsdp": 2}
    assert got["hybrid_ranks"] == [[0, 1], [2, 3]]
    assert got["hybrid_fsdp_group_size"] == 2


def test_multislice_strategy_allreduce(w4):
    got = w4["sc_multislice"]
    assert got["data_axes"] == ("dcn", "fsdp") == got["names"]
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    assert got["sum"] == x.sum()
    np.testing.assert_array_equal(got["local"], x[:2])


def test_multislice_scaling_config_bundles():
    from ray_tpu_torch.air.config import ScalingConfig

    sc = ScalingConfig(num_workers=4, num_slices=2)
    assert sc.workers_per_slice == 2
    assert len(sc.bundles()) == 2      # one slice's gang
    assert len(sc.total_bundles()) == 4
    with pytest.raises(ValueError):
        ScalingConfig(num_workers=3, num_slices=2).workers_per_slice


# -- compiled_step(mesh=) ------------------------------------------------------

def test_compiled_step_keys_by_mesh(w4):
    """A rebuilt mesh of the same shape and ranks hits; another mesh misses
    without a retrace; the counters and `cache_stats()` keys are the JAX
    cache's after the same calls. The JAX cache keys only one-device meshes:
    its `_mesh_key` takes the truth value of the device array, which raises
    for more than one device (ROADMAP Queue 3), so the JAX side runs on
    one-device meshes of other axis names and the port on 4-rank ones."""
    got = w4["sc_compile_cache"]
    cache = jax_cc.ExecutableCache()

    def f(x):
        return x * 2

    x = jnp.ones(3)
    one = jax.devices()[:1]
    mesh_a, mesh_a2, mesh_b = (jax_build_mesh(axes, devices=one) for axes in
                               ({"dp": 1}, {"dp": 1}, {"fsdp": 1}))
    jax_cc.compiled_step(f, mesh=mesh_a, cache=cache)(x)
    jax_cc.compiled_step(f, mesh=mesh_a2, cache=cache)(x)
    assert got["after_same"] == cache.stats.as_dict() == \
        {"hits": 1, "misses": 1, "retraces": 0}
    jax_cc.compiled_step(f, mesh=mesh_b, cache=cache)(x)
    assert got["after_other"] == cache.stats.as_dict()
    assert got["keys"] == sorted(jax_cc.cache_stats())
    assert got["key_a"] != got["key_b"]
    with pytest.raises(ValueError, match="truth value"):
        jax_cc._mesh_key(jax_build_mesh({"dp": 2, "tp": 2},
                                        devices=jax.devices()[:4]))


# -- the tiny GPT's sharded train step -------------------------------------------

def _jax_pick_strategy(n):
    import __graft_entry__

    return __graft_entry__._pick_strategy(n)


def _jax_sharded_step(tree, n):
    """`__graft_entry__._dryrun_impl`'s step on `tree`: the loss before
    the update and the params after one optax AdamW step."""
    strategy = _jax_pick_strategy(n)
    mesh = strategy.build_mesh(jax.devices()[:n])
    model = JaxGPT(_jax_gpt_cfg())
    toks = ranks.gpt_tokens()
    tx = optax.adamw(ranks.GPT_LR, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=1e-4)
    with mesh, nn.logical_axis_rules(jax_rules(strategy)):
        inputs = jax_shard_batch(np.ascontiguousarray(toks[:, :-1]), mesh,
                                 strategy)
        targets = jax_shard_batch(np.ascontiguousarray(toks[:, 1:]), mesh,
                                  strategy)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt_state = tx.init(params)

        @jax.jit
        def train_step(params, opt_state, inputs, targets):
            def loss_fn(p):
                return cross_entropy_loss(
                    model.apply({"params": p}, inputs), targets)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), loss

        new, loss = train_step(params, opt_state, inputs, targets)
    return float(loss), jax.tree_util.tree_map(np.asarray, new)


@pytest.mark.parametrize("n", [4, 8])
def test_gpt_sharded_step_matches_jax(request, gpt_tree, n):
    """The sharded step at `_pick_strategy(n)` (4: fsdp=2 tp=2; 8: fsdp=2
    tp=2 sp=2) through `TrainStepRunner(mesh=)`: the loss within rtol 2e-4
    of the JAX sharded step's, and every parameter after AdamW within
    atol 1e-5 of JAX + optax."""
    got = request.getfixturevalue(f"w{n}")[f"sc_gpt{n}"]
    strategy = _jax_pick_strategy(n)
    assert got["mesh"] == strategy.mesh_axes(n)
    data_ranks = strategy.dp * strategy.fsdp
    assert got["batch_local"] == (4 // data_ranks, 32 // strategy.sp)
    assert got["cache"] == {"hits": 0, "misses": 1, "retraces": 0}
    loss, new = _jax_sharded_step(gpt_tree, n)
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-4)
    want = convert.gpt_params_from_jax(
        new, port_gpt.GPTConfig(**ranks.GPT_CFG, dtype=torch.float32),
        device="cpu", dtype=torch.float32)
    assert sorted(got["params"]) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got["params"][name], w.numpy(), atol=1e-5,
                                   err_msg=name)
    # the shards the ranks held: qkv's rows and the vocab over tp,
    # embed over fsdp
    shapes = got["local_shapes"]
    assert shapes["wte"] == (512 // 2, 64 // 2)
    assert shapes["h0.attn_qkv.weight"] == (192 // 2, 64 // 2)
    assert shapes["h0.attn_out.weight"] == (64 // 2, 64 // 2)
    assert shapes["h0.ln_1.scale"] == (64,)


def test_convert_sharded_carry_round_trip(w4, gpt_tree):
    """The JAX params as DTensors on the fsdp=2 tp=2 mesh, gathered back:
    the JAX layout (a Dense kernel transposed, qkv's rows unpermuted), bit
    for bit."""
    got = w4["sc_convert"]
    want = convert.gpt_params_from_jax(
        gpt_tree, port_gpt.GPTConfig(**ranks.GPT_CFG, dtype=torch.float32),
        device="cpu", dtype=torch.float32)
    for name, w in want.items():
        np.testing.assert_array_equal(got["full"][name], w.numpy())
    np.testing.assert_array_equal(got["full"]["h1.attn_qkv.weight"],
                                  gpt_tree["h1"]["attn_qkv"]["kernel"].T)
    assert got["local_shapes"]["h1.mlp_down.weight"] == (32, 128)
    assert got["placements"]["wte"] == "(Shard(dim=1), Shard(dim=0))"
